"""The hybrid serving cell's pieces on the CPU: the driver on a tiny cell
(correct, and not correct with each planted fault, ``scan_carry_dropped``
among them), its Mamba weights, the two readers of the Mamba spans on a
hand-made record, and ``flops_hybrid`` against counts by hand."""
import copy
import math

import pytest
import torch

from perfbench import flops_hybrid
from perfbench import harness as hx
from perfbench.drivers import serve_hybrid
from perfbench.run import run_cell

CELL = "jamba2_mini_l8.prefill_32k"
TINY = dict(n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=96, vocab=256,
            n_experts=16, top_k=2, expert_d_ff=96, dtype="float32")
SEED = 2_147_483_647 + 12_345


def tiny_hybrid() -> hx.Cell:
    """The cell at the published layout (8 layers: 7 Mamba, 1 attention, 4
    of 16 experts top-2) with small widths and 4 prompts of 128 tokens."""
    cell = hx.find_cell(CELL)
    cell.config = dict(cell.config, arch=dict(cell.arch, **TINY))
    cell.workload = copy.deepcopy(cell.workload)
    cell.workload["traffic"].update(batch=4, prompt=128, new=4)
    return cell


@pytest.mark.parametrize("fault", [None, "scan_carry_dropped", "token_altered", "half_batch",
                                   "stale_state"])
def test_fault_is_caught(fault, monkeypatch):
    """Scan groups of one chunk, so that the tiny prompts cross four group
    boundaries; the limits are the cell's own."""
    from repro_torch.models import ssm

    monkeypatch.setattr(ssm, "SCAN_GROUP", 1)
    group = ssm._mamba_group
    r = run_cell(CELL, SEED, 0.2, False, device="cpu", cell=tiny_hybrid(), fault=fault,
                 t_start=0.0)
    assert r["correct"] is (fault is None), r["checks"]
    assert ssm._mamba_group is group  # the planted fault is taken out again


def test_traced_run_records_the_scan():
    r = run_cell(CELL, SEED, 0.2, True, device="cpu", cell=tiny_hybrid(), t_start=0.0)
    assert r["correct"]
    assert "serve.decode_used_pct" in r["metrics"]
    # device seconds and shares of the card's peaks: none from a CPU run
    for name in ("serve.mamba_prefill_pct", "serve.mamba_scan_roofline_pct",
                 "serve.prefill_mfu_pct"):
        assert name not in r["metrics"]


def test_mamba_leaves_are_drawn_as_mamba_draws_them():
    from repro_torch.models import Model

    cell = tiny_hybrid()
    model = Model(hx.arch_config(cell.arch), device="cpu")
    serve_hybrid.fill(list(model.named_parameters()), 7, cell.config["init_std"])
    weights = serve_hybrid.make_weights(hx.param_shapes(model), 7, "cpu",
                                        cell.config["init_std"])
    for name, p in model.named_parameters():  # the program's and the reference's alike
        assert torch.equal(p.detach(), weights[name]), name
    mixer = model.blocks[0].mixer
    ds = mixer.A_log.shape[1]
    assert torch.equal(mixer.A_log.detach(),
                       torch.log(torch.arange(1, ds + 1.0)).expand(mixer.A_log.shape))
    assert torch.equal(mixer.D.detach(), torch.ones_like(mixer.D))
    dt = torch.nn.functional.softplus(mixer.dt_bias.detach())
    assert dt.min() >= 0.999e-3 and dt.max() <= 1.001e-1 and dt.std() > 0
    bound = 1 / math.sqrt(mixer.conv_w.shape[0])
    assert mixer.conv_b.abs().max() <= bound and mixer.conv_b.std() > 0
    assert not torch.equal(model.blocks[2].mixer.dt_bias, mixer.dt_bias)
    assert (mixer.dt_norm.scale - 1).abs().max() > 0  # the norms' scales: 1 + 0.02 z


def _records(spans):
    """(name, parent index, device seconds) -> the snapshot's records."""
    return [{"name": n, "parent": p, "tag": None, "device_s": s} for n, p, s in spans]


HYBRID_SNAP = {
    "records": _records([("engine.wave", None, None), ("model.prefill", 0, 2.0),
                         ("mamba", 1, 0.5), ("mamba.scan", 2, 0.2),
                         ("mamba", 1, 0.3), ("mamba.scan", 4, 0.1),
                         ("attention", 1, None),
                         ("model.decode_step", 0, 0.05), ("mamba.decode", 7, 0.01),
                         ("mamba", 7, 0.9), ("mamba.scan", 9, 0.7)]),
    "counters": {"mamba.scan_tokens": {"model.prefill": 2 * 4096, "model.decode_step": 8},
                 "mamba.scan_calls": {"model.prefill": 2}}}
RECORD = {"kind": "serve", "mamba": {"d_inner": 8192, "d_state": 16, "dt_rank": 256,
                                     "layers": 2}}
PEAK = {"bf16_flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12}


@pytest.fixture
def snap(monkeypatch):
    from repro_torch import obs

    def use(value):
        monkeypatch.setattr(obs, "snapshot", lambda: value)
    return use


def test_readers_on_a_hand_made_record(snap):
    snap(HYBRID_SNAP)
    share = hx.reader("serve.mamba_prefill_pct").read(RECORD, PEAK)
    assert share == pytest.approx(100 * (0.5 + 0.3) / 2.0)  # the decode step's span is not prefill's
    roof = hx.reader("serve.mamba_scan_roofline_pct").read(RECORD, PEAK)
    least = 2 * 4096 * (3 * 8192 + 2 * 16) * 2 / 3.35e12
    assert roof == pytest.approx(100 * least / (0.2 + 0.1))


def test_readers_read_nothing_without_spans_or_device_times(snap):
    for name in ("serve.mamba_prefill_pct", "serve.mamba_scan_roofline_pct"):
        mod = hx.reader(name)
        snap(None)  # a program without ``repro_torch.obs``
        assert mod.read(RECORD, PEAK) is None
        snap({"records": [], "counters": {}})  # a program without the spans
        assert mod.read(RECORD, PEAK) is None
        cpu = copy.deepcopy(HYBRID_SNAP)
        for r in cpu["records"]:
            r["device_s"] = None
        snap(cpu)  # a CPU run
        assert mod.read(RECORD, PEAK) is None
        snap(HYBRID_SNAP)
        assert mod.read(dict(RECORD, kind="train"), PEAK) is None
    assert hx.reader("serve.mamba_scan_roofline_pct").read({"kind": "serve"}, PEAK) is None


def test_flops_hybrid_by_hand():
    a = hx.find_cell(CELL).arch
    assert flops_hybrid.layer_kinds(a) == [
        ("mamba", "mlp"), ("mamba", "moe"), ("mamba", "mlp"), ("mamba", "moe"),
        ("attn", "mlp"), ("mamba", "moe"), ("mamba", "mlp"), ("mamba", "moe")]
    attn = 2 * 4096 * 4096 + 2 * 4096 * 1024  # q, o 32 heads of 128; k, v 8
    mamba = 4096 * 16384 + 8192 * (256 + 32) + 256 * 8192 + 8192 * 4096  # in, x, dt, out
    moe = 4096 * 16 + 2 * 3 * 4096 * 14336  # the router and 2 of 16 experts
    mlp = 3 * 4096 * 14336
    assert flops_hybrid.mixer_params(a, "attn") == attn == 41_943_040
    assert flops_hybrid.mixer_params(a, "mamba") == mamba == 105_119_744
    assert flops_hybrid.ffn_params(a, "moe") == moe == 352_387_072
    assert flops_hybrid.ffn_params(a, "mlp") == mlp == 176_160_768
    f = flops_hybrid.prefill_flops(a, 4, 32768)
    dense = 2 * (attn + 7 * mamba + 4 * moe + 4 * mlp) * 4 * 32768
    causal = 2 * 4 * 32 * 32768 ** 2 * 128  # one attention layer, half the score matrix
    head = 2 * 4096 * 65536 * 4  # the last token of each prompt
    assert f == {"dense_flops": dense + head, "attention_flops": causal,
                 "flops": dense + causal + head}
    assert f["flops"] == pytest.approx(0.7933e15, rel=1e-3)
    assert flops_hybrid.mamba_dims(a) == {"d_inner": 8192, "d_state": 16, "dt_rank": 256}
    assert flops_hybrid.scan_bytes(4 * 32768, 8192, 16) == 4 * 32768 * 24_608 * 2
