"""The plain reference against the port, at a tiny size on the CPU, in
float32: the same weights and tokens give the same logits, the same served
tokens and the same three train steps.  (The test may import both; the
reference imports nothing of the port.)"""
import numpy as np
import pytest
import torch

from perfbench import harness as hx
from perfbench.drivers import train as drv_train
from perfbench.reference import model as ref_model
from perfbench.reference import serve as ref_serve
from perfbench.reference import train as ref_train

from pb_tiny import tiny_cell

CELLS = {"dense": ("qwen3_0_6b.train_4k", "qwen3_0_6b.prefill_8k"),
         "moe": ("qwen2_moe_a2_7b.train_1k", "qwen2_moe_a2_7b.prefill_4k")}


def _model(cell, seed=11):
    from repro_torch.models import Model

    model = Model(hx.arch_config(cell.arch), device="cpu")
    hx.fill_weights(list(model.named_parameters()), seed, cell.config.get("init_std"))
    return model, hx.make_weights(hx.param_shapes(model), seed, "cpu", cell.config.get("init_std"))


@pytest.mark.parametrize("family", sorted(CELLS))
def test_weights_are_the_same_tensors(family):
    model, weights = _model(tiny_cell(CELLS[family][0]))
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), weights[name])


@pytest.mark.parametrize("family", sorted(CELLS))
def test_forward_logits(family):
    cell = tiny_cell(CELLS[family][0])
    model, weights = _model(cell)
    tokens = torch.randint(0, cell.arch["vocab"], (2, 64), generator=torch.Generator().manual_seed(3))
    want = model.train_forward({"tokens": tokens})[..., : cell.arch["vocab"]].detach()
    lm = ref_model.RefLM(cell.arch, weights)
    groups = ref_model.contiguous_groups(tokens.numel(), cell.arch.get("moe_capacity_factor", 1.25),
                                         "cpu")
    x = lm.embed(tokens)
    for i in range(cell.arch["n_layers"]):
        x = lm.block(i, x, groups)[0]
    got = lm.logits(x)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("family", sorted(CELLS))
def test_served_tokens_are_the_references_best(family):
    from repro_torch.serve.legacy.engine import Request, ServeEngine

    cell = tiny_cell(CELLS[family][1])
    model, weights = _model(cell)
    b, p, n = 4, 64, 5
    prompts = np.random.default_rng(5).integers(0, cell.arch["vocab"], (b, p), dtype=np.int32)
    done = ServeEngine(model, batch=b, max_seq=p + n).run(
        [Request(rid=i, prompt=prompts[i], max_new=n) for i in range(b)])
    served = torch.as_tensor(np.stack([r.out for r in sorted(done, key=lambda r: r.rid)]))
    logits = ref_serve.served_logits(cell.arch, weights, torch.as_tensor(prompts), served)
    assert float(ref_serve.token_gaps(logits, served).max()) < 1e-4


@pytest.mark.parametrize("family", sorted(CELLS))
def test_three_train_steps(family):
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import TrainConfig, make_train_step

    cell = tiny_cell(CELLS[family][0])
    model, weights = _model(cell)
    hp = cell.traffic["optimizer"]
    tcfg = TrainConfig(optimizer=opt.OptimizerConfig(**hp))
    params = dict(model.named_parameters())
    state = opt.init(tcfg.optimizer, params)
    step = make_train_step(model, tcfg)
    feed = drv_train.Feed(9, 2, 64, cell.arch["vocab"], torch.device("cpu"))
    batches = [feed.next() for _ in range(3)]
    losses = []
    for i, bt in enumerate(batches):
        state, m = step(state, bt)
        losses.append(float(m["loss"]))
        if i == 0:
            grads = {k: float(v.norm()) / (1 - hp["beta1"]) for k, v in state["m"].items()}
    ref = ref_train.run(cell.arch, weights, [(bt["tokens"], bt["labels"]) for bt in batches], hp)
    assert losses == pytest.approx(ref["losses"], rel=1e-5)
    for k in grads:
        assert grads[k] == pytest.approx(ref["grad_norms"][k], rel=1e-3, abs=1e-8)
        change = float((params[k].detach() - weights[k]).norm())
        assert change == pytest.approx(ref["change_norms"][k], rel=1e-3, abs=1e-8)


def test_control_rounds_products_to_float8():
    a = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    exact = a @ a
    low = ref_model.matmul(a, a, "fp8")
    rel = float((low - exact).norm() / exact.norm())
    assert 1e-3 < rel < 0.2
    with pytest.raises(ValueError):
        ref_model.matmul(a, a, "int4")


def test_drop_share_counts_the_ports_dropped_pairs():
    from repro_torch.models import moe as port_moe

    cell = tiny_cell(CELLS["moe"][1])
    a = cell.arch
    _, weights = _model(cell)
    t, factor = 128, 0.5  # a small capacity, so that pairs drop
    h = torch.randn(1, t, a["d_model"], generator=torch.Generator().manual_seed(4))
    lm = ref_model.RefLM(a, weights)
    lm.moe(0, h, ref_model.contiguous_groups(t, factor, "cpu"))
    g = port_moe._group_size(t)
    cap = port_moe._capacity(g, a["top_k"], a["n_experts"], factor)
    r = port_moe.route(weights["blocks.0.moe.router"].float(), h.reshape(t // g, g, -1),
                       a["top_k"], cap)
    want = float((~r.keep).float().mean())
    assert want > 0
    assert ref_model.drop_share(lm.pairs) == {str(factor): pytest.approx(want)}
