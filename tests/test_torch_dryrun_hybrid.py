"""The dry run's hybrid and encoder-decoder prefill cells,
``jamba_v0_1_52b prefill_32k`` and ``whisper_small prefill_32k`` on the
single pod (256 ranks), on the CPU: their FLOPs a rank within
``FLOPS_TOL`` of a closed form.  Every product runs on the rank's rows and
columns: mamba's four products through ``gather_fsdp`` as the dense ones,
the residual pinned between the mixer and the ffn and before the
cross-attention, and attention head-parallel on each rank's shard (the
heads padded with zeros to a multiple of the 16 "model" ranks, as the
reference's GSPMD pads them).  Left to DTensor, torch 2.13 ran the dense
MLP's up-projections and every attention head on every "model" rank
(jamba 410.6 TFLOP a rank; 179.7 on 2.11), and whisper's cross-attention
queries on every column (5.576 TFLOP a rank; 4.706 on 2.11).  The child
process holds the fake process group, which is process-wide state.
"""
from __future__ import annotations

import json

from repro.models.moe import GROUP_TARGET, _capacity
from repro_torch.configs.base import SHAPES, get_arch
from repro_torch.models.ssm import mamba_dims
from repro_torch.models.transformer import layer_program
from test_torch_dryrun import FLOPS_TOL, _dryrun

RANKS = 256


def _closed_form_hybrid_prefill_flops(cfg, shape) -> float:
    """Matmul FLOPs of a hybrid config's prefill, per device of 256: every
    layer's weight products over every token (mamba's in, x, dt and out
    projections, the attention projections, the dense MLP, the router and
    the routed experts over their capacity slots, a routing group of
    ``GROUP_TARGET`` tokens each with the reference's capacity), mamba's
    readout ``y = h C``, causal attention (half of 4 B nq S^2 hd), and the
    unembedding of the last token."""
    b, s = shape.global_batch, shape.seq_len
    tokens = b * s
    d, hd, nq, nkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    d_in, dt_rank = mamba_dims(cfg)
    ds = cfg.ssm_d_state
    e, k, eff = cfg.n_experts, cfg.top_k, cfg.expert_d_ff
    program = layer_program(cfg)
    attn = sum(sp.mixer == "attn" for sp in program)
    mamba = sum(sp.mixer == "mamba" for sp in program)
    mlp = sum(sp.ffn == "mlp" for sp in program)
    moe = sum(sp.ffn == "moe" for sp in program)
    slots = tokens // GROUP_TARGET * _capacity(GROUP_TARGET, k, e, cfg.moe_capacity_factor) * e
    macs = tokens * (
        attn * (d * nq * hd + 2 * d * nkv * hd + nq * hd * d)
        + mamba * (d * 2 * d_in + d_in * (dt_rank + 2 * ds) + dt_rank * d_in + d_in * d
                   + d_in * ds)
        + mlp * 3 * d * cfg.d_ff
        + moe * d * e) + moe * slots * 3 * d * eff
    attention = attn * 4 * b * nq * s * s * hd / 2
    unembed = 2 * b * d * -(-cfg.vocab // RANKS) * RANKS
    return (2 * macs + attention + unembed) / RANKS


def _closed_form_encdec_prefill_flops(cfg, shape) -> float:
    """Matmul FLOPs of an encoder-decoder config's prefill, per device of
    256: the decoder's self-attention and cross-attention projections and
    MLP over every token, the cross K/V over the encoder's frames, the
    encoder's projections and MLP over the frames; causal self-attention,
    the cross scores and the encoder's non-causal attention over the heads
    padded to a multiple of 16; the unembedding of the last token."""
    b, s, frames = shape.global_batch, shape.seq_len, cfg.n_frames
    d, hd, nq, nkv, ff = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    heads = -(-nq // 16) * 16
    self_proj = d * nq * hd + 2 * d * nkv * hd + nq * hd * d
    macs = (b * s * (self_proj + 2 * d * nq * hd + 3 * d * ff) * cfg.n_layers
            + b * frames * 2 * d * nkv * hd * cfg.n_layers
            + b * frames * (self_proj + 3 * d * ff) * cfg.n_enc_layers)
    attention = 4 * b * heads * hd * (s * s / 2 * cfg.n_layers + s * frames * cfg.n_layers
                                      + frames * frames * cfg.n_enc_layers)
    unembed = 2 * b * d * -(-cfg.vocab // RANKS) * RANKS
    return (2 * macs + attention + unembed) / RANKS


def _prefill_record(tmp_path, cfg, shape) -> dict:
    out = _dryrun(tmp_path, "--arch", cfg.arch, "--shape", shape.name, "--mesh", "single",
                  "--device", "cpu")
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.load(open(tmp_path / "single" / f"{cfg.arch}__{shape.name}.json"))
    assert rec["status"] == "ok" and rec["step_kind"] == "prefill_step"
    return rec


def test_hybrid_prefill_cell_flops_match_a_closed_form(tmp_path):
    cfg, shape = get_arch("jamba_v0_1_52b"), SHAPES["prefill_32k"]
    rec = _prefill_record(tmp_path, cfg, shape)
    want = _closed_form_hybrid_prefill_flops(cfg, shape)
    got = rec["op_analysis"]["flops_per_device"]
    assert abs(got - want) <= FLOPS_TOL * want, (got, want)
    assert rec["memory"]["peak_bytes"] < 80e9


def test_encdec_prefill_cell_flops_match_a_closed_form(tmp_path):
    cfg, shape = get_arch("whisper_small"), SHAPES["prefill_32k"]
    rec = _prefill_record(tmp_path, cfg, shape)
    want = _closed_form_encdec_prefill_flops(cfg, shape)
    got = rec["op_analysis"]["flops_per_device"]
    assert abs(got - want) <= FLOPS_TOL * want, (got, want)
