"""Jamba's published traits in the port (attention without positions, the
dt/B/C norms, top-k gates left unnormalised: ``attn_rope`` off,
``ssm_dt_bc_norm`` and ``norm_topk_prob`` off) against the plain reference
``tests/plain_jamba.py``, on a tiny config with the published layer layout,
in float32 on the CPU; and the two memory bounds the full-width model
needs, the Mamba scan's grouped forward and the experts' row blocks,
against their one-piece forms.

Tolerances: 1e-4 where the port's model meets the plain one (float32
logits of eight layers: the chunked scan takes products of decays in log
depth where the reference multiplies a token at a time, and the products'
sums run in another order); 1e-6 where one computation is cut into groups
or blocks (the same operations on the same numbers, only batched
differently); 1e-5 for a weight's gradient over row blocks (the blocks'
sums added in another order).
"""
from __future__ import annotations

import dataclasses
import math

import pytest
import torch

from plain_jamba import PlainJamba, contiguous_groups, serve_groups
from repro_torch.configs.base import ArchConfig
from repro_torch.models import Model, layers, moe, ssm

TINY = ArchConfig(arch="jamba2_tiny", family="hybrid", n_layers=8, d_model=64, n_heads=4,
                  n_kv_heads=2, d_head=16, d_ff=96, vocab=256, n_experts=8, top_k=2,
                  expert_d_ff=80, moe_every=2, attn_period=8, ssm_d_state=8, ssm_d_conv=4,
                  ssm_expand=2, attn_rope=False, ssm_dt_bc_norm=True, norm_topk_prob=False,
                  dtype="float32")
TOL = 1e-4  # the port's model against the plain one (see the module's docstring)
CUT_TOL = 1e-6  # a computation against itself cut into groups or blocks
# a weight's gradient over row blocks: the blocks' sums added in another order
BLOCK_GRAD_TOL = 1e-5


def _close(got, want, tol=TOL):
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@torch.no_grad()
def _model(cfg: ArchConfig = TINY, seed: int = 0):
    """The port's model and its weights by name, every leaf drawn away from
    its init value (Mamba's as Mamba draws them), so that each one counts."""
    model = Model(cfg, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        last = name.rsplit(".", 1)[-1]
        z = torch.randn(p.shape, generator=gen)
        if last == "A_log":
            p.copy_(torch.log(torch.arange(1, p.shape[1] + 1.0)).expand(p.shape) + 0.1 * z)
        elif last == "dt_bias":
            dt = torch.exp(torch.rand(p.shape, generator=gen) * math.log(100.0) + math.log(1e-3))
            p.copy_(dt + torch.log(-torch.expm1(-dt)))
        elif last in ("scale", "D"):
            p.copy_(1.0 + 0.1 * z)
        elif last == "conv_b":
            p.copy_(0.5 * z)
        elif name == "embed.tok":
            p.copy_(z)
        else:
            p.copy_(z / math.sqrt(p.shape[-2]))
    return model, {n: p.detach().clone() for n, p in model.named_parameters()}


def _tokens(b: int, s: int, seed: int) -> torch.Tensor:
    return torch.randint(0, TINY.vocab, (b, s), generator=torch.Generator().manual_seed(seed))


def test_the_tiny_config_has_the_published_layout():
    kinds = [(blk.spec.mixer, blk.spec.ffn) for blk in _model()[0].blocks]
    assert kinds == [("mamba", "mlp"), ("mamba", "moe"), ("mamba", "mlp"), ("mamba", "moe"),
                     ("attn", "mlp"), ("mamba", "moe"), ("mamba", "mlp"), ("mamba", "moe")]


@pytest.mark.parametrize("group", [ssm.SCAN_GROUP, 1])
def test_full_sequence_logits(group, monkeypatch):
    """Three chunks and a ragged fourth, in one scan group or four."""
    monkeypatch.setattr(ssm, "SCAN_GROUP", group)
    model, weights = _model()
    tokens = _tokens(2, 3 * ssm.SCAN_CHUNK + 7, 1)
    got = model.forward({"tokens": tokens})[..., :TINY.vocab]
    ref = PlainJamba(dataclasses.asdict(TINY), weights)
    want = ref.forward(tokens, contiguous_groups(tokens.numel(), TINY.moe_capacity_factor))
    _close(got, want)


def test_prefill_then_decode_match_the_full_pass(monkeypatch):
    """Prefill fills the hybrid cache (seven layers' recurrent states, one
    layer's unrotated K/V); each decode step's logits equal the
    reference's full pass over the prompt and the tokens fed since."""
    monkeypatch.setattr(ssm, "SCAN_GROUP", 1)
    model, weights = _model(seed=2)
    b, p, n = 2, 2 * ssm.SCAN_CHUNK + 9, 5
    prompts, fed = _tokens(b, p, 3), _tokens(b, n, 4)
    cache = model.init_cache(b, p + n)
    logits, cache = model.prefill({"tokens": prompts}, cache)
    steps = [logits[:, -1]]
    for j in range(n - 1):
        logits, cache = model.decode_step(fed[:, j:j + 1], cache, p + j)
        steps.append(logits[:, -1])
    got = torch.stack(steps, dim=1)[..., :TINY.vocab]
    ref = PlainJamba(dataclasses.asdict(TINY), weights)
    tokens = torch.cat([prompts, fed[:, :-1]], dim=1)
    want = ref.forward(tokens, serve_groups(b, p, n, TINY.moe_capacity_factor))[:, p - 1:]
    _close(got, want)


def _scan_args(s: int, seed: int = 5):
    gen = torch.Generator().manual_seed(seed)
    b, d_in, ds = 2, 8, 4

    def u(*shape, lo=-1.0, hi=1.0):
        return (torch.rand(shape, generator=gen) * (hi - lo) + lo).requires_grad_()

    return (u(b, s, d_in, lo=0.0, hi=0.5), u(b, s, ds), u(b, s, ds), u(b, s, d_in),
            u(d_in, ds, lo=-2.0, hi=-0.5))


def _scan_and_grads(args):
    y, h = ssm._mamba_scan(*args)
    probe = torch.cos(torch.arange(y.numel(), dtype=torch.float32)).reshape(y.shape)
    ((y * probe).sum() + h.sum()).backward()
    grads = [a.grad.clone() for a in args]
    for a in args:
        a.grad = None
    return y.detach(), h.detach(), grads


@pytest.mark.parametrize("group", [1, 2, 3])
def test_grouped_scan_forward_matches_one_group(group, monkeypatch):
    """Five chunks and a ragged sixth: the state carried across every group
    boundary gives the one-group forward's outputs and final state, and the
    backward's gradients are unchanged; serving's forward, which keeps no
    chunk's state, gives the same."""
    args = _scan_args(5 * ssm.SCAN_CHUNK + 7)
    monkeypatch.setattr(ssm, "SCAN_GROUP", 1000)
    want = _scan_and_grads(args)
    monkeypatch.setattr(ssm, "SCAN_GROUP", group)
    y, h, grads = _scan_and_grads(args)
    _close(y, want[0], CUT_TOL)
    _close(h, want[1], CUT_TOL)
    for g, w in zip(grads, want[2]):
        _close(g, w, CUT_TOL)
    with torch.no_grad():
        y_serve, h_serve = ssm._mamba_scan(*args)
    _close(y_serve, y, CUT_TOL)
    _close(h_serve, h, CUT_TOL)


def _fused_args(s: int, dtype: torch.dtype, seed: int = 11, ds: int = 4):
    """The fused scan's inputs as the mixer holds them: dt before its
    softplus (a few tokens above the threshold of 20) and xc in ``dtype``,
    B and C f32, A and D f32 as Mamba draws them."""
    gen = torch.Generator().manual_seed(seed)
    b, d_in = 2, 8
    dt = torch.randn(b, s, d_in, generator=gen) - 3.0
    dt[:, ::37, ::3] += 25.0
    xc = torch.randn(b, s, d_in, generator=gen)
    bmat, cmat = (torch.randn(b, s, ds, generator=gen) for _ in range(2))
    a = -torch.exp(torch.log(torch.arange(1, ds + 1.0)) + 0.1 * torch.randn(d_in, ds, generator=gen))
    d = 1.0 + 0.1 * torch.randn(d_in, generator=gen)
    return dt.to(dtype), bmat, cmat, xc.to(dtype), a, d


def _recurrence(dt, bmat, cmat, xc, a, d):
    """The scan a token at a time in float64, as the kernel's head note
    states it: (y, final h)."""
    dt, x = torch.nn.functional.softplus(dt.double()), xc.double()
    bmat, cmat, a, d = bmat.double(), cmat.double(), a.double(), d.double()
    h = x.new_zeros(x.shape[0], x.shape[2], a.shape[1])
    ys = []
    for t in range(x.shape[1]):
        h = torch.exp(dt[:, t, :, None] * a) * h + (dt[:, t] * x[:, t])[..., None] * bmat[:, t, None]
        ys.append((h * cmat[:, t, None]).sum(-1) + x[:, t] * d)
    return torch.stack(ys, dim=1), h


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [1, 2, 3, ssm.SCAN_GROUP])
def test_fused_plain_scan_matches_the_chunked_path(group, dtype, monkeypatch):
    """The serving route on the CPU (``_selective_scan``, the kernel's plain
    version) against the chunked path as the mixer ran it before the fused
    signature, with the softplus, the D skip and the cast outside the scan:
    the same operations, so y and the final h agree to ``CUT_TOL``, over
    five chunks and a ragged sixth in groups of 1, 2, 3 or all of them; and
    in float32 against the recurrence a token at a time."""
    monkeypatch.setattr(ssm, "SCAN_GROUP", group)
    args = _fused_args(5 * ssm.SCAN_CHUNK + 7, dtype)
    dt, bmat, cmat, xc, a, d = args
    with torch.no_grad():
        y, h = ssm._selective_scan(*args)
        xcf = xc.float()
        ys, want_h = ssm._mamba_scan(torch.nn.functional.softplus(dt.float()), bmat, cmat, xcf, a)
        want_y = (ys + xcf * d).to(dtype)
    assert y.dtype == dtype and h.dtype == torch.float32
    _close(y.float(), want_y.float(), CUT_TOL)
    _close(h, want_h, CUT_TOL)
    if dtype == torch.float32:
        ref_y, ref_h = _recurrence(*args)
        _close(y.double(), ref_y)
        _close(h.double(), ref_h)


@pytest.mark.parametrize("grad", [False, True])
def test_the_cpu_scan_takes_the_plain_route(grad, monkeypatch):
    """On the CPU the fused scan never takes the kernel: without a gradient
    it runs the chunked forward and keeps no chunk's state; with one it
    takes ``_MambaScan``, whose gradients reach dt, xc and D through the
    softplus and the D skip.  ``mamba.scan_kernel`` counts 0 either way."""
    counts, applied = [], []
    monkeypatch.setattr(ssm.obs, "count", lambda name, value: counts.append((name, value)))
    apply = ssm._MambaScan.apply
    monkeypatch.setattr(ssm._MambaScan, "apply", lambda *a: applied.append(1) or apply(*a))
    args = [t.requires_grad_() for t in _fused_args(2 * ssm.SCAN_CHUNK + 3, torch.float32)]
    assert not ssm._takes_scan_kernel(tuple(args))
    with torch.set_grad_enabled(grad):
        y, h = ssm._selective_scan(*args)
    assert counts == [("mamba.scan_kernel", 0)]
    assert applied == ([1] if grad else [])
    assert y.requires_grad is grad
    if grad:
        grads = torch.autograd.grad(y.square().sum() + h.sum(), [args[0], args[3], args[5]])
        assert all(g is not None and bool(g.abs().sum() > 0) for g in grads)


def test_the_kernel_wrapper_raises_on_what_it_does_not_take():
    """``ssm_scan_fwd`` takes CUDA tensors at d_state 16 and nothing else:
    no fallback to the plain version."""
    from repro_torch.kernels.ssm_scan import ssm_scan_fwd

    args = _fused_args(9, torch.bfloat16, ds=16)
    with pytest.raises(ValueError, match="CUDA"):
        ssm_scan_fwd(*args)
    dt, bmat, cmat, xc, a, d = args
    with pytest.raises(ValueError, match="d_state"):
        ssm_scan_fwd(dt, bmat[..., :8], cmat[..., :8], xc, a[:, :8], d)


def test_the_planted_scan_fault_still_bites_on_the_cpu(monkeypatch):
    """``scan_carry_dropped`` (the benchmark's planted fault, in
    ``_mamba_group``) still changes the CPU serving route's prefill."""
    from perfbench.drivers.serve_hybrid import _drop_scan_carry

    monkeypatch.setattr(ssm, "SCAN_GROUP", 1)
    model, _ = _model(seed=3)
    prompts = _tokens(2, 3 * ssm.SCAN_CHUNK + 5, 6)

    def prefill():
        logits, cache = model.prefill({"tokens": prompts}, model.init_cache(2, prompts.shape[1]))
        return logits

    clean = prefill()
    undo = _drop_scan_carry()
    try:
        faulty = prefill()
    finally:
        undo()
    assert not torch.allclose(faulty, clean, rtol=TOL, atol=TOL)
    torch.testing.assert_close(prefill(), clean, rtol=0, atol=0)


def _experts_args(e=4, n=37, d=16, eff=24, seed=6):
    gen = torch.Generator().manual_seed(seed)
    return [(torch.randn(shape, generator=gen) / math.sqrt(shape[-2])).requires_grad_()
            for shape in ((e, n, d), (e, d, eff), (e, d, eff), (e, eff, d))]


def test_experts_in_row_blocks_match_one_block(monkeypatch):
    args = _experts_args()
    want = moe.experts(*args)
    want_grads = torch.autograd.grad(want.square().sum(), args)
    e, _, _ = args[0].shape
    eff = args[1].shape[-1]
    # five rows a block: 37 rows are seven blocks of five and one of two
    monkeypatch.setattr(layers, "HIDDEN_BUDGET", 5 * e * eff * args[0].element_size())
    calls = []
    swiglu = moe._swiglu
    monkeypatch.setattr(moe, "_swiglu", lambda *a: calls.append(a[0].shape[1]) or swiglu(*a))
    got = moe.experts(*args)
    assert calls == [5] * 7 + [2]
    _close(got, want, CUT_TOL)
    for g, w in zip(torch.autograd.grad(got.square().sum(), args), want_grads):
        _close(g, w, BLOCK_GRAD_TOL)


@pytest.mark.parametrize("cell,blocks", [
    ((60, 128 * 44, 2048, 1408), 1),  # qwen2-moe, 16 x 4,096 tokens: 0.95 GB, today's path
    ((16, 256 * 84, 4096, 14336), 5),  # Jamba, 4 x 32,768 tokens: 9.9 GB a hidden
])
def test_the_benchmark_cells_expert_blocks(cell, blocks, monkeypatch):
    """(experts, slot rows, d, eff) of the serving cells' prefill: groups of
    512 tokens at capacity 1.25 (44 slots an expert a group of qwen2-moe's
    60 top-4, 84 of Jamba's 16 top-2), in bf16, on the meta device."""
    e, n, d, eff = cell
    meta = dict(device="meta", dtype=torch.bfloat16)
    calls = []
    swiglu = moe._swiglu
    monkeypatch.setattr(moe, "_swiglu", lambda *a: calls.append(a[0].shape[1]) or swiglu(*a))
    out = moe.experts(torch.empty(e, n, d, **meta), torch.empty(e, d, eff, **meta),
                      torch.empty(e, d, eff, **meta), torch.empty(e, eff, d, **meta))
    assert out.shape == (e, n, d) and len(calls) == blocks and sum(calls) == n
    assert max(calls) * e * eff * 2 <= layers.HIDDEN_BUDGET or blocks == 1


def test_norm_topk_prob_off_keeps_the_softmax_gates():
    model, weights = _model(seed=7)
    layer = 1  # a MoE layer
    p = model.blocks[layer].moe
    h = torch.randn(2, 48, TINY.d_model, generator=torch.Generator().manual_seed(8))
    g = moe._group_size(96)
    cap = moe._capacity(g, TINY.top_k, TINY.n_experts, TINY.moe_capacity_factor)
    xg = h.reshape(96 // g, g, -1)
    kept = moe.route(p.router, xg, TINY.top_k, cap, renormalise=False)
    probs = torch.softmax(xg @ p.router, dim=-1)
    torch.testing.assert_close(kept.gate, torch.topk(probs, TINY.top_k, dim=-1).values)
    assert (kept.gate.sum(-1) < 1).all()
    normed = moe.route(p.router, xg, TINY.top_k, cap)  # the reference's renormalised gates
    _close(normed.gate, kept.gate / kept.gate.sum(-1, keepdim=True), CUT_TOL)
    with torch.no_grad():
        got, _ = moe.moe(p, TINY, h)
    ref = PlainJamba(dataclasses.asdict(TINY), weights)
    _close(got, ref.moe(layer, h, contiguous_groups(96, TINY.moe_capacity_factor)))


def test_dense_swiglu_in_row_blocks_matches_one_block(monkeypatch):
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(3, 13, 16, generator=gen).requires_grad_()
    w = [(torch.randn(shape, generator=gen) / math.sqrt(shape[0])).requires_grad_()
         for shape in ((16, 24), (16, 24), (24, 16))]
    want = layers.mlp(x, *w)
    want_grads = torch.autograd.grad(want.square().sum(), [x, *w])
    monkeypatch.setattr(layers, "HIDDEN_BUDGET", 4 * 24 * x.element_size())  # 4 of 39 rows
    calls = []
    swiglu = layers._swiglu
    monkeypatch.setattr(layers, "_swiglu", lambda *a: calls.append(a[0].shape[0]) or swiglu(*a))
    got = layers.mlp(x, *w)
    assert calls == [4] * 9 + [3]
    _close(got, want, CUT_TOL)
    for g, wg in zip(torch.autograd.grad(got.square().sum(), [x, *w]), want_grads):
        _close(g, wg, BLOCK_GRAD_TOL)


@pytest.mark.parametrize("cell,blocks", [
    ((16 * 8192, 1024, 3072), 1),  # qwen3's prefill_8k: 0.8 GB
    ((16 * 4096, 2048, 5632), 1),  # qwen2-moe's shared experts, prefill_4k: 0.74 GB
    ((4 * 32768, 4096, 14336), 2),  # Jamba's dense SwiGLU, 4 x 32,768 tokens: 3.8 GB
])
def test_the_benchmark_cells_dense_blocks(cell, blocks, monkeypatch):
    rows, d, dff = cell
    meta = dict(device="meta", dtype=torch.bfloat16)
    calls = []
    swiglu = layers._swiglu
    monkeypatch.setattr(layers, "_swiglu", lambda *a: calls.append(a[0].shape[0]) or swiglu(*a))
    out = layers.mlp(torch.empty(rows, d, **meta), torch.empty(d, dff, **meta),
                     torch.empty(d, dff, **meta), torch.empty(dff, d, **meta))
    assert out.shape == (rows, d) and len(calls) == blocks and sum(calls) == rows
