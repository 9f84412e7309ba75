"""The port's attention (``repro_torch.kernels.attention``) against the JAX
package's flash-attention kernel in interpret mode.

The same numpy inputs, made from a seed, go through the reference
``repro.kernels.attention.ops.flash_attention(..., interpret=True)`` and
through the port's ``attention_plain`` and CPU ``flash_attention``.
Tolerances are the reference's own (``tests/test_kernels.py``): 2e-5 in
f32, 2e-2 in bf16.  The CUDA kernel itself is held against
``attention_plain`` on the card by ``chip_smoke.py``.

The training kernels' plain versions (``attention_lse_plain``,
``attention_bwd_plain``) are held against autograd through
``attention_plain`` and against ``jax.grad`` of the reference's
``attention_ref``; ``train_self_attention`` is held to its ``_sdpa`` path
off the card (the CPU, fake tensors); the kernels themselves against the
plain versions on the card by ``tests/test_torch_attention_card.py``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention.ops import flash_attention as ref_flash_attention
from repro.kernels.attention.ref import attention_ref
from repro.models.attention import _sdpa as ref_sdpa
from repro.models.attention import causal_mask as ref_causal_mask
from repro_torch import obs
from repro_torch.configs.base import get_arch
from repro_torch.kernels import _platform
from repro_torch.kernels.attention import (
    attention_bwd_plain,
    attention_lse_plain,
    attention_plain,
    attention_train,
    flash_attention,
)
from repro_torch.kernels.attention.attention import (
    _check_alignment,
    attention_bwd_flops,
    attention_flops,
)
from repro_torch.models import attention as attn_mod
from repro_torch.models.attention import _sdpa, causal_mask

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}

SHAPES = [  # tests/test_kernels.py's set, then qwen3's heads on a ragged S
    (1, 128, 2, 2, 64),
    (2, 256, 4, 2, 64),   # GQA group 2
    (1, 256, 4, 1, 32),   # MQA, head_dim 32
    (2, 384, 8, 8, 128),  # S past one 128-row block
    (2, 160, 16, 8, 128),  # qwen3: GQA 16/8, hd 128, S with a ragged tail
]


def _inputs(b, s, nq, nkv, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(b, s, n, hd)).astype(np.float32) for n in (nq, nkv, nkv)]
    ref = [jnp.asarray(a, JNP[dtype]) for a in arrays]
    port = [torch.from_numpy(a).to(TORCH[dtype]) for a in arrays]
    return ref, port


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_attention_matches_reference_kernel(shape, dtype):
    _platform.reset_launches()
    ref, port = _inputs(*shape, dtype, seed=sum(shape))
    want = ref_flash_attention(*ref, causal=True, interpret=True)
    b, s, nq, _, hd = shape
    out = flash_attention(*port, causal=True)
    assert out.shape == (b, s, nq * hd) and out.dtype == TORCH[dtype]
    _close(out, want, TOL[dtype])
    _close(attention_plain(*port, causal=True).reshape(b, s, nq * hd), want, TOL[dtype])
    assert _platform.LAUNCHES["attention"] == 0  # the CPU takes the plain version


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_non_causal_matches_reference_kernel(dtype):
    shape = (2, 256, 4, 2, 64)
    ref, port = _inputs(*shape, dtype, seed=7)
    want = ref_flash_attention(*ref, causal=False, interpret=True)
    _close(flash_attention(*port, causal=False), want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 160, 4, 2, 64), (2, 200, 4, 4, 32)],
                         ids=lambda s: "x".join(map(str, s)))
def test_non_causal_ragged_sequence_matches_reference_sdpa(shape, dtype):
    """Non-causal attention at an S that is not a multiple of the 128-row
    block (whisper's encoder attends over 1,500 frames): the reference's
    kernel refuses it, so the reference here is its model's ``_sdpa`` with
    no mask."""
    ref, port = _inputs(*shape, dtype, seed=sum(shape))
    b, s, nq, _, hd = shape
    want = ref_sdpa(*ref, None)
    out = flash_attention(*port, causal=False)
    assert out.shape == (b, s, nq * hd) and out.dtype == TORCH[dtype]
    _close(out, want, TOL[dtype])
    _close(attention_plain(*port, causal=False).reshape(b, s, nq * hd), want, TOL[dtype])


def test_wrapper_checks_shapes_and_types():
    _, (q, k, v) = _inputs(1, 64, 4, 2, 32, "float32", seed=1)
    with pytest.raises(ValueError, match="multiple"):
        attention_plain(q, k[:, :, :1].expand(1, 64, 3, 32), v[:, :, :1].expand(1, 64, 3, 32))
    with pytest.raises(TypeError):
        attention_plain(q, k.double(), v.double())
    with pytest.raises(ValueError):
        attention_plain(q, k[:, :32], v[:, :32])


def _bf16_view(size, stride, offset=0):
    base = torch.zeros(1 << 16, dtype=torch.bfloat16)
    return torch.as_strided(base, size, stride, offset)


@pytest.mark.parametrize("size, stride", [
    ((2, 8, 2, 64), (1024, 128, 64, 1)),  # contiguous, hd 64
    ((1, 4, 4, 32), (512, 128, 32, 1)),   # contiguous, hd 32
    ((2, 8, 2, 64), (2048, 256, 64, 1)),  # every 16th token of a 2x longer buffer
], ids=["hd64", "hd32", "token-stride"])
def test_alignment_check_takes_what_tma_takes(size, stride):
    _check_alignment("q", _bf16_view(size, stride))


@pytest.mark.parametrize("size, stride, offset, match", [
    ((2, 8, 2, 64), (1024, 128, 64, 1), 1, "16-byte boundary"),     # base 2 bytes off
    ((2, 8, 2, 64), (1040, 130, 65, 1), 0, "multiples of 16 bytes"),  # 130-byte heads
    ((2, 8, 2, 60), (960, 120, 60, 1), 0, "multiples of 16 bytes"),  # 120-byte rows
    ((2, 8, 2, 64), (2048, 256, 128, 2), 0, "innermost 1"),          # strided columns
], ids=["base", "head-stride", "row-stride", "inner-stride"])
def test_alignment_check_raises(size, stride, offset, match):
    """The bf16 kernel's TMA maps need a 16-byte-aligned base and 16-byte
    strides; the wrapper raises before the launch where they are not."""
    with pytest.raises(ValueError, match=match):
        _check_alignment("q", _bf16_view(size, stride, offset))


def test_sdpa_and_causal_mask_match_reference():
    rng = np.random.default_rng(3)
    b, sq, sk, nq, nkv, hd = 2, 5, 24, 8, 2, 32
    arrays = [rng.normal(size=(b, n, h, hd)).astype(np.float32)
              for n, h in ((sq, nq), (sk, nkv), (sk, nkv))]
    np.testing.assert_array_equal(causal_mask(sq, sk, 19).numpy(),
                                  np.asarray(ref_causal_mask(sq, sk, 19)))
    want = ref_sdpa(*map(jnp.asarray, arrays), ref_causal_mask(sq, sk, 19))
    got = _sdpa(*map(torch.from_numpy, arrays), causal_mask(sq, sk, 19))
    _close(got, want, 1e-6)


def test_kernel_matches_model_sdpa():
    """The port's twin of tests/test_kernels.py's check that the kernel
    agrees with the model's einsum attention."""
    rng = np.random.default_rng(0)
    b, s, nq, nkv, hd = 2, 128, 4, 2, 64
    q, k, v = (torch.from_numpy(rng.normal(size=(b, s, n, hd)).astype(np.float32))
               for n in (nq, nkv, nkv))
    _close(flash_attention(q, k, v, causal=True),
           _sdpa(q, k, v, causal_mask(s, s)).numpy(), 2e-5)


# --- the training kernels' plain versions, and the route ---------------------

# f32: sums of ~150 terms taken in another order, and exp(s - lse) where
# autograd takes softmax's quotient; bf16: the autograd chain through
# attention_plain rounds its products and their gradients to bf16 at every
# einsum, the plain backward only at the end.  Relative to the largest
# gradient.
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _grads_close(got, want, tol: float) -> None:
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        w = w.float()
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), rtol=tol,
                                   atol=tol * float(w.abs().max()))


def _grad_inputs(b, s, nq, nkv, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(b, s, n, hd)).astype(np.float32) for n in (nq, nkv, nkv, nq)]
    return [torch.from_numpy(a).to(TORCH[dtype]) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_attention_bwd_plain_matches_autograd(group, causal, dtype):
    """At an S (150) that is not a multiple of the kernels' 64- or 128-row
    tiles."""
    q, k, v, d_out = _grad_inputs(2, 150, 4, 4 // group, 32, dtype, seed=10 * group + causal)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = attention_plain(q, k, v, causal=causal)
    want = torch.autograd.grad(out, (q, k, v), d_out)
    with torch.no_grad():
        o, lse = attention_lse_plain(q, k, v, causal=causal)
        got = attention_bwd_plain(d_out, q, k, v, o, lse, causal=causal)
    assert torch.equal(o, out) and lse.shape == (2, 4, 150) and lse.dtype == torch.float32
    _grads_close(got, want, GRAD_TOL[dtype])


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_attention_bwd_plain_matches_jax_grad(group, causal):
    """f32, against ``jax.grad`` of the reference's ``attention_ref`` over
    heads laid out as it takes them, ``(B·nq, S, hd)``, kv heads repeated;
    a kv head's gradient is its group's sum."""
    b, s, nq, hd = 2, 150, 4, 32
    nkv = nq // group
    q, k, v, d_out = _grad_inputs(b, s, nq, nkv, hd, "float32", seed=20 + group + causal)

    def heads(t):  # (B, S, n, hd) -> (B·nq, S, hd), kv heads repeated
        t = np.repeat(t.numpy(), nq // t.shape[2], axis=2)
        return jnp.asarray(t.transpose(0, 2, 1, 3).reshape(b * nq, s, hd))

    weight = heads(d_out)
    gq, gk, gv = jax.grad(lambda *a: jnp.sum(attention_ref(*a, causal=causal) * weight),
                          argnums=(0, 1, 2))(heads(q), heads(k), heads(v))

    def back(g, n):  # (B·nq, S, hd) -> (B, S, n, hd), summed over the group
        g = np.asarray(g).reshape(b, nq, s, hd).transpose(0, 2, 1, 3)
        return torch.from_numpy(g.reshape(b, s, n, nq // n, hd).sum(3))

    o, lse = attention_lse_plain(q, k, v, causal=causal)
    got = attention_bwd_plain(d_out, q, k, v, o, lse, causal=causal)
    _grads_close(got, (back(gq, nq), back(gk, nkv), back(gv, nkv)), GRAD_TOL["float32"])


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_attention_train_on_the_cpu_is_the_plain_versions(causal):
    """``attention_train``'s autograd function on CPU tensors: the forward
    is ``attention_plain``'s bit for bit, the gradients autograd's."""
    q, k, v, d_out = _grad_inputs(1, 70, 4, 2, 32, "float32", seed=3)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = attention_train(q, k, v, causal=causal)
    assert torch.equal(out, attention_plain(q, k, v, causal=causal))
    got = torch.autograd.grad(out, (q, k, v), d_out)
    want = torch.autograd.grad(attention_plain(q, k, v, causal=causal), (q, k, v), d_out)
    _grads_close(got, want, GRAD_TOL["float32"])
    assert _platform.LAUNCHES["attention_bwd"] == 0


def test_training_ops_count_their_flops():
    """Under a dispatch mode (``FlopCounterMode``) ``attention_train`` goes
    through the operators, whose FLOP formulas count 2 products forward
    and 5 backward, halved when causal."""
    from torch.utils.flop_counter import FlopCounterMode

    q, k, v, d_out = _grad_inputs(2, 64, 4, 2, 32, "float32", seed=4)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    with FlopCounterMode(display=False) as counter:
        out = attention_train(q, k, v, causal=True)
        got = torch.autograd.grad(out, (q, k, v), d_out)
    shapes = (q.shape, k.shape, v.shape)
    fwd = attention_flops(*shapes, True)
    assert fwd == 4 * 2 * 4 * 64 * 64 * 32 // 2
    assert counter.get_total_flops() == fwd + attention_bwd_flops(
        d_out.shape, *shapes, q.shape, (2, 4, 64), True) == fwd * 7 // 2
    o, lse = attention_lse_plain(q, k, v, causal=True)
    for g, w in zip(got, attention_bwd_plain(d_out, q, k, v, o, lse, causal=True)):
        assert torch.equal(g, w)


def _layer(dtype, device, head_dim):
    cfg = dataclasses.replace(get_arch("qwen3_0_6b").reduced(), d_head=head_dim)
    p = attn_mod.Attention(cfg, dtype, device)
    if not isinstance(p.wq, torch._subclasses.fake_tensor.FakeTensor):
        p.init(torch.Generator().manual_seed(5))
        for n in (p.q_norm, p.k_norm):
            n.scale.data.normal_(1.0, 0.1, generator=torch.Generator().manual_seed(6))
    return cfg, p


def _sdpa_route(p, cfg, x, causal):
    """``train_self_attention`` as it was before the kernels' route."""
    s = x.shape[1]
    q, k, v = attn_mod._project_qkv(p, cfg, x, attn_mod.sequence_positions(x))
    return _sdpa(q, k, v, causal_mask(s, s) if causal else None,
                 constrain_heads=True) @ p.wo


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype, head_dim", [("float32", 32), ("bfloat16", 64),
                                             ("bfloat16", 128)])
def test_train_self_attention_keeps_sdpa_on_the_cpu(dtype, head_dim, causal, monkeypatch):
    """CPU tensors take ``_SDPA`` (the kernels' route refuses them, whatever
    the dtype and head_dim): output and gradients equal to the ``_sdpa``
    path's; the counters count the calls and no kernel call."""
    def no_kernels(*a, **kw):
        raise AssertionError("the training kernels' route was taken")

    monkeypatch.setattr(attn_mod, "flash_attention_train", no_kernels)
    cfg, p = _layer(TORCH[dtype], "cpu", head_dim)
    x = torch.randn(2, 40, cfg.d_model, generator=torch.Generator().manual_seed(7))
    x = x.to(TORCH[dtype]).requires_grad_()
    leaves = [x, *p.parameters()]
    obs.reset()
    try:
        with torch.profiler.profile(), obs.span("train_step"):
            got = attn_mod.train_self_attention(p, cfg, x, causal=causal)
        counters = obs.snapshot()["counters"]
    finally:
        obs.reset()
    want = _sdpa_route(p, cfg, x, causal)
    assert torch.equal(got, want)
    d_out = torch.randn(got.shape, generator=torch.Generator().manual_seed(8)).to(got.dtype)
    for g, w in zip(torch.autograd.grad(got, leaves, d_out),
                    torch.autograd.grad(want, leaves, d_out)):
        assert torch.equal(g, w)
    assert counters == {"attention.train_calls": {"train_step": 1}}


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_train_self_attention_keeps_sdpa_on_fake_tensors(causal, monkeypatch):
    """Fake tensors (the dry run's ``FakeTensorMode``) take ``_SDPA``,
    forward and backward; the kernels' route refuses a fake CUDA tensor in
    bf16 at head_dim 128 too (this build cannot run autograd on one)."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    taken = []
    monkeypatch.setattr(attn_mod._SDPA, "apply", _recording(attn_mod._SDPA.apply, taken))
    monkeypatch.setattr(attn_mod, "flash_attention_train",
                        lambda *a, **kw: pytest.fail("the training kernels' route was taken"))
    with FakeTensorMode():
        q = torch.empty(2, 40, 4, 128, dtype=torch.bfloat16, device="cuda")
        assert isinstance(q, FakeTensor) and q.is_cuda
        assert not attn_mod._takes_train_kernel(q)
        cfg, p = _layer(torch.bfloat16, "cpu", 128)
        x = torch.empty(2, 40, cfg.d_model, dtype=torch.bfloat16, requires_grad=True)
        out = attn_mod.train_self_attention(p, cfg, x, causal=causal)
        grads = torch.autograd.grad(out.float().sum(), [x, *p.parameters()])
    assert isinstance(out, FakeTensor) and out.shape == x.shape and len(taken) == 1
    assert [g.shape for g in grads] == [x.shape] + [t.shape for t in p.parameters()]


def _recording(fn, calls: list):
    def wrapped(*args, **kwargs):
        calls.append(args)
        return fn(*args, **kwargs)
    return wrapped


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_kernel_route_counts_and_attends_as_sdpa(causal, monkeypatch):
    """With the route's test forced on CPU tensors, ``train_self_attention``
    attends through ``flash_attention_train`` (the plain versions here):
    both counters count the call, the call's forward operations and bytes
    are counted, and output and gradients are close to the ``_sdpa``
    path's."""
    monkeypatch.setattr(attn_mod, "_takes_train_kernel", lambda q: True)
    cfg, p = _layer(torch.float32, "cpu", 32)
    x = torch.randn(2, 40, cfg.d_model, generator=torch.Generator().manual_seed(9),
                    requires_grad=True)
    obs.reset()
    try:
        with torch.profiler.profile(), obs.span("train_step"):
            got = attn_mod.train_self_attention(p, cfg, x, causal=causal)
        counters = obs.snapshot()["counters"]
    finally:
        obs.reset()
    b, s, hd = x.shape[0], x.shape[1], 32
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    flops = 4 * b * nq * s * s * hd // (2 if causal else 1)  # QKᵀ and PV
    nbytes = 4 * b * s * hd * (2 * nq + 2 * nkv)  # q, k, v and the output, f32
    assert counters == {"attention.train_calls": {"train_step": 1},
                        "attention.train_kernel": {"train_step": 1},
                        "attention.train_kernel_flops": {"train_step": flops},
                        "attention.train_kernel_bytes": {"train_step": nbytes}}
    want = _sdpa_route(p, cfg, x, causal)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=1e-5,
                               atol=1e-5)
    leaves = [x, *p.parameters()]
    _grads_close(torch.autograd.grad(got.sum(), leaves), torch.autograd.grad(want.sum(), leaves),
                 GRAD_TOL["float32"])
