"""The training path's recomputing backwards: attention
(``repro_torch.models.attention._SDPA``) and the RMS norm
(``repro_torch.models.layers._RMSNorm``).

``_sdpa`` under autograd runs the same forward ops as without (einsum
scores in f32, the additive mask, softmax, the cast to v's dtype, the
weighted sum) and saves only q, k, v and the mask; its backward recomputes
the probabilities ``Q_CHUNK`` query rows at a time.  Held here, on the CPU:

- the forward is ``torch.equal`` to the plain ops (f32 and bf16, masked and
  not, GQA), as is ``_sdpa`` without autograd;
- the gradients of q, k and v are allclose to autograd through the plain
  ops (``GRAD_TOL`` in f32; bf16 at the attention kernel's 2e-2) and to
  ``jax.grad`` of the reference's ``_sdpa`` in f32, over more than one
  query block;
- no tensor saved for the backward has a (Sq, Sk) layout but the caller's
  mask, and none has the layer's B x heads x Sq x Sk elements
  (``torch.autograd.graph.saved_tensors_hooks``), where the plain ops save
  their logits and probabilities.

``rmsnorm`` under autograd runs its forward ops and saves x, the scale and
the f32 reciprocal RMS; its backward recomputes the normalised rows.  Its
forward is ``torch.equal`` to the plain ops, its gradients are allclose to
autograd through them and to ``jax.grad`` of the reference's ``rmsnorm``,
and it saves no f32 copy of x.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import _sdpa as ref_sdpa
from repro.models.attention import causal_mask as ref_causal_mask
from repro.models.layers import rmsnorm as ref_rmsnorm
from repro_torch.models import attention
from repro_torch.models.attention import _scores, _sdpa, _weigh, causal_mask
from repro_torch.models.layers import rmsnorm

GRAD_TOL = 1e-5  # f32
BF16_TOL = 2e-2  # the attention kernel's bf16 tolerance
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _plain(q, k, v, mask):
    """``_sdpa``'s forward as plain ops, differentiated by autograd."""
    b, sq, nq, hd = q.shape
    logits = _scores(q, k)
    if mask is not None:
        logits = logits + mask[:, :, None, :, :]
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return _weigh(probs, v).reshape(b, sq, nq * hd)


def _inputs(b, sq, sk, nq, nkv, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, n, h, hd)).astype(np.float32)
            for n, h in ((sq, nq), (sk, nkv), (sk, nkv))] + \
        [rng.normal(size=(b, sq, nq * hd)).astype(np.float32)]


def _mask(masked: bool, sq: int, sk: int):
    return causal_mask(sq, sk, sk - sq) if masked else None


CASES = [(2, 24, 24, 4, 2, 16), (1, 40, 56, 6, 3, 8)]  # GQA; Sq < Sk


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_forward_equals_the_plain_ops(case, masked, dtype):
    q, k, v, _ = (torch.from_numpy(a).to(TORCH[dtype]) for a in _inputs(*case, seed=1))
    mask = _mask(masked, case[1], case[2])
    want = _plain(q, k, v, mask)
    assert torch.equal(_sdpa(q, k, v, mask), want)  # no autograd: the plain ops
    got = _sdpa(*(t.clone().requires_grad_() for t in (q, k, v)), mask)
    assert got.grad_fn is not None and torch.equal(got.detach(), want)


def _grads(fn, arrays, mask, dtype, d_out):
    ts = [torch.from_numpy(a).to(TORCH[dtype]).requires_grad_() for a in arrays]
    fn(*ts, mask).backward(torch.from_numpy(d_out).to(TORCH[dtype]))
    return [t.grad.float().numpy() for t in ts]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_gradients_match_autograd_through_the_plain_ops(case, masked, dtype, monkeypatch):
    monkeypatch.setattr(attention, "Q_CHUNK", 16)  # more than one query block, a ragged last
    *arrays, d_out = _inputs(*case, seed=2)
    mask = _mask(masked, case[1], case[2])
    tol = GRAD_TOL if dtype == "float32" else BF16_TOL
    for got, want, name in zip(_grads(_sdpa, arrays, mask, dtype, d_out),
                               _grads(_plain, arrays, mask, dtype, d_out), "qkv"):
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=f"d{name}")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_gradients_match_reference(case, masked, monkeypatch):
    monkeypatch.setattr(attention, "Q_CHUNK", 16)
    *arrays, d_out = _inputs(*case, seed=3)
    sq, sk = case[1], case[2]
    ref_mask = ref_causal_mask(sq, sk, sk - sq) if masked else None
    _, vjp = jax.vjp(lambda q, k, v: ref_sdpa(q, k, v, ref_mask), *map(jnp.asarray, arrays))
    want = vjp(jnp.asarray(d_out))
    got = _grads(_sdpa, arrays, _mask(masked, sq, sk), "float32", d_out)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, np.asarray(w), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"d{name}")


def _saved_shapes(fn, q, k, v, mask) -> list[tuple]:
    saved = []

    def pack(t):
        saved.append((tuple(t.shape), t is mask))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn(q, k, v, mask)
    return saved


@pytest.mark.parametrize("masked", [False, True])
def test_backward_keeps_no_whole_layer_scores(masked):
    b, sq, sk, nq, nkv, hd = 2, 48, 48, 4, 2, 8
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _inputs(b, sq, sk, nq, nkv, hd,
                                                                       seed=4)[:3])
    mask = _mask(masked, sq, sk)

    def scores_like(shape):
        return shape[-2:] == (sq, sk) or np.prod(shape) >= b * nq * sq * sk

    plain = _saved_shapes(_plain, q, k, v, mask)
    assert any(scores_like(s) and not is_mask for s, is_mask in plain)  # the check bites
    saved = _saved_shapes(_sdpa, q, k, v, mask)
    assert saved and not [s for s, is_mask in saved if scores_like(s) and not is_mask], saved


def _plain_rmsnorm(x, scale, eps=1e-6):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * scale.float()).to(x.dtype)


def _norm_inputs(seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=shape) * s + m).astype(np.float32)
            for shape, s, m in (((2, 9, 48), 2.0, 0.5), ((48,), 0.1, 1.0), ((2, 9, 48), 1.0, 0))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_forward_and_gradients_match_the_plain_ops(dtype):
    x, scale, d_out = (torch.from_numpy(a).to(TORCH[dtype]) for a in _norm_inputs(5))
    want = _plain_rmsnorm(x, scale)
    assert torch.equal(rmsnorm(x, scale), want)
    grads = []
    for fn in (rmsnorm, _plain_rmsnorm):
        ts = [t.clone().requires_grad_() for t in (x, scale)]
        out = fn(*ts)
        if fn is rmsnorm:
            assert out.grad_fn is not None and torch.equal(out.detach(), want)
        out.backward(d_out)
        grads.append([t.grad.float().numpy() for t in ts])
    tol = GRAD_TOL if dtype == "float32" else BF16_TOL
    for got, want_g, name in zip(*grads, ("x", "scale")):
        np.testing.assert_allclose(got, want_g, rtol=tol, atol=tol, err_msg=f"d{name}")


def test_rmsnorm_gradients_match_reference():
    x, scale, d_out = _norm_inputs(6)
    _, vjp = jax.vjp(lambda x, s: ref_rmsnorm({"scale": s}, x), jnp.asarray(x),
                     jnp.asarray(scale))
    want = vjp(jnp.asarray(d_out))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, scale)]
    rmsnorm(*ts).backward(torch.from_numpy(d_out))
    for t, w, name in zip(ts, want, ("x", "scale")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"d{name}")


def test_rmsnorm_saves_no_f32_copy_of_x():
    x, scale, _ = (torch.from_numpy(a) for a in _norm_inputs(7))
    x = x.to(torch.bfloat16).requires_grad_()
    scale = scale.to(torch.bfloat16).requires_grad_()

    def saved(fn):
        out = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: out.append((tuple(t.shape), t.dtype)) or t, lambda t: t):
            fn(x, scale)
        return out

    whole = (tuple(x.shape), torch.float32)
    assert whole in saved(_plain_rmsnorm)  # the check bites
    assert whole not in saved(rmsnorm)
