"""The training attention kernels on the card (``csrc/attention.cu``)
against their plain versions; every test skips without a CUDA card.

This file imports no JAX, so the card's machine, which has none, runs it
alone, without the suite's ``conftest.py`` (which imports the JAX package):

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_attention_card.py

At the training calls of the benchmark's cells: qwen3 (4, 4,096, 16/8 heads,
hd 128, causal), the MoE (4, 1,024, 16/16, 128, causal) and whisper's
encoder (2, 1,500, 12/12, 64, non-causal, a ragged last tile).
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import _platform
from repro_torch.kernels.attention import attention as A

pytestmark = pytest.mark.card

SHAPES = {"qwen3": (4, 4096, 16, 8, 128, True), "moe": (4, 1024, 16, 16, 128, True),
          "whisper": (2, 1500, 12, 12, 64, False)}
# The log-sum-exp: attention_plain's einsum rounds the scores to bf16 (it
# runs in q's dtype) where the kernel keeps them in f32, half a bf16 ulp of
# |q.k| / sqrt(hd): at most ~0.011 at these inputs (the card read 0.0069).
LSE_ATOL = 2e-2
# Output and gradients: the kernels round P and dS to bf16 before their
# products and write bf16, where the plain versions compute in f32 and
# round once; against the largest element of each tensor (the norm-wise
# gap reads ~3e-3 at these shapes).
BF16_TOL = 2e-2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(dev, b, s, nq, nkv, hd, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(b, s, n, hd, device=dev, generator=g).to(torch.bfloat16)
               for n in (nq, nkv, nkv))
    d_out = torch.randn(b, s, nq, hd, device=dev, generator=g).to(torch.bfloat16)
    return q, k, v, d_out


def _close(got, want, tol):
    got, want = got.float(), want.float()
    assert got.shape == want.shape
    gap = float((got - want).abs().max())
    assert gap <= tol * float(want.abs().max()), gap


@pytest.mark.parametrize("name", list(SHAPES))
def test_forward_and_lse_match_the_plain_version(card, name):
    *shape, causal = SHAPES[name]
    q, k, v, _ = _inputs(card, *shape)
    out, lse = A._launch_lse(q, k, v, causal)
    assert torch.equal(out, A.attention_fwd(q, k, v, causal=causal))  # the serving launch
    want_out, want_lse = A.attention_lse_plain(q, k, v, causal=causal)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=LSE_ATOL)
    _close(out, want_out, BF16_TOL)


@pytest.mark.parametrize("name", list(SHAPES))
def test_backward_matches_the_plain_version_and_repeats_bit_for_bit(card, name):
    *shape, causal = SHAPES[name]
    q, k, v, d_out = _inputs(card, *shape, seed=1)
    out, lse = A._launch_lse(q, k, v, causal)
    _platform.reset_launches()
    got = A._launch_bwd(d_out, q, k, v, out, lse, causal)
    again = A._launch_bwd(d_out, q, k, v, out, lse, causal)
    assert _platform.launch_counts()["attention_bwd"] == 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # the plain backward from the plain forward, so that a wrong log-sum-exp
    # or output of the kernel shows here too
    want = A.attention_bwd_plain(d_out, q, k, v, *A.attention_lse_plain(q, k, v, causal=causal),
                                 causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        _close(g, w, BF16_TOL)


def test_attention_train_launches_the_kernels(card):
    q, k, v, d_out = _inputs(card, 2, 300, 4, 2, 128, seed=2)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    _platform.reset_launches()
    out = A.attention_train(q, k, v, causal=True)
    grads = torch.autograd.grad(out, (q, k, v), d_out)
    counts = _platform.launch_counts()
    assert counts["attention"] == 1 and counts["attention_bwd"] == 1
    o, lse = A.attention_lse_plain(q, k, v, causal=True)
    for g, w in zip(grads, A.attention_bwd_plain(d_out, q, k, v, o, lse, causal=True)):
        _close(g, w, BF16_TOL)
