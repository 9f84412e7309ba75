"""The selective-scan kernel on the card (``csrc/ssm_scan.cu``) against its
plain version (``models/ssm.py::selective_scan_plain``, the chunked scan);
every test skips without a CUDA card.

This file imports no JAX, so the card's machine, which has none, runs it
alone, without the suite's ``conftest.py`` (which imports the JAX package):

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_ssm_scan_card.py

At one Jamba layer's call of the benchmark's hybrid cell (4 prompts of
32,768 tokens, d_inner 8,192, d_state 16), and at a ragged S with a d_inner
that is not a multiple of the kernel's 128 channels a block (one whose rows
are 16-byte aligned, so copied by cp.async, and one whose rows are not).
"""
from __future__ import annotations

import math

import pytest
import torch

from repro_torch.kernels import _platform
from repro_torch.kernels.ssm_scan import ssm_scan_fwd
from repro_torch.models import ssm

pytestmark = pytest.mark.card

JAMBA = (4, 32768, 8192, 16)  # (B, S, d_inner, d_state) of one Jamba layer's scan
RAGGED = {"aligned": (3, 5 * 32 + 7, 200, 16), "unaligned": (2, 3 * 32 + 5, 100, 16)}
# The final state, channel by channel (the largest error over prompts and
# states over the channel's largest |h|): the kernel's decays come from
# ex2.approx (relative error ~2^-22) where the plain version calls expf,
# and it multiplies a token at a time where the chunked scan takes
# log-depth products; each token's error is carried by the decay, so a
# channel's error grows with its memory (1 / (dt |A|), up to ~1,000
# tokens at dt 1e-3): ~2.4e-4 if every error fell the same way.
STATE_TOL = 1e-3
# y, against its largest element: in float32 the state's error and the
# dot product's order of sums (16 terms); in bfloat16 both versions round
# their float32 sums once, and sums a few ulps apart may round one bf16
# ulp apart (2^-8 of an element, at most of the largest).
Y_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(dev, b, s, d_in, ds, dtype, seed=0):
    """The mixer's scan inputs drawn as the benchmark's Mamba weights make
    them: dt log-uniform in [1e-3, 0.1] before its softplus (its inverse,
    with noise), x silu of a normal, B and C normal, A = -(1 .. d_state)
    with noise, D near 1."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = torch.exp(torch.rand(b, s, d_in, device=dev, generator=g) * math.log(100.0)
                   + math.log(1e-3))
    dt_raw = (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    x = torch.nn.functional.silu(torch.randn(b, s, d_in, device=dev, generator=g)).to(dtype)
    bmat, cmat = (torch.randn(b, s, ds, device=dev, generator=g) for _ in range(2))
    a = -torch.exp(torch.log(torch.arange(1, ds + 1.0, device=dev))
                   + 0.1 * torch.randn(d_in, ds, device=dev, generator=g))
    d = 1.0 + 0.1 * torch.randn(d_in, device=dev, generator=g)
    return dt_raw, bmat, cmat, x, a, d


def _check(got, want, dtype):
    y, h = got
    want_y, want_h = want
    assert y.dtype == dtype and y.shape == want_y.shape and h.shape == want_h.shape
    y_gap = float((y.float() - want_y.float()).abs().max())
    assert y_gap <= Y_TOL[dtype] * float(want_y.float().abs().max()), y_gap
    gap = (h - want_h).abs().amax(dim=(0, 2)) / want_h.abs().amax(dim=(0, 2)).clamp_min(1e-30)
    assert float(gap.max()) <= STATE_TOL, float(gap.max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_kernel_matches_the_plain_version_at_a_jamba_layer(card, dtype):
    args = _inputs(card, *JAMBA, dtype)
    _platform.reset_launches()
    with torch.no_grad():
        got = ssm._selective_scan(*args)  # the serving route: the kernel
        assert _platform.launch_counts()["ssm_scan"] == 1
        want = ssm.selective_scan_plain(*args)
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", list(RAGGED))
def test_the_kernel_matches_the_plain_version_at_ragged_shapes(card, shape, dtype):
    args = _inputs(card, *RAGGED[shape], dtype, seed=1)
    with torch.no_grad():
        got = ssm_scan_fwd(*args)
        want = ssm.selective_scan_plain(*args)
    _check(got, want, dtype)


def test_strided_inputs_are_read_through_their_strides(card):
    """x and dt as slices of wider rows and B, C as views of one (B, S, 2
    d_state) tensor: the batch and sequence strides reach the kernel."""
    b, s, d_in, ds = RAGGED["aligned"]
    dt, bmat, cmat, x, a, d = _inputs(card, b, s, d_in, ds, torch.bfloat16, seed=2)
    wide = torch.cat([x, dt, x], dim=-1)
    bc = torch.cat([bmat, cmat], dim=-1)
    views = (wide[..., d_in:2 * d_in], bc[..., :ds], bc[..., ds:], wide[..., :d_in], a, d)
    with torch.no_grad():
        got = ssm_scan_fwd(*views)
        want = ssm_scan_fwd(dt, bmat, cmat, x, a, d)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_the_wrapper_raises_on_what_the_kernel_does_not_take(card):
    dt, bmat, cmat, x, a, d = _inputs(card, 1, 40, 64, 16, torch.bfloat16)
    with pytest.raises(ValueError, match="d_state"):
        ssm_scan_fwd(dt, bmat[..., :8], cmat[..., :8], x, a[:, :8], d)
    with pytest.raises(ValueError, match="stride"):
        ssm_scan_fwd(dt.transpose(1, 2).contiguous().transpose(1, 2), bmat, cmat, x, a, d)
    with pytest.raises(TypeError):
        ssm_scan_fwd(dt.half(), bmat, cmat, x.half(), a, d)
