"""The port's attention (``repro_torch.kernels.attention``) against the JAX
package's flash-attention kernel in interpret mode.

The same numpy inputs, made from a seed, go through the reference
``repro.kernels.attention.ops.flash_attention(..., interpret=True)`` and
through the port's ``attention_plain`` and CPU ``flash_attention``.
Tolerances are the reference's own (``tests/test_kernels.py``): 2e-5 in
f32, 2e-2 in bf16.  The CUDA kernel itself is held against
``attention_plain`` on the card by ``chip_smoke.py``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention.ops import flash_attention as ref_flash_attention
from repro.models.attention import _sdpa as ref_sdpa
from repro.models.attention import causal_mask as ref_causal_mask
from repro_torch.kernels import _platform
from repro_torch.kernels.attention import attention_plain, flash_attention
from repro_torch.kernels.attention.attention import _check_alignment
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
