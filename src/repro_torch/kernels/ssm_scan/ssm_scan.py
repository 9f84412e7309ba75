"""The fused selective-scan forward: the CUDA kernel's wrapper.

``ssm_scan_fwd(dt, bmat, cmat, x, a, d)`` takes mamba's scan inputs as the
mixer holds them: x (the conv output) and dt before its softplus, (B, S,
d_in) in the model's dtype (bf16 or f32) with the channels contiguous; B
and C (B, S, d_state) f32; A = -exp(A_log) (d_in, d_state) and D (d_in,)
f32.  It returns (y (B, S, d_in) in x's dtype, the final state (B, d_in,
d_state) f32), from a zero state: ``softplus(dt)`` as PyTorch computes it,
the f32 recurrence ``h = exp(dt A) h + dt x B``, ``y = h . C + x D``
rounded once.  The kernel (``csrc/ssm_scan.cu``) replaces no Pallas kernel
(the JAX package runs a ``lax.scan``); its plain version is the chunked
scan behind the same signature, ``models/ssm.py::selective_scan_plain``,
and ``models/ssm.py::_selective_scan`` chooses between them.

A CUDA tensor launches the kernel on the current stream (no sync) or
raises: there is no fallback.  The kernel takes d_state in ``D_STATES``
only.  The library is built at the first launch, so a model without a
Mamba layer never builds or loads it.  Launches count under
``LAUNCHES["ssm_scan"]``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._platform import LAUNCHES

D_STATES = (16,)  # the kernel's template instances: every configuration of the repo
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_BATCH = 65535  # the grid's second dimension
_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = _build.load("ssm_scan").ssm_scan_fwd_launch
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 8 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(dt, bmat, cmat, x, a, d) -> None:
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"x and dt must be equal (B, S, d_in); got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}")
    b, s, d_in = x.shape
    ds = a.shape[-1]
    if a.shape != (d_in, ds) or d.shape != (d_in,):
        raise ValueError(f"A must be (d_in, d_state) and D (d_in,) for d_in {d_in}; got "
                         f"{tuple(a.shape)}, {tuple(d.shape)}")
    for name, t in (("B", bmat), ("C", cmat)):
        if t.shape != (b, s, ds):
            raise ValueError(f"{name} must be (B, S, d_state) = {(b, s, ds)}, "
                             f"got {tuple(t.shape)}")
    if ds not in D_STATES:
        raise ValueError(f"the selective-scan kernel takes d_state in {D_STATES}, not {ds}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"the selective-scan kernel takes x in "
                        f"{[str(t) for t in _DTYPE_CODE]}, not {x.dtype}")
    if dt.dtype != x.dtype:
        raise TypeError(f"dt is {dt.dtype}, x is {x.dtype}")
    for name, t in (("B", bmat), ("C", cmat), ("A", a), ("D", d)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("x", x), ("dt", dt), ("B", bmat), ("C", cmat), ("A", a), ("D", d)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} is on {t.device}; the kernel takes CUDA tensors on "
                             f"one device (the plain version is "
                             f"models/ssm.py::selective_scan_plain)")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s innermost stride is {t.stride(-1)}: the kernel "
                             f"reads along it coalesced and takes only 1")
    if not (a.is_contiguous() and d.is_contiguous()):
        raise ValueError("A and D must be contiguous")
    if b > MAX_BATCH:
        raise ValueError(f"the kernel takes at most {MAX_BATCH} prompts, not {b}")


def ssm_scan_fwd(dt: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor, x: torch.Tensor,
                 a: torch.Tensor, d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(y (B, S, d_in) in x's dtype, final state (B, d_in, d_state) f32)
    of the selective scan from a zero state, by the kernel; raises on what
    it does not take."""
    _check(dt, bmat, cmat, x, a, d)
    b, s, d_in = x.shape
    ds = a.shape[-1]
    y = torch.empty((b, s, d_in), dtype=x.dtype, device=x.device)
    h = torch.empty((b, d_in, ds), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, h.zero_()
    args = (x.data_ptr(), dt.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), a.data_ptr(),
            d.data_ptr(), y.data_ptr(), h.data_ptr(), b, s, d_in, ds, _DTYPE_CODE[x.dtype],
            x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
            bmat.stride(0), bmat.stride(1), cmat.stride(0), cmat.stride(1),
            torch.cuda.current_stream(x.device).cuda_stream)
    with torch.cuda.device(x.device):
        err = _kernel_fn()(*args)
    if err != 0:
        raise RuntimeError(f"selective-scan kernel launch failed: CUDA error {err}")
    LAUNCHES["ssm_scan"] += 1
    return y, h
