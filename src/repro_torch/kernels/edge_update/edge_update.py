"""Edge-centric min-propagation: the CUDA kernel's wrapper and its plain
PyTorch version.

``edge_update(src, dst, delta, values)`` returns ``acc`` (n,) with
``acc[d] = min over edges (s -> d) of values[s] + delta``.  An edge with
``src < 0`` is skipped, a source at the dtype's sentinel stays at the
sentinel (it adds no delta), and a vertex with no live in-edge holds the
sentinel (``sentinel_max``: +inf for f32, the int32 max for int32).

On a CUDA tensor it launches the hand-written kernel ``csrc/edge_update.cu``
(the port of ``repro/kernels/edge_update/edge_update.py::edge_update_pallas``)
or raises; on a CPU tensor it takes ``edge_update_plain``.  Min is
order-independent, so the two are equal bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._platform import LAUNCHES

# dtype -> the kernel's type code (csrc/edge_update.cu)
DTYPE_CODES = {torch.float32: 0, torch.int32: 1}

_FN = None


def sentinel_max(dtype: torch.dtype):
    """The min-identity of ``dtype``: +inf for floats, the dtype max for
    integers (WCC labels and other integer-valued problems have no inf)."""
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = _build.load("edge_update").edge_update_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 + [
            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(src: torch.Tensor, dst: torch.Tensor, delta: torch.Tensor,
           values: torch.Tensor) -> None:
    if values.dim() != 1:
        raise ValueError(f"values must be 1-D (n,), got {tuple(values.shape)}")
    if values.dtype not in DTYPE_CODES:
        raise TypeError(f"values must be float32 or int32, got {values.dtype}")
    if src.dim() != 1 or dst.shape != src.shape or delta.shape != src.shape:
        raise ValueError(f"src/dst/delta must be equal (m,), got {tuple(src.shape)}, "
                         f"{tuple(dst.shape)} and {tuple(delta.shape)}")
    for name, t, dtype in (("src", src, torch.int32), ("dst", dst, torch.int32),
                           ("delta", delta, values.dtype)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    for name, t in (("src", src), ("dst", dst), ("delta", delta), ("values", values)):
        if t.device != values.device:
            raise ValueError(f"{name} is on {t.device}, values on {values.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def edge_update(src: torch.Tensor, dst: torch.Tensor, delta: torch.Tensor,
                values: torch.Tensor) -> torch.Tensor:
    """Segment-min of ``values[src] + delta`` over ``dst``; returns (n,).

    ``dst`` must lie in [0, n) for every edge with ``src >= 0`` (a skipped
    edge's dst is never read).  CUDA tensors launch the kernel on the current
    stream (no sync); CPU tensors take the plain version.  Anything else
    raises."""
    _check(src, dst, delta, values)
    if values.device.type == "cpu":
        return edge_update_plain(src, dst, delta, values)
    if values.device.type != "cuda":
        raise ValueError(f"unsupported device {values.device}")
    n, m = values.shape[0], src.shape[0]
    out = torch.empty(n, dtype=values.dtype, device=values.device)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(values.device).cuda_stream
    with torch.cuda.device(values.device):
        err = _kernel_fn()(src.data_ptr(), dst.data_ptr(), delta.data_ptr(),
                           values.data_ptr(), out.data_ptr(), m, n,
                           DTYPE_CODES[values.dtype], stream)
    if err != 0:
        raise RuntimeError(f"edge_update kernel launch failed: CUDA error {err}")
    LAUNCHES["edge_update"] += 1
    return out


def edge_update_plain(src: torch.Tensor, dst: torch.Tensor, delta: torch.Tensor,
                      values: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: a gather, then an ``amin``
    scatter into a sentinel-filled output (``repro/kernels/edge_update/
    ref.py::edge_update_ref``)."""
    top = sentinel_max(values.dtype)
    sv = values[src.clamp_min(0).long()]
    # a source at the sentinel is unreached: keep it saturated instead of
    # adding delta (int32 would overflow; float inf absorbs the add anyway)
    valid = (src >= 0) & (sv != top)
    cand = torch.where(valid, sv + delta, top)
    out = torch.full((values.shape[0],), top, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce_(0, dst.clamp_min(0).long(), cand, "amin",
                               include_self=True)
