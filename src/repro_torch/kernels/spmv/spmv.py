"""ELL sparse matrix-vector product: the CUDA kernel's wrapper, its plain
PyTorch version, and the host-side ELL layout.

``spmv_ell(idx, w, x)`` returns ``y`` (n_pad,) with
``y[r] = sum over d of w[r, d] * x[idx[r, d]]``, where ``idx == -1`` marks a
padding slot.  On a CUDA tensor it launches the hand-written kernel
``csrc/spmv.cu`` (the port of ``repro/kernels/spmv/spmv.py::spmv_ell_pallas``)
or raises; on a CPU tensor it takes ``spmv_ell_plain``.  Both sum each row
in column order d = 0..D-1 with separate multiply and add roundings, so on
the card they are equal bit for bit.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels._platform import LAUNCHES

BLOCKS_PER_SM = 8  # the grid's cap for each SM of the device

_FN = None


def to_ell(src: np.ndarray, dst: np.ndarray, w: np.ndarray | None, n: int,
           block_rows: int = 256) -> tuple[np.ndarray, np.ndarray]:
    """Host-side COO -> padded ELLPACK (row = dst, columns = its sources in
    edge order): int32 ``idx`` and f32 ``val``, both ``(n_pad, D)`` with
    n_pad a multiple of ``block_rows`` and D the largest in-degree (>= 1).
    Array-equal to ``repro/kernels/spmv/ref.py::to_ell``."""
    order = np.argsort(dst, kind="stable")
    dsts, srcs = dst[order], src[order]
    ws = w[order] if w is not None else np.ones(len(order), dtype=np.float32)
    counts = np.bincount(dsts, minlength=n)
    d = max(int(counts.max()) if len(counts) else 1, 1)
    n_pad = -(-n // block_rows) * block_rows
    idx = np.full((n_pad, d), -1, dtype=np.int32)
    val = np.zeros((n_pad, d), dtype=np.float32)
    starts = np.zeros(n + 1, dtype=np.int64)
    starts[1:] = np.cumsum(counts)
    within = np.arange(len(dsts)) - starts[dsts]
    idx[dsts, within] = srcs
    val[dsts, within] = ws
    return idx, val


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = _build.load("spmv").spmv_ell_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


@functools.lru_cache(maxsize=None)
def max_blocks(device: torch.device) -> int:
    """The kernel's grid cap on ``device``: 8 blocks for each of its SMs
    (tiles past it loop in the block)."""
    return torch.cuda.get_device_properties(device).multi_processor_count * BLOCKS_PER_SM


def _check(idx: torch.Tensor, w: torch.Tensor, x: torch.Tensor) -> None:
    if idx.dim() != 2 or w.shape != idx.shape:
        raise ValueError(f"idx/w must be equal (n_pad, D), got {tuple(idx.shape)} "
                         f"and {tuple(w.shape)}")
    if x.dim() != 1:
        raise ValueError(f"x must be 1-D (n,), got {tuple(x.shape)}")
    for name, t, dtype in (("idx", idx, torch.int32), ("w", w, torch.float32),
                           ("x", x, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def spmv_ell(idx: torch.Tensor, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """ELL SpMV; returns f32 (n_pad,) on x's device.  Every ``idx >= 0``
    must lie in [0, len(x)).  CUDA tensors launch the kernel on the current
    stream (no sync); CPU tensors take the plain version.  Anything else
    raises."""
    _check(idx, w, x)
    if x.device.type == "cpu":
        return spmv_ell_plain(idx, w, x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    for name, t in (("idx", idx), ("w", w)):
        if t.data_ptr() % 16:  # the kernel reads a tile's rows 16 bytes at a time
            raise ValueError(f"{name} must start on a 16-byte boundary")
    rows, d = idx.shape
    y = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows == 0:
        return y
    args = (idx.data_ptr(), w.data_ptr(), x.data_ptr(), y.data_ptr(), rows, d,
            max_blocks(x.device), torch.cuda.current_stream(x.device).cuda_stream)
    with torch.cuda.device(x.device):
        err = _kernel_fn()(*args)
    if err != 0:
        raise RuntimeError(f"spmv kernel launch failed: CUDA error {err}")
    LAUNCHES["spmv"] += 1
    return y


def spmv_ell_plain(idx: torch.Tensor, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch, in the kernel's order: one
    column at a time, ``y = y + w[:, d] * x[idx[:, d]]`` with padding
    slots gathering 0."""
    y = torch.zeros(idx.shape[0], dtype=torch.float32, device=x.device)
    for d in range(idx.shape[1]):
        col = idx[:, d]
        g = torch.where(col >= 0, x[col.clamp_min(0).long()], 0.0)
        y = y + w[:, d] * g
    return y


def spmv_coo_plain(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                   x: torch.Tensor, n: int) -> torch.Tensor:
    """COO SpMV, ``y[dst] += w * x[src]``, by ``index_add_`` (the CPU's
    plain path of ``ops.spmv_edges``; ``repro/kernels/spmv/ref.py::
    spmv_coo_ref``)."""
    y = torch.zeros(n, dtype=torch.float32, device=x.device)
    return y.index_add_(0, dst.long(), w * x[src.long()])
