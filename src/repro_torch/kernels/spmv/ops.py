"""Public SpMV ops.

``spmv_edges`` is the tensor-level primitive the ``semexec="device"``
engine uses for every accumulate-kind problem (PR contributions, SpMV
itself); ``spmv`` is the Graph-level wrapper.  With an ELL layout
(``to_ell``) both reach ``spmv_ell``: the CUDA kernel on a CUDA tensor,
its plain version on a CPU tensor.  Without one, the COO sum runs, and only
on the CPU: a CUDA call without an ELL layout raises rather than quietly
taking a torch scatter.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.graph.structure import Graph
from repro_torch.kernels._platform import resolve_device
from repro_torch.kernels.spmv.spmv import spmv_coo_plain, spmv_ell, to_ell


def spmv_edges(
    src: torch.Tensor,  # (m,) int32
    dst: torch.Tensor,  # (m,) int32, in [0, n)
    w: torch.Tensor,  # (m,) f32 effective edge weights
    x: torch.Tensor,  # (n,) f32
    n: int,
    *,
    ell: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """y[d] = sum over edges of w * x[src]; returns y (n,).

    ``ell`` is the same matrix as ``(idx, val)`` from ``to_ell``; it is
    required on a CUDA device."""
    if ell is not None:
        idx, val = ell
        return spmv_ell(idx, val, x)[:n]
    if x.device.type != "cpu":
        raise ValueError(f"spmv_edges on {x.device} needs an ELL layout (to_ell); "
                         f"the COO sum is the CPU's plain path only")
    return spmv_coo_plain(src, dst, w, x, n)


def spmv(g: Graph, x: np.ndarray, *, device=None) -> np.ndarray:
    """y = A @ x with A[dst, src] = weight (1.0 if unweighted), on
    ``device`` (``None``: the CUDA card, through the ELL kernel)."""
    dev = resolve_device(device)
    w = g.weights if g.weights is not None else np.ones(g.m, dtype=np.float32)
    ell = None
    if dev.type == "cuda":
        idx, val = to_ell(g.src, g.dst, g.weights, g.n)
        ell = (torch.tensor(idx, device=dev), torch.tensor(val, device=dev))
    y = spmv_edges(torch.tensor(g.src, device=dev), torch.tensor(g.dst, device=dev),
                   torch.tensor(w, device=dev),
                   torch.tensor(x, dtype=torch.float32, device=dev), g.n, ell=ell)
    return y.cpu().numpy()
