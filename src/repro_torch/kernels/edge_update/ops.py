"""Public ops: min-propagation scatter over edges.

``scatter_min`` is the tensor-level primitive the ``semexec="device"``
engine calls in its per-iteration steps; ``relax_step`` is the Graph-level
convenience wrapper.  Both reach ``edge_update``: the CUDA kernel on a CUDA
tensor, its plain version on a CPU tensor.  Unlike the reference's Pallas
path there is no vertex cap and no edge-block multiple: the kernel takes
any m and n.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.graph.structure import Graph
from repro_torch.kernels._platform import resolve_device
from repro_torch.kernels.edge_update.edge_update import edge_update


def scatter_min(
    src: torch.Tensor,  # (m,) int32, -1 marks masked/padding edges
    dst: torch.Tensor,  # (m,) int32; < 0 is vertex 0, >= n drops the edge
    delta: torch.Tensor,  # (m,) values.dtype
    values: torch.Tensor,  # (n,)
    *,
    mask: torch.Tensor | None = None,  # (m,) bool, False drops the edge
) -> torch.Tensor:
    """acc[d] = min over edges of values[src] + delta; returns acc (n,).

    Empty segments hold the dtype's sentinel max (+inf for floats)."""
    if mask is not None:
        src = torch.where(mask, src, -1)
    return edge_update(src, dst, delta, values)


def relax_step(g: Graph, values: np.ndarray, problem: str = "bfs", *,
               device=None) -> np.ndarray:
    """new_values = min(values, segment_min_dst(values[src] + delta)), on
    ``device`` (``None``: the CUDA card)."""
    dev = resolve_device(device)
    if problem == "bfs":
        delta = np.ones(g.m, dtype=values.dtype)
    elif problem == "wcc":
        delta = np.zeros(g.m, dtype=values.dtype)
    elif problem == "sssp":
        if g.weights is None:
            raise ValueError("sssp needs a weighted graph")
        delta = g.weights.astype(values.dtype)
    else:
        raise ValueError(problem)
    v = torch.tensor(values, device=dev)
    acc = scatter_min(torch.tensor(g.src, device=dev), torch.tensor(g.dst, device=dev),
                      torch.tensor(delta, device=dev), v)
    return torch.minimum(v, acc).cpu().numpy()
