"""The five graph problems of the paper (BFS, PR, WCC, SSSP, SpMV) in PyTorch.

Each problem is described declaratively so that the accelerator models can
execute it under *their own* iteration/propagation scheme while this module
also provides a PyTorch reference solver (synchronous / Jacobi iterations,
matching the 2-phase update propagation semantics) used as the correctness
oracle.

Problem taxonomy (paper Sect. 4.1):
- "min" problems (BFS, WCC, SSSP): monotone min-propagation; tolerate
  immediate (asynchronous / Gauss-Seidel) update propagation, which is why
  AccuGraph and ForeGraph converge in fewer iterations (insight 1).
- "acc" problems (PR, SpMV): per-iteration accumulation into a fresh value
  array; a single iteration is benchmarked in the paper.
"""
from __future__ import annotations

import dataclasses
import numpy as np
import torch

from repro_torch.graph.structure import Graph
from repro_torch.kernels._platform import resolve_device

DAMPING = 0.85


@dataclasses.dataclass(frozen=True)
class Problem:
    name: str
    kind: str  # "min" | "acc"
    needs_weights: bool = False
    single_iteration: bool = False
    symmetrise: bool = False  # WCC treats edges as undirected
    needs_root: bool = False

    def init_values(self, g: Graph, root: int = 0) -> np.ndarray:
        n = g.n
        if self.name in ("bfs", "sssp"):
            v = np.full(n, np.inf, dtype=np.float32)
            v[root] = 0.0
            return v
        if self.name == "wcc":
            return np.arange(n, dtype=np.float32)
        if self.name == "pr":
            return np.full(n, 1.0 / n, dtype=np.float32)
        if self.name == "spmv":
            # x vector: deterministic pseudo-random input
            rng = np.random.default_rng(42)
            return rng.random(n).astype(np.float32)
        raise ValueError(self.name)

    def edge_candidates(
        self,
        src_vals: torch.Tensor,
        weights: torch.Tensor | None,
        src_deg: torch.Tensor | None,
    ) -> torch.Tensor:
        """Candidate contribution of each edge, given its source value."""
        if self.name == "bfs":
            return src_vals + 1.0
        if self.name == "wcc":
            return src_vals
        if self.name == "sssp":
            return src_vals + weights
        if self.name == "pr":
            return src_vals / torch.clamp_min(src_deg, 1.0)
        if self.name == "spmv":
            w = weights if weights is not None else 1.0
            return src_vals * w
        raise ValueError(self.name)

    def edge_candidates_np(
        self,
        src_vals: np.ndarray,
        weights: np.ndarray | None = None,
        src_deg: np.ndarray | None = None,
    ) -> np.ndarray:
        """numpy twin of ``edge_candidates`` for the host-side accelerator
        models (trace generation runs in numpy, the oracle in torch)."""
        if self.name == "bfs":
            return src_vals + np.float32(1.0)
        if self.name == "wcc":
            return src_vals
        if self.name == "sssp":
            return src_vals + weights
        if self.name == "pr":
            return src_vals / np.maximum(src_deg, 1.0).astype(np.float32)
        if self.name == "spmv":
            w = weights if weights is not None else np.float32(1.0)
            return src_vals * w
        raise ValueError(self.name)

    def accumulate_np(self, cand: np.ndarray, dst: np.ndarray, n: int) -> np.ndarray:
        """numpy twin of ``accumulate``: scatter-combine candidates by dst."""
        if self.kind == "min":
            acc = np.full(n, np.inf, dtype=np.float32)
            np.minimum.at(acc, dst, cand)
        else:
            acc = np.zeros(n, dtype=np.float32)
            np.add.at(acc, dst, cand)
        return acc

    def combine(self, acc: torch.Tensor, old: torch.Tensor, n: int) -> torch.Tensor:
        """Combine accumulated contributions with the previous values."""
        if self.kind == "min":
            return torch.minimum(old, acc)
        if self.name == "pr":
            return (1.0 - DAMPING) / n + DAMPING * acc
        return acc  # spmv

    def accumulate(self, cand: torch.Tensor, dst: torch.Tensor, num_segments: int) -> torch.Tensor:
        """Scatter-combine candidates by destination (``dst`` int64):
        ``amin`` for min problems (empty segments hold +inf), ``sum`` for
        acc problems (empty segments hold 0)."""
        if self.kind == "min":
            acc = torch.full((num_segments,), float("inf"), dtype=cand.dtype,
                             device=cand.device)
            return acc.scatter_reduce(0, dst, cand, reduce="amin")
        acc = torch.zeros(num_segments, dtype=cand.dtype, device=cand.device)
        return acc.scatter_reduce(0, dst, cand, reduce="sum")

    @property
    def acc_identity(self) -> float:
        return float("inf") if self.kind == "min" else 0.0

    def prepare_graph(self, g: Graph) -> Graph:
        if self.symmetrise:
            from repro_torch.graph.structure import from_edges

            edges = np.stack([g.src, g.dst], axis=1)
            return from_edges(g.n, edges, directed=False, name=g.name + "~sym")
        if self.needs_weights:
            return g.with_weights()
        return g


BFS = Problem("bfs", "min", needs_root=True)
WCC = Problem("wcc", "min", symmetrise=True)
SSSP = Problem("sssp", "min", needs_weights=True, needs_root=True)
PR = Problem("pr", "acc", single_iteration=True)
SPMV = Problem("spmv", "acc", needs_weights=True, single_iteration=True)

PROBLEMS: dict[str, Problem] = {p.name: p for p in (BFS, WCC, SSSP, PR, SPMV)}


def _iterate(problem: Problem, n: int, values, src, dst, weights, src_deg):
    cand = problem.edge_candidates(values[src], weights, src_deg[src] if src_deg is not None else None)
    acc = problem.accumulate(cand, dst, num_segments=n)
    if problem.kind == "min":
        acc = torch.where(torch.isfinite(acc), acc, problem.acc_identity)
    return problem.combine(acc, values, n)


def reference_solve(
    g: Graph, problem: Problem, root: int = 0, max_iters: int = 10_000,
    device=None,
) -> tuple[np.ndarray, int]:
    """Synchronous (Jacobi) fixed-point solve; returns (values, iterations).

    This is the semantics oracle for all four accelerator models: min
    problems must reach the same fixed point regardless of propagation
    scheme; acc problems run exactly one iteration (paper setup).  Runs on
    ``device`` (``None``: the CUDA card, raising when there is none).
    """
    dev = resolve_device(device)
    g = problem.prepare_graph(g)
    values = torch.from_numpy(problem.init_values(g, root)).to(dev)
    src = torch.from_numpy(g.src.astype(np.int64)).to(dev)
    dst = torch.from_numpy(g.dst.astype(np.int64)).to(dev)
    weights = torch.from_numpy(g.weights).to(dev) if g.weights is not None else None
    src_deg = (torch.from_numpy(g.degrees_out.astype(np.float32)).to(dev)
               if problem.name == "pr" else None)

    if problem.single_iteration:
        out = _iterate(problem, g.n, values, src, dst, weights, src_deg)
        return out.cpu().numpy(), 1

    iters = 0
    for _ in range(max_iters):
        new = _iterate(problem, g.n, values, src, dst, weights, src_deg)
        iters += 1
        if torch.equal(new, values):
            break
        values = new
    return values.cpu().numpy(), iters
