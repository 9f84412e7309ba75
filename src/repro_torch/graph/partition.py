"""Graph partitioning schemes used by the four accelerators (paper Sect. 3.1).

- Horizontal: vertex set divided into equal intervals; partition i holds the
  *outgoing* edges of interval i (HitGraph; AccuGraph uses the horizontally
  partitioned in-CSR, i.e. intervals over destinations with their incoming
  edges).
- Vertical: intervals over destinations; partition j holds the *incoming*
  edges of interval j (ThunderGP).
- Interval-shard: both at once; shard (i, j) holds edges from interval i to
  interval j (ForeGraph, following GridGraph).

All partitioners are host-side numpy preprocessing, mirroring the paper's
simulation environment where partitioned binaries are prepared offline.
Partition indices are cached per process (``repro_torch.core.hostcache``) keyed on
the graph's content fingerprint and the partitioning parameters, so sweep
scenarios differing only in accelerator or DRAM axes reuse them.

Every partitioner takes an optional :class:`repro_torch.graph.layout.GraphLayout`
which is resolved *before* partitioning: the vertex reorder relabels the
graph (relabeled graphs carry their own fingerprint, so reordered partition
indices cache independently) and ``interval_scale`` multiplies the interval
size.  Accelerator models resolve the layout one level up
(``Accelerator.prepare``) so results can be mapped back to original ids;
the parameter here serves standalone/partitioning-study callers.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.hostcache import ARTIFACTS
from repro_torch.graph.layout import GraphLayout
from repro_torch.graph.structure import Graph


def _resolve_layout(g: Graph, interval_size: int,
                    layout: GraphLayout | None) -> tuple[Graph, int]:
    """Apply a layout's reorder + interval scaling ahead of partitioning."""
    if layout is None:
        return g, interval_size
    g, _ = layout.apply(g)
    return g, layout.scaled(interval_size)


def num_intervals(n: int, interval_size: int) -> int:
    return max(1, math.ceil(n / interval_size))


def interval_routing(keys: np.ndarray, n_buckets: int,
                     interval_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Stable grouping of positions by ``keys // interval_size``.

    Returns ``(order, bounds)``: ``order[bounds[j]:bounds[j+1]]`` are the
    positions whose key falls in interval j, in original order.  This is the
    routing step the accelerators previously re-ran every iteration; it only
    depends on static edge structure, so callers hoist it out of the
    iteration loop (one global argsort, reused every iteration)."""
    bucket = keys // interval_size
    order = np.argsort(bucket, kind="stable")
    bounds = np.searchsorted(bucket[order], np.arange(n_buckets + 1))
    return order, bounds


@dataclasses.dataclass(frozen=True)
class HorizontalPartitions:
    """Partitioned by *source* interval (HitGraph) or by *destination*
    interval over the inverted graph (AccuGraph's in-CSR when by="dst")."""

    graph: Graph
    interval_size: int
    by: str  # "src" or "dst"
    k: int
    # Per partition: edge index arrays into the graph's edge list, sorted.
    edge_idx: list[np.ndarray]

    def interval(self, p: int) -> tuple[int, int]:
        lo = p * self.interval_size
        return lo, min(self.graph.n, lo + self.interval_size)

    def edges(self, p: int) -> tuple[np.ndarray, np.ndarray]:
        idx = self.edge_idx[p]
        return self.graph.src[idx], self.graph.dst[idx]

    def csr_for(self, p: int) -> tuple[np.ndarray, np.ndarray]:
        """Local CSR (by `by` endpoint) for partition p: (indptr, indices).

        For by="dst" this is AccuGraph's in-CSR: indptr over the partition's
        destination vertices, indices = source neighbors."""
        lo, hi = self.interval(p)
        idx = self.edge_idx[p]
        own = self.graph.dst[idx] if self.by == "dst" else self.graph.src[idx]
        other = self.graph.src[idx] if self.by == "dst" else self.graph.dst[idx]
        order = np.argsort(own, kind="stable")
        own, other = own[order], other[order]
        indptr = np.zeros(hi - lo + 1, dtype=np.int64)
        np.add.at(indptr, own - lo + 1, 1)
        return np.cumsum(indptr), other.astype(np.int32)


def horizontal_partition(g: Graph, interval_size: int, by: str = "src",
                         layout: GraphLayout | None = None) -> HorizontalPartitions:
    assert by in ("src", "dst")
    g, interval_size = _resolve_layout(g, interval_size, layout)

    def build() -> HorizontalPartitions:
        k = num_intervals(g.n, interval_size)
        order, bounds = interval_routing(
            g.src if by == "src" else g.dst, k, interval_size)
        edge_idx = [order[bounds[p] : bounds[p + 1]] for p in range(k)]
        return HorizontalPartitions(g, interval_size, by, k, edge_idx)

    return ARTIFACTS.get_or_build(
        (g.fingerprint, "horizontal", interval_size, by), build)


@dataclasses.dataclass(frozen=True)
class VerticalPartitions:
    """Partitioned by *destination* interval; each partition further split
    into p chunks by source range (ThunderGP: chunk per memory channel)."""

    graph: Graph
    interval_size: int
    k: int
    n_chunks: int
    # edge_idx[partition][chunk] -> edge indices
    edge_idx: list[list[np.ndarray]]

    def interval(self, p: int) -> tuple[int, int]:
        lo = p * self.interval_size
        return lo, min(self.graph.n, lo + self.interval_size)

    def edges(self, p: int, c: int) -> tuple[np.ndarray, np.ndarray]:
        idx = self.edge_idx[p][c]
        return self.graph.src[idx], self.graph.dst[idx]


def vertical_partition(g: Graph, interval_size: int, n_chunks: int = 1,
                       layout: GraphLayout | None = None) -> VerticalPartitions:
    g, interval_size = _resolve_layout(g, interval_size, layout)

    def build() -> VerticalPartitions:
        k = num_intervals(g.n, interval_size)
        order, bounds = interval_routing(g.dst, k, interval_size)
        edge_idx: list[list[np.ndarray]] = []
        chunk_size = math.ceil(g.n / n_chunks)
        for p in range(k):
            part = order[bounds[p] : bounds[p + 1]]
            # ThunderGP sorts each partition's edges by source vertex so
            # source value loads are semi-sequential.
            part = part[np.argsort(g.src[part], kind="stable")]
            ckey = g.src[part] // chunk_size
            corder = np.argsort(ckey, kind="stable")
            cbounds = np.searchsorted(ckey[corder], np.arange(n_chunks + 1))
            edge_idx.append(
                [part[corder[cbounds[c] : cbounds[c + 1]]] for c in range(n_chunks)])
        return VerticalPartitions(g, interval_size, k, n_chunks, edge_idx)

    return ARTIFACTS.get_or_build(
        (g.fingerprint, "vertical", interval_size, n_chunks), build)


@dataclasses.dataclass(frozen=True)
class IntervalShards:
    """GridGraph-style 2-level partitioning (ForeGraph).

    shard_edges[i][j] holds edge indices from interval i to interval j.
    ForeGraph stores each shard's edges with 16-bit *local* vertex ids
    (interval size <= 65536), i.e. 4 bytes per edge.
    """

    graph: Graph
    interval_size: int
    q: int  # number of intervals
    shard_edge_idx: list[list[np.ndarray]]

    def interval(self, i: int) -> tuple[int, int]:
        lo = i * self.interval_size
        return lo, min(self.graph.n, lo + self.interval_size)

    def shard(self, i: int, j: int) -> tuple[np.ndarray, np.ndarray]:
        idx = self.shard_edge_idx[i][j]
        return self.graph.src[idx], self.graph.dst[idx]

    def shard_sizes(self) -> np.ndarray:
        return np.array(
            [[len(self.shard_edge_idx[i][j]) for j in range(self.q)] for i in range(self.q)],
            dtype=np.int64,
        )


def interval_shard_partition(g: Graph, interval_size: int,
                             layout: GraphLayout | None = None) -> IntervalShards:
    g, interval_size = _resolve_layout(g, interval_size, layout)
    if interval_size > 65536:
        # checked after layout scaling: a valid base interval times a valid
        # scale can still exceed the 16-bit local-id cap
        raise ValueError(
            f"ForeGraph compressed edges need 16-bit local ids; interval "
            f"{interval_size} exceeds 65,536")

    def build() -> IntervalShards:
        q = num_intervals(g.n, interval_size)
        ikey = g.src // interval_size
        jkey = g.dst // interval_size
        key = ikey * q + jkey
        order = np.argsort(key, kind="stable")
        bounds = np.searchsorted(key[order], np.arange(q * q + 1))
        shard_edge_idx = [
            [order[bounds[i * q + j] : bounds[i * q + j + 1]] for j in range(q)]
            for i in range(q)
        ]
        return IntervalShards(g, interval_size, q, shard_edge_idx)

    return ARTIFACTS.get_or_build(
        (g.fingerprint, "interval_shard", interval_size), build)


def stride_mapping(n: int, q: int) -> np.ndarray:
    """ForeGraph's stride mapping: rename vertices so each interval is the
    set of vertices with a constant stride instead of consecutive ids.

    Vertex v is renamed to its position in the sequence 0, q, 2q, ...,
    1, q+1, ... — i.e. new_id(v) = (v % q) * ceil(n/q) + v // q  (clipped).
    Balances high-degree vertices across intervals.
    """
    iv = math.ceil(n / q)
    v = np.arange(n, dtype=np.int64)
    new = (v % q) * iv + v // q
    # Compact: some slots may exceed n-1 when n % q != 0; re-rank to a dense
    # permutation preserving order.
    rank = np.argsort(np.argsort(new))
    return rank.astype(np.int32)
