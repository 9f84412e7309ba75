"""Graph layout: vertex reordering and interval scaling as first-class,
sweepable performance dimensions (paper abstract: "partitioning schemes").

The predecessor study (arXiv 2010.13619) and ReGraph (arXiv 2203.02676)
show that graph *layout* — the order vertex ids are assigned in and the
granularity/balance of the partitioning derived from them — shifts
accelerator rankings as much as memory-controller choices do.  This module
makes both pluggable:

- **Vertex reordering** (:data:`REORDERS`): a bijective relabeling
  ``perm[old_id] = new_id`` applied to the prepared graph *before*
  partitioning.  ``identity`` (default) keeps the generator's ids;
  ``degree`` sorts vertices by descending out-degree (hub clustering:
  high-degree vertices share intervals); ``random`` is a seeded shuffle
  (destroys the crawl/community id-locality real SNAP orderings have);
  ``bfs`` is a BFS/RCM-style locality order (level order from the
  highest-degree vertex, neighbors in ascending id — tightens interval
  locality).  Accelerators execute on the relabeled graph and results are
  mapped back to original ids (:func:`undo_relabel`), so reference-solver
  comparisons and root selection are unchanged.
- **Interval scaling**: a power-of-two multiplier on each accelerator's
  ``interval_size`` (the scaled BRAM capacity), sweeping partition
  granularity without touching the per-accelerator presets.

Reordering artifacts (permutations, relabeled graphs) are cached in
``repro_torch.core.hostcache.ARTIFACTS`` keyed on the *source* graph's content
fingerprint plus the reorder name, and the relabeled graph carries its own
fingerprint — so every downstream artifact (partition indices, prepared
structures, semantic executions) caches independently per layout.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.hostcache import ARTIFACTS
from repro_torch.graph.structure import Graph

REORDERS = ("identity", "degree", "random", "bfs")


def validate_interval_scale(scale: int) -> None:
    if not isinstance(scale, (int, np.integer)) or isinstance(scale, bool) \
            or scale < 1 or (scale & (scale - 1)):
        raise ValueError(
            f"interval_scale must be a power-of-two integer >= 1, got {scale!r}")


def validate_reorder(reorder: str) -> None:
    if reorder not in REORDERS:
        raise ValueError(
            f"unknown reorder {reorder!r}; available: {', '.join(REORDERS)}")


@dataclasses.dataclass(frozen=True)
class GraphLayout:
    """A (reorder, interval_scale) point of the layout axis.

    Hashable and picklable; ``apply``/``scaled`` are the two effects a
    layout has on a partitioning: relabel the vertex ids, scale the
    interval granularity."""

    reorder: str = "identity"
    interval_scale: int = 1
    seed: int = 0  # only the "random" reorder consumes it

    def __post_init__(self):
        validate_reorder(self.reorder)
        validate_interval_scale(self.interval_scale)

    @property
    def is_identity(self) -> bool:
        return self.reorder == "identity" and self.interval_scale == 1

    def scaled(self, interval_size: int) -> int:
        return interval_size * self.interval_scale

    def apply(self, g: Graph) -> tuple[Graph, np.ndarray | None]:
        """(relabeled graph, permutation); ``(g, None)`` for identity."""
        if self.reorder == "identity":
            return g, None
        return relabel_graph(g, self.reorder, self.seed)


# ---------------------------------------------------------------------------
# reorder permutations
# ---------------------------------------------------------------------------


def _degree_order(g: Graph) -> np.ndarray:
    """Descending out-degree, ties by original id (stable)."""
    return np.argsort(-g.degrees_out, kind="stable")


def _bfs_order(g: Graph) -> np.ndarray:
    """BFS level order over the symmetrised adjacency, seeded at the
    highest-total-degree vertex of each unreached component; within a level
    vertices are taken in ascending original id.  Deterministic, fully
    vectorised frontier expansion (RCM-style locality without the reversal:
    neighbors end up in nearby intervals)."""
    n = g.n
    src = np.concatenate([g.src, g.dst]).astype(np.int64)
    dst = np.concatenate([g.dst, g.src]).astype(np.int64)
    eorder = np.argsort(src, kind="stable")
    adj = dst[eorder]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    indptr = np.cumsum(indptr)

    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    deg = g.degrees_out + g.degrees_in
    seeds = np.argsort(-deg, kind="stable")
    seed_at = 0
    while pos < n:
        while visited[seeds[seed_at]]:
            seed_at += 1
        root = int(seeds[seed_at])
        if deg[root] == 0:
            # only isolated vertices remain: flush them in seed order at
            # once instead of one outer iteration each (r-mat graphs can
            # have tens of thousands)
            rest = seeds[seed_at:][~visited[seeds[seed_at:]]]
            order[pos:] = rest
            break
        visited[root] = True
        order[pos] = root
        pos += 1
        frontier = np.array([root], dtype=np.int64)
        while frontier.size:
            starts = indptr[frontier]
            counts = indptr[frontier + 1] - starts
            total = int(counts.sum())
            if not total:
                break
            excl = np.cumsum(counts) - counts
            idx = np.repeat(starts - excl, counts) + np.arange(total)
            neigh = adj[idx]
            frontier = np.unique(neigh[~visited[neigh]])
            visited[frontier] = True
            order[pos : pos + frontier.size] = frontier
            pos += frontier.size
    return order


def reorder_permutation(g: Graph, reorder: str, seed: int = 0) -> np.ndarray:
    """The bijection ``perm[old_id] = new_id`` for one reorder scheme.

    ``identity`` returns ``arange`` (callers usually short-circuit it).
    The others compute a *visit order* (``order[new_id] = old_id``) and
    invert it; ``random`` draws the permutation directly from a seeded
    generator so it is stable across processes."""
    validate_reorder(reorder)
    n = g.n
    if reorder == "identity":
        return np.arange(n, dtype=np.int64)
    if reorder == "random":
        perm = np.random.default_rng(seed).permutation(n).astype(np.int64)
        return perm
    order = _degree_order(g) if reorder == "degree" else _bfs_order(g)
    perm = np.empty(n, dtype=np.int64)
    perm[order] = np.arange(n, dtype=np.int64)
    return perm


def layout_permutation(g: Graph, reorder: str, seed: int = 0) -> np.ndarray:
    """ARTIFACTS-cached :func:`reorder_permutation` (keyed on the graph's
    content fingerprint, so structurally-equal graphs share the entry)."""
    return ARTIFACTS.get_or_build(
        (g.fingerprint, "layout.perm", reorder, seed),
        lambda: reorder_permutation(g, reorder, seed),
    )


def relabel_graph(g: Graph, reorder: str, seed: int = 0) -> tuple[Graph, np.ndarray]:
    """(relabeled graph, permutation), both ARTIFACTS-cached.  The relabeled
    graph keeps edge positions (and therefore per-edge weights) intact and
    carries its own fingerprint, so downstream partition/semantic caches
    split per layout automatically."""
    perm = layout_permutation(g, reorder, seed)
    gl = ARTIFACTS.get_or_build(
        (g.fingerprint, "layout.graph", reorder, seed),
        lambda: g.renamed(perm.astype(np.int32), name_suffix=f"+{reorder}"),
    )
    return gl, perm


# ---------------------------------------------------------------------------
# inverse mapping (results back to original vertex ids)
# ---------------------------------------------------------------------------


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty(len(perm), dtype=np.int64)
    inv[perm] = np.arange(len(perm), dtype=np.int64)
    return inv


def relabel_values(values: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Carry a per-vertex payload into the renamed id space:
    ``out[perm[old]] = values[old]`` — the exact inverse of
    :func:`undo_relabel`'s gather.  Needed for problems whose initial
    values are vertex-specific (SpMV's x vector, WCC's id labels): the
    relabeled execution must see each vertex's own payload, not the
    payload of whichever vertex now occupies its slot."""
    out = np.empty_like(values)
    out[perm] = values
    return out


def canonical_min_labels(values: np.ndarray) -> np.ndarray:
    """Canonicalise component labels to the min *position* (original vertex
    id) per label group — WCC values ARE vertex ids, so after a relabeling
    the fixed point labels components by min renamed id and must be mapped
    to the reference labelling (min original id per component)."""
    leaders = values.astype(np.int64)
    uniq, comp_of = np.unique(leaders, return_inverse=True)
    min_orig = np.full(len(uniq), np.iinfo(np.int64).max)
    np.minimum.at(min_orig, comp_of, np.arange(len(values)))
    return min_orig[comp_of].astype(np.float32)


def undo_relabel(values: np.ndarray, perm: np.ndarray, problem_name: str) -> np.ndarray:
    """Map a value array indexed by renamed ids back to original ids:
    ``out[old] = values[perm[old]]``; WCC labels are re-canonicalised."""
    out = values[perm]
    if problem_name == "wcc":
        out = canonical_min_labels(out)
    return out


# ---------------------------------------------------------------------------
# partition balance metrics
# ---------------------------------------------------------------------------


def partition_balance(edge_counts, total_slots: int | None = None) -> dict:
    """Summary of how evenly edges spread over partitions: min/max/mean and
    the coefficient of variation of edges per partition, plus the shard
    fill fraction (non-empty / total) when ``total_slots`` is given
    (ForeGraph's q x q shard grid)."""
    counts = np.asarray(edge_counts, dtype=np.int64).ravel()
    if counts.size == 0:
        counts = np.zeros(1, dtype=np.int64)
    mean = float(counts.mean())
    out = dict(
        partitions=int(counts.size),
        edges_min=int(counts.min()),
        edges_max=int(counts.max()),
        edges_mean=round(mean, 3),
        edges_cv=round(float(counts.std() / mean), 4) if mean else 0.0,
    )
    if total_slots is not None:
        out["shard_fill"] = round(float((counts > 0).sum() / max(total_slots, 1)), 4)
    return out
