"""Graph generators reproducing the characteristics of the paper's Tab. 2.

The paper benchmarks 12 graphs (10 SNAP real-world graphs + 2 Graph500 R-MAT
graphs).  SNAP downloads are unavailable offline, so we regenerate a *scaled*
suite with matching structural characteristics per graph: directedness,
average degree, degree-distribution skew (power-law for social/web graphs,
near-constant for road networks) and diameter class (road networks and the
bk/rd graphs have large diameters, which drives the iteration-count effects
in the paper).  The scale factor is documented in EXPERIMENTS.md; all
paper-facing claims we validate are scale-free (bytes/edge, relative
iteration counts, ordinal performance relations).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.structure import Graph, from_edges


def rmat(
    scale: int,
    edge_factor: int = 16,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 1,
    name: str | None = None,
    directed: bool = True,
) -> Graph:
    """Graph500-style R-MAT generator (Kronecker).

    n = 2**scale vertices, m = edge_factor * n edges (before dedup).
    """
    n = 1 << scale
    m = edge_factor * n
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    for _level in range(scale):
        coin_ij = rng.random(m)
        coin_kl = rng.random(m)
        # Standard Graph500 sampling: choose quadrant per level.
        ii_bit = coin_ij > ab
        jj_bit = np.where(ii_bit, coin_kl > c_norm, coin_kl > a_norm)
        src = src * 2 + ii_bit
        dst = dst * 2 + jj_bit
    # Permute vertex labels so degree is not correlated with id.
    perm = rng.permutation(n)
    edges = np.stack([perm[src], perm[dst]], axis=1)
    return from_edges(n, edges, directed=directed, name=name or f"rmat{scale}")


def uniform_random(n: int, m: int, seed: int = 2, name: str = "uniform",
                   directed: bool = True) -> Graph:
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, size=(m, 2))
    return from_edges(n, edges, directed=directed, name=name)


def grid_road(side: int, seed: int = 3, name: str = "road",
              diag_frac: float = 0.05) -> Graph:
    """Road-network-like graph: 2D grid (degree ~2-4, huge diameter) with a
    few random diagonal shortcuts — mirrors roadnet-ca's near-constant degree
    distribution and large diameter."""
    n = side * side
    ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    vid = (ii * side + jj).ravel()
    right = vid.reshape(side, side)[:, :-1].ravel()
    down = vid.reshape(side, side)[:-1, :].ravel()
    edges = np.concatenate(
        [
            np.stack([right, right + 1], axis=1),
            np.stack([down, down + side], axis=1),
        ]
    )
    rng = np.random.default_rng(seed)
    n_diag = int(len(edges) * diag_frac)
    extra = rng.integers(0, n, size=(n_diag, 2))
    edges = np.concatenate([edges, extra])
    return from_edges(n, edges, directed=False, name=name)


def small_world(n: int, k: int, beta: float = 0.1, seed: int = 4,
                name: str = "smallworld", directed: bool = False) -> Graph:
    """Watts-Strogatz-like ring lattice with rewiring — moderate diameter,
    low skew (used for the wiki-talk-like moderate graphs is NOT right; this
    models collaboration-network-ish graphs, e.g. dblp)."""
    rng = np.random.default_rng(seed)
    base = np.arange(n)
    edges = []
    for off in range(1, k // 2 + 1):
        dsts = (base + off) % n
        rewire = rng.random(n) < beta
        dsts = np.where(rewire, rng.integers(0, n, size=n), dsts)
        edges.append(np.stack([base, dsts], axis=1))
    return from_edges(n, np.concatenate(edges), directed=directed, name=name)


def community_social(n: int, m: int, seed: int = 6, name: str = "social",
                     directed: bool = True, n_comm: int | None = None,
                     p_intra: float = 0.75, skew: float = 1.6) -> Graph:
    """Social-network generator with *community id-locality*.

    Real SNAP graphs are stored in crawl/community order: most edges stay
    inside blocks of nearby vertex ids, which is what makes interval-shard
    partitioning economical on them (many off-diagonal shards empty/tiny —
    the effect behind ForeGraph's paper numbers).  The first calibration
    pass used pure preferential attachment with uniformly-spread ids; every
    shard was occupied and ForeGraph's interval traffic exploded
    (EXPERIMENTS.md §Validation, calibration iteration 2).

    Vertices split into contiguous-id communities (power-law sizes); a
    fraction ``p_intra`` of edges are intra-community; endpoints follow a
    Zipf-like ``skew`` so degree distributions stay heavy-tailed.
    """
    rng = np.random.default_rng(seed)
    n_comm = n_comm or max(8, int(np.sqrt(n) / 4))
    raw = rng.pareto(1.5, size=n_comm) + 1.0
    sizes = np.maximum((raw / raw.sum() * n).astype(np.int64), 4)
    diff = n - sizes.sum()
    sizes[np.argmax(sizes)] += diff
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])

    def zipf_pick(count, size, local_rng):
        u = local_rng.random(count)
        r = (size ** (u ** skew)).astype(np.int64) - 1
        return np.clip(r, 0, size - 1)

    m_intra = int(m * p_intra)
    w = sizes.astype(np.float64) ** 1.2
    alloc = (w / w.sum() * m_intra).astype(np.int64)
    src_parts, dst_parts = [], []
    for c in range(n_comm):
        cnt = int(alloc[c])
        if cnt == 0:
            continue
        s = starts[c] + zipf_pick(cnt, int(sizes[c]), rng)
        d = starts[c] + rng.integers(0, int(sizes[c]), size=cnt)
        src_parts.append(s)
        dst_parts.append(d)
    m_inter = m - int(alloc.sum())
    src_parts.append(zipf_pick(m_inter, n, rng))  # global heavy-tail sources
    dst_parts.append(rng.integers(0, n, size=m_inter))
    edges = np.stack([np.concatenate(src_parts), np.concatenate(dst_parts)], 1)
    return from_edges(n, edges, directed=directed, name=name)


def preferential(n: int, m_per: int, seed: int = 5, name: str = "pa",
                 directed: bool = True) -> Graph:
    """Barabasi-Albert-style preferential attachment (power-law skew) —
    models the social/web graphs (twitter, live-journal, pokec, youtube)."""
    rng = np.random.default_rng(seed)
    # Vectorised approximate BA: target sampled from previously-placed edge
    # endpoints (repeated-choice trick).
    srcs = np.repeat(np.arange(1, n), m_per)
    targets = np.zeros(len(srcs), dtype=np.int64)
    pool = np.zeros(2 * len(srcs) + 1, dtype=np.int64)
    pool_len = 1  # vertex 0 seeds the pool
    idx = 0
    # Chunked loop for speed: process vertices in blocks, sampling targets
    # from the pool built so far (slight approximation of strict BA).
    block = max(256, n // 64)
    for start in range(1, n, block):
        stop = min(n, start + block)
        cnt = (stop - start) * m_per
        choice = rng.integers(0, max(pool_len, 1), size=cnt)
        tg = pool[choice]
        targets[idx : idx + cnt] = tg
        # append new endpoints to pool
        new_src = srcs[idx : idx + cnt]
        pool[pool_len : pool_len + cnt] = new_src
        pool[pool_len + cnt : pool_len + 2 * cnt] = tg
        pool_len += 2 * cnt
        idx += cnt
    edges = np.stack([srcs, targets], axis=1)
    return from_edges(n, edges, directed=directed, name=name)


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    """Recipe for one entry of the scaled paper suite (Tab. 2 analogue)."""

    name: str
    kind: str  # rmat | uniform | road | smallworld | preferential | community
    n: int
    target_m: int
    directed: bool
    seed: int
    root: int  # BFS/SSSP root (paper specifies roots per graph)

    def canonical(self) -> dict:
        """Canonical identity of the generated graph: every field that
        determines the edge list, in declaration order.  Generators are
        seeded, so equal ``canonical()`` dicts mean byte-identical graphs —
        this is the graph component of the sweep cache key."""
        return dataclasses.asdict(self)

    def build(self) -> Graph:
        if self.kind == "community":
            return community_social(self.n, self.target_m, seed=self.seed,
                                    name=self.name, directed=self.directed)
        if self.kind == "rmat":
            scale = int(np.round(np.log2(self.n)))
            ef = max(1, int(np.ceil(self.target_m / (1 << scale))))
            g = rmat(scale, edge_factor=ef, seed=self.seed, name=self.name,
                     directed=self.directed)
        elif self.kind == "uniform":
            g = uniform_random(self.n, self.target_m, seed=self.seed,
                               name=self.name, directed=self.directed)
        elif self.kind == "road":
            side = int(np.sqrt(self.n))
            g = grid_road(side, seed=self.seed, name=self.name)
        elif self.kind == "smallworld":
            k = max(2, 2 * int(self.target_m / self.n / (2 if not self.directed else 1)))
            g = small_world(self.n, k, seed=self.seed, name=self.name,
                            directed=self.directed)
        elif self.kind == "preferential":
            m_per = max(1, int(self.target_m / self.n / (2 if not self.directed else 1)))
            g = preferential(self.n, m_per, seed=self.seed, name=self.name,
                             directed=self.directed)
        else:
            raise ValueError(self.kind)
        return g


# Scaled stand-ins for Tab. 2 (~1/64 scale on |V|; characteristics preserved).
# Columns: name, generator family, n, target m, directed, seed, root.
# Calibration iteration 2 (EXPERIMENTS.md §Validation): social/web graphs
# use the community generator (crawl-order id locality) — pure preferential
# attachment with uniformly-spread ids occupies every interval shard and
# mis-prices ForeGraph/AccuGraph relative to the paper.
PAPER_GRAPHS: dict[str, GraphSpec] = {
    # twitter-2010: huge, social, skewed, dense-ish (deg 35)
    "tw": GraphSpec("tw", "community", 65536, 2300000, True, 11, 42),
    # soc-LiveJournal: social, deg ~14
    "lj": GraphSpec("lj", "community", 75000, 1070000, True, 12, 77),
    # com-orkut: social, undirected, dense (deg 76)
    "or": GraphSpec("or", "community", 49152, 1830000, False, 13, 3),
    # roadNet-CA: road, deg 2.1, giant diameter
    "rd": GraphSpec("rd", "road", 37636, 79000, False, 14, 5),
    # pokec: social, deg 37
    "pk": GraphSpec("pk", "community", 25000, 478000, True, 15, 9),
    # youtube: social, sparse (deg 5.2), skewed
    "yt": GraphSpec("yt", "community", 19000, 47000, False, 16, 21),
    # dblp: collaboration, sparse, low skew
    "db": GraphSpec("db", "smallworld", 6656, 16000, False, 17, 2),
    # slashdot: small, deg 11.5
    "sd": GraphSpec("sd", "community", 1280, 7400, True, 18, 0),
    # berk-stan web graph: large diameter, deg 2.8 (use road-like + shortcuts)
    "bk": GraphSpec("bk", "road", 31329, 44000, True, 19, 6),
    # wiki-talk: very skewed, deg 11, directed
    "wt": GraphSpec("wt", "community", 10700, 59000, True, 20, 8),
    # rmat scale-21 deg 16 -> scaled rmat
    "r21": GraphSpec("r21", "rmat", 32768, 260000, True, 21, 1),
    # rmat scale-24 deg 16, larger
    "r24": GraphSpec("r24", "rmat", 131072, 1048576, True, 22, 1),
}


def paper_suite(subset: list[str] | None = None) -> dict[str, Graph]:
    """Build (a subset of) the scaled paper graph suite."""
    names = subset or list(PAPER_GRAPHS)
    return {nm: PAPER_GRAPHS[nm].build() for nm in names}
