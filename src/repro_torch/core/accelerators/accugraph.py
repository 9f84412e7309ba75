"""AccuGraph model (Yao et al., PACT'18) — paper Sect. 3.2.1, Fig. 4.

Vertex-centric, pull-based data flow on a horizontally partitioned CSR of
the inverted edges, immediate update propagation.

Partitioning: the vertex set is divided into k source intervals; partition p
holds the in-CSR restricted to edges whose *source* lies in interval p,
indexed by destination (hence the full n+1 pointer array per partition —
paper insight 4).  Per-partition request flow:

  1. prefetch the partition's n/k source-interval values (sequential;
     skipped when the on-chip partition already equals it — k == 1 after
     the first iteration: *prefetch skipping*),
  2. values + pointers of all destination vertices, sequentially, the two
     streams merged round-robin (when k == 1 the destination values are the
     on-chip values, so only pointers are read),
  3. neighbors (CSR indices) sequentially, one edge materialised per
     neighbor,
  4. changed destination values written back (filter abstraction),
streams 2-4 merged by priority -> modelled as proportional interleave.

Immediate propagation: partitions are processed in order within an
iteration and updates are applied to the live value array (Gauss-Seidel),
which converges in fewer iterations for min-propagation problems
(insight 1).  *Partition skipping*: a partition is skipped when none of its
source-interval values changed since it was last processed.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.accelerators.base import (
    Accelerator,
    INF,
    PhasedTrace,
)
from repro_torch.core.hostcache import ARTIFACTS
from repro_torch.core.memory_layout import MemoryLayout
from repro_torch.core.metrics import IterationStats
from repro_torch.core.trace import (
    Trace,
    concat,
    proportional_interleave,
    random_write,
    round_robin,
    seq_read,
)
from repro_torch.graph.layout import partition_balance
from repro_torch.graph.partition import horizontal_partition
from repro_torch.graph.problems import Problem
from repro_torch.graph.structure import Graph


class AccuGraph(Accelerator):
    name = "accugraph"
    default_dram = "accugraph"
    supports_weights = False
    supports_multichannel = False

    @staticmethod
    def _partition_edges(g: Graph, idx: np.ndarray):
        """(src, dst, unique dsts, inverse index) of one partition, in CSR
        (destination-sorted) order."""
        idx = idx[np.argsort(g.dst[idx], kind="stable")]
        dst = g.dst[idx]
        ud, inv = np.unique(dst, return_inverse=True)
        return g.src[idx], dst, ud, inv

    def _execute(self, g: Graph, problem: Problem, root: int,
                 init=None, engine="numpy"):
        cfg = self.config
        ivl = cfg.effective_interval
        parts = horizontal_partition(g, ivl, by="src")
        k = parts.k
        extras = dict(
            effective_interval=ivl,
            balance=partition_balance([len(parts.edge_idx[p]) for p in range(k)]),
        )
        layout = MemoryLayout()
        layout.alloc("values", g.n * 4)
        for p in range(k):
            layout.alloc(f"ptrs{p}", (g.n + 1) * 4)
            layout.alloc(f"neigh{p}", max(len(parts.edge_idx[p]), 1) * 4)

        values = problem.init_values(g, root) if init is None else init.copy()
        src_deg = g.degrees_out.astype(np.float32) if problem.name == "pr" else None
        # Static per-partition structure, hoisted out of the iteration loop:
        # edge endpoints (sorted by destination = CSR order) and the unique
        # destination set + inverse index, so the per-iteration accumulation
        # touches only the vertices this partition can update instead of
        # allocating and scanning O(|V|) scratch per partition.
        part_edges = ARTIFACTS.get_or_build(
            (g.fingerprint, "accugraph.edges", ivl),
            lambda: [self._partition_edges(g, parts.edge_idx[p]) for p in range(k)],
        )

        pt = PhasedTrace()
        stats: list[IterationStats] = []
        dirty = np.ones(k, dtype=bool)  # source-interval changed since last visit
        onchip_partition = -1  # which interval currently resides in BRAM
        skip_part = cfg.has("partition_skipping") and problem.kind == "min"
        skip_pref = cfg.has("prefetch_skipping")
        iters = 0

        if problem.kind == "acc":
            base_const = (1.0 - 0.85) / g.n if problem.name == "pr" else 0.0

        for _ in range(cfg.max_iters):
            iters += 1
            st = IterationStats(partitions_total=k)
            iter_trace: list[Trace] = []
            any_change = False
            if problem.kind == "acc":
                snapshot = values.copy()
                values = np.full(g.n, base_const, dtype=np.float32)

            for p in range(k):
                if skip_part and not dirty[p]:
                    st.partitions_skipped += 1
                    continue
                dirty[p] = False
                src, dst, ud, inv = part_edges[p]
                lo, hi = parts.interval(p)

                # --- semantics (accumulation over the partition's unique
                # destinations only; equivalent to the full-|V| scatter) ---
                if problem.kind == "min":
                    cand = problem.edge_candidates_np(values[src])
                    acc = np.full(len(ud), INF, dtype=np.float32)
                    np.minimum.at(acc, inv, cand)
                    old = values[ud]
                    new = np.minimum(old, acc)
                    wchanged = ud[new < old]
                    values[ud] = new
                    if len(wchanged):
                        any_change = True
                        dirty[np.unique(wchanged // ivl)] = True
                else:
                    cand = problem.edge_candidates_np(
                        snapshot[src], None,
                        src_deg[src] if src_deg is not None else None,
                    )
                    acc = np.zeros(len(ud), dtype=np.float32)
                    np.add.at(acc, inv, cand)
                    scale = 0.85 if problem.name == "pr" else 1.0
                    values[ud] += np.float32(scale) * acc
                    wchanged = ud

                # --- trace ---
                streams = []
                if not (skip_pref and onchip_partition == p):
                    streams.append(seq_read(layout.base("values") + lo * 4, (hi - lo) * 4))
                    st.values_read += hi - lo
                onchip_partition = p
                ptrs = seq_read(layout.base(f"ptrs{p}"), (g.n + 1) * 4)
                if k > 1:
                    dst_vals = seq_read(layout.base("values"), g.n * 4)
                    st.values_read += g.n
                    valptr = round_robin(dst_vals, ptrs)
                else:
                    valptr = ptrs
                neigh = seq_read(layout.base(f"neigh{p}"), len(src) * 4)
                st.edges_read += len(src)
                writes = random_write(layout.base("values"), wchanged, 4)
                st.values_written += len(wchanged)
                body = proportional_interleave(valptr, neigh, writes)
                streams.append(body)
                iter_trace.append(concat(*streams))

            pt.add_phase([concat(*iter_trace)] if iter_trace else [Trace.empty()])
            stats.append(st)
            if problem.single_iteration:
                break
            if problem.kind == "min" and (not any_change or (skip_part and not dirty.any())):
                break

        return values, iters, pt, stats, extras
