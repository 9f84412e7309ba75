"""ForeGraph model (Dai et al., FPGA'17) — paper Sect. 3.2.2, Fig. 5.

Edge-centric on interval-shard (GridGraph-style) partitioning with a
compressed edge list (two 16-bit local vertex ids per edge -> 4 bytes/edge;
possible because intervals are limited to 65,536 vertices), immediate update
propagation, p processing elements sharing memory round-robin.

Per iteration: for each source interval i (PE i % p): prefetch interval i's
values sequentially; for each shard (i, j): prefetch destination interval j,
read the shard's edges sequentially, then write the destination interval
back sequentially.  All off-chip requests are sequential; random vertex
value accesses are served on-chip.

Optimizations (paper Sect. 4.5):
- shard skipping:  skip shards whose source interval did not change,
- stride mapping:  rename vertices with a constant stride to balance
  interval degrees,
- edge shuffling:  zip the edge lists of p consecutive destination shards
  into one (padding with null edges) so p PEs stream one merged list —
  alone this *hurts* (padding => more edges read, aggravated by partition
  skew), combined with stride mapping the padding shrinks.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from repro_torch.core import semexec
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
    seq_read,
    seq_write,
)
from repro_torch.graph.layout import partition_balance, relabel_values, undo_relabel
from repro_torch.graph.partition import interval_shard_partition, stride_mapping
from repro_torch.graph.problems import Problem
from repro_torch.graph.structure import Graph

INTERVAL_CAP = 65536  # 16-bit local vertex ids in the compressed edge format

# effective-interval clamps already warned about (one warning per distinct
# (interval_size, interval_scale) pair, not one per execution)
_CLAMP_WARNED: set[tuple[int, int]] = set()


class ForeGraph(Accelerator):
    name = "foregraph"
    default_dram = "foregraph"
    supports_weights = False
    supports_multichannel = False

    def __init__(self, config=None):
        super().__init__(config)
        if self.config.effective_interval > INTERVAL_CAP:
            raise ValueError(
                f"ForeGraph intervals are limited to 65,536 vertices; "
                f"interval_size={self.config.interval_size} x "
                f"interval_scale={self.config.interval_scale} = "
                f"{self.config.effective_interval}")

    def _execute(self, g: Graph, problem: Problem, root: int,
                 init=None, engine="numpy", device=None):
        cfg = self.config
        n_pes = max(cfg.n_pes, 1)
        interval = cfg.effective_interval
        if interval > INTERVAL_CAP:
            # __init__ rejects this; a config swapped in after construction
            # can still reach it — clamp loudly (once per config) instead of
            # silently, and report the interval actually used
            key = (cfg.interval_size, cfg.interval_scale)
            if key not in _CLAMP_WARNED:
                _CLAMP_WARNED.add(key)
                warnings.warn(
                    f"ForeGraph effective interval {interval} exceeds the "
                    f"{INTERVAL_CAP} 16-bit local-id cap; clamping to "
                    f"{INTERVAL_CAP}", UserWarning, stacklevel=2)
            interval = INTERVAL_CAP

        sperm = None
        if cfg.has("stride_mapping"):
            q_est = max(1, -(-g.n // interval))
            sperm = stride_mapping(g.n, q_est)
            g = g.renamed(sperm)
            root = int(sperm[root])

        shards = interval_shard_partition(g, interval)
        q = shards.q
        layout = MemoryLayout()
        layout.alloc("values", g.n * 4)
        # Static shard state, hoisted out of the iteration loop: sizes and
        # the gathered per-shard endpoint arrays (only non-empty shards).
        sizes, shard_edges = ARTIFACTS.get_or_build(
            (g.fingerprint, "foregraph.prep", interval),
            lambda: (
                shards.shard_sizes(),
                {
                    (i, j): shards.shard(i, j)
                    for i in range(q)
                    for j in range(q)
                    if len(shards.shard_edge_idx[i][j])
                },
            ),
        )
        # balance over the q x q shard grid (shards ARE ForeGraph's
        # partitions); shard_fill = fraction of non-empty shards — the
        # id-locality effect behind the paper's ForeGraph numbers
        extras = dict(
            effective_interval=interval,
            balance=partition_balance(sizes.ravel(), total_slots=q * q),
        )
        for i in range(q):
            for j in range(q):
                if sizes[i, j]:
                    layout.alloc(f"sh{i}_{j}", int(sizes[i, j]) * 4)  # 4B compressed edges

        if init is None:
            values = problem.init_values(g, root)
        else:
            # the passed init is in pre-stride id space: carry each
            # vertex's payload through the stride renaming as well
            values = relabel_values(init, sperm) if sperm is not None else init.copy()
        src_deg = g.degrees_out.astype(np.float32) if problem.name == "pr" else None

        shuffle = cfg.has("edge_shuffling") and n_pes > 1
        skip = cfg.has("shard_skipping") and problem.kind == "min"
        dirty = np.ones(q, dtype=bool)
        on_device = engine == "device"
        if on_device:
            dev = semexec.ForeGraphDevice(g, problem, sizes, shard_edges,
                                          interval, q, device)
            values_dev = torch.tensor(values, device=device)
        pt = PhasedTrace()
        stats: list[IterationStats] = []
        iters = 0

        base_const = (1.0 - 0.85) / g.n if problem.name == "pr" else 0.0

        for _ in range(cfg.max_iters):
            iters += 1
            st = IterationStats(partitions_total=q * q)
            any_change = False
            pe_traces: list[list[Trace]] = [[] for _ in range(n_pes)]
            if problem.kind == "acc":
                if on_device:
                    # every shard reads the pre-iteration snapshot: the
                    # whole accumulation is one SpMV on the device
                    values_dev = dev.acc_step(values_dev)
                else:
                    snapshot = values.copy()
                    values = np.full(g.n, base_const, dtype=np.float32)

            for i in range(q):
                if skip and not dirty[i]:
                    st.partitions_skipped += q
                    continue
                dirty[i] = False
                if on_device and problem.kind == "min":
                    # one device step per source interval (three
                    # sequential sub-scatters reproduce the shard-order
                    # Gauss-Seidel); later intervals' skip decisions need
                    # this interval's dirty flags, hence the host sync here
                    values_dev, flags = dev.min_step(values_dev, i)
                    if flags.any():
                        any_change = True
                        dirty |= flags
                pe = i % n_pes
                lo_i, hi_i = shards.interval(i)
                pe_traces[pe].append(
                    seq_read(layout.base("values") + lo_i * 4, (hi_i - lo_i) * 4)
                )
                st.values_read += hi_i - lo_i

                # group destination shards for edge shuffling
                j_groups = (
                    [list(range(jj, min(jj + n_pes, q))) for jj in range(0, q, n_pes)]
                    if shuffle
                    else [[j] for j in range(q)]
                )
                for group in j_groups:
                    group = [j for j in group if sizes[i, j] > 0]
                    if not group:
                        continue
                    pad = max(int(sizes[i, j]) for j in group) if shuffle else 0
                    for j in group:
                        lo_j, hi_j = shards.interval(j)
                        if not on_device:
                            src, dst = shard_edges[(i, j)]
                            # --- semantics (immediate across shards; the
                            # shard only updates destination interval j, so
                            # the accumulation scratch is interval-local) ---
                            sv = (snapshot if problem.kind == "acc" else values)[src]
                            if problem.kind == "min":
                                cand = problem.edge_candidates_np(sv)
                                acc = np.full(hi_j - lo_j, INF, dtype=np.float32)
                                np.minimum.at(acc, dst - lo_j, cand)
                                old = values[lo_j:hi_j]
                                nv = np.minimum(old, acc)
                                changed = (nv < old).nonzero()[0] + lo_j
                                values[lo_j:hi_j] = nv
                                if len(changed):
                                    any_change = True
                                    dirty[np.unique(changed // interval)] = True
                            else:
                                cand = problem.edge_candidates_np(
                                    sv, None,
                                    src_deg[src] if src_deg is not None else None,
                                )
                                acc = np.zeros(hi_j - lo_j, dtype=np.float32)
                                np.add.at(acc, dst - lo_j, cand)
                                scale = 0.85 if problem.name == "pr" else 1.0
                                values[lo_j:hi_j] += np.float32(scale) * acc

                        # --- trace (all sequential) ---
                        n_edges = pad if shuffle else int(sizes[i, j])
                        tr = concat(
                            seq_read(layout.base("values") + lo_j * 4, (hi_j - lo_j) * 4),
                            seq_read(layout.base(f"sh{i}_{j}"), n_edges * 4),
                            seq_write(layout.base("values") + lo_j * 4, (hi_j - lo_j) * 4),
                        )
                        st.values_read += hi_j - lo_j
                        st.values_written += hi_j - lo_j
                        st.edges_read += n_edges
                        pe_traces[pe].append(tr)

            # PEs share the single memory channel round-robin (Sect. 3.2.2);
            # concurrently-streaming PEs -> proportional interleave.
            pe_cat = [concat(*trs) for trs in pe_traces if trs]
            if pe_cat:
                merged = pe_cat[0] if len(pe_cat) == 1 else proportional_interleave(*pe_cat)
                pt.add_phase([merged])
            stats.append(st)
            if problem.single_iteration:
                break
            if problem.kind == "min" and (not any_change or (skip and not dirty.any())):
                break

        if on_device:
            values = values_dev.cpu().numpy()
        if sperm is not None:
            # values are indexed by stride-renamed ids; map back to the
            # pre-stride ids (WCC labels re-canonicalised to min id)
            values = undo_relabel(values, sperm, problem.name)
        return values, iters, pt, stats, extras
