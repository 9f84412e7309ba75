"""ThunderGP model (Chen et al., FPGA'21) — paper Sect. 3.2.4, Fig. 7.

Edge-centric on a vertically partitioned (by destination interval), sorted
edge list, 2-phase update propagation.  The graph is partitioned into k
destination intervals; each partition is split into p chunks (p = number of
memory channels).  Every channel holds the *whole* vertex value set, its
chunk of each partition, and an update set (memory footprint
n*c + m + n*c — insight 9).

Per iteration, for each partition: a scatter-gather phase per channel
(prefetch the partition's destination values sequentially; read the chunk's
edges sequentially; per edge load its source value — semi-sequential since
edges are sorted by source, with an on-chip buffer filtering duplicate
source reads; finally write the chunk's partial destination values back as
updates), then an apply phase (read all channels' updates sequentially,
combine, and write the result to every channel's value copy — many
duplicate reads and writes; insight 8: sub-linear channel scaling).

Optimization: offline chunk-to-channel scheduling by a greedy execution-time
heuristic (paper: little effect).  Zero-degree vertex removal is disabled,
as in the paper.
"""
from __future__ import annotations

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
    random_read,
    seq_read,
    seq_write,
)
from repro_torch.graph.layout import partition_balance
from repro_torch.graph.partition import vertical_partition
from repro_torch.graph.problems import Problem
from repro_torch.graph.structure import Graph


class ThunderGP(Accelerator):
    name = "thundergp"
    default_dram = "thundergp"
    supports_weights = True
    supports_multichannel = True

    def _execute(self, g: Graph, problem: Problem, root: int,
                 init=None, engine="numpy", device=None):
        cfg = self.config
        p = max(cfg.n_pes, 1)  # channels
        ivl = cfg.effective_interval
        parts = vertical_partition(g, ivl, n_chunks=p)
        k = parts.k
        extras = dict(
            effective_interval=ivl,
            balance=partition_balance(
                [sum(len(parts.edge_idx[i][c]) for c in range(p)) for i in range(k)]),
        )
        weighted = bool(g.weighted and problem.needs_weights)
        edge_bytes = 12 if weighted else 8

        # Static per-(partition, chunk) state, hoisted out of the iteration
        # loop: endpoint arrays and the deduplicated source set (the on-chip
        # vertex buffer's filter), previously recomputed every iteration.
        def chunk_prep(i: int, c: int) -> dict:
            idx = parts.edge_idx[i][c]
            src = g.src[idx]
            return dict(
                n_edges=len(idx), src=src, dst=g.dst[idx],
                w=g.weights[idx] if weighted else None,
                usrc=np.unique(src),
            )

        prep = ARTIFACTS.get_or_build(
            (g.fingerprint, "thundergp.prep", ivl, p, weighted),
            lambda: [[chunk_prep(i, c) for c in range(p)] for i in range(k)],
        )

        # Optional offline chunk scheduling: reassign chunks to channels by
        # greedy longest-processing-time balancing of edge counts.
        chunk_of = [[c for c in range(p)] for _ in range(k)]
        if cfg.has("chunk_scheduling") and p > 1:
            for i in range(k):
                sizes = [(prep[i][c]["n_edges"], c) for c in range(p)]
                sizes.sort(reverse=True)
                loads = [0] * p
                assign = [0] * p
                for sz, c in sizes:
                    tgt = int(np.argmin(loads))
                    loads[tgt] += sz
                    assign[c] = tgt
                chunk_of[i] = assign

        layouts = [MemoryLayout() for _ in range(p)]
        for ch in range(p):
            layouts[ch].alloc("values", g.n * 4)  # full copy per channel
            for i in range(k):
                layouts[ch].alloc(f"edges{i}", max(prep[i][0]["n_edges"], 1) * edge_bytes)
                lo, hi = parts.interval(i)
                layouts[ch].alloc(f"upd{i}", (hi - lo) * 4)

        values = problem.init_values(g, root) if init is None else init.copy()
        src_deg = g.degrees_out.astype(np.float32) if problem.name == "pr" else None
        # ThunderGP's request streams are fully static: every iteration
        # re-reads the same prefetch/edge/source/update regions.  Build each
        # chunk's scatter-gather and apply traces once; the timing engine
        # then simulates each unique stream once per memory config.
        sg_static, apply_static = [], []
        for i in range(k):
            lo, hi = parts.interval(i)
            ni = hi - lo
            sg_row, ap_row = [], []
            for c in range(p):
                pc = prep[i][c]
                ch = chunk_of[i][c]
                pre = seq_read(layouts[ch].base("values") + lo * 4, ni * 4)
                edges_tr = seq_read(layouts[ch].base(f"edges{i}"),
                                    pc["n_edges"] * edge_bytes)
                src_rd = random_read(layouts[ch].base("values"), pc["usrc"], 4)
                upd_wr = seq_write(layouts[ch].base(f"upd{i}"), ni * 4)
                sg_row.append(concat(
                    pre, proportional_interleave(edges_tr, src_rd), upd_wr))
                ap_row.append(concat(
                    seq_read(layouts[c].base(f"upd{i}"), ni * 4),
                    seq_write(layouts[c].base("values") + lo * 4, ni * 4),
                ))
            sg_static.append(sg_row)
            apply_static.append(ap_row)
        pt = PhasedTrace()
        stats: list[IterationStats] = []
        on_device = engine == "device"
        if on_device:
            dev = semexec.ThunderGPDevice(g, problem, prep, k, p, ivl,
                                          weighted, device)
            values_dev = torch.tensor(values, device=device)
        iters = 0

        for _ in range(cfg.max_iters):
            iters += 1
            st = IterationStats(partitions_total=k)
            any_change = False
            if on_device:
                # ThunderGP's iteration is synchronous (Jacobi) with
                # disjoint destination intervals, so the whole iteration —
                # every partition's chunk partials plus the apply combine —
                # is ONE device step (one scatter-min) before the trace loop.
                if problem.kind == "min":
                    values_dev, any_change = dev.min_step(values_dev)
                else:
                    values_dev = dev.acc_step(values_dev)
            elif problem.kind == "acc":
                base_const = (1.0 - 0.85) / g.n if problem.name == "pr" else 0.0
                new_values = np.full(g.n, base_const, dtype=np.float32)
            else:
                new_values = values.copy()

            for i in range(k):
                lo, hi = parts.interval(i)
                ni = hi - lo
                # ---- scatter-gather per channel (parallel) ----
                sg_phase: list[Trace] = [Trace.empty() for _ in range(p)]
                partials = []
                for c in range(p):
                    pc = prep[i][c]
                    ch = chunk_of[i][c]

                    if not on_device:
                        # semantics: chunk partial accumulation over dst
                        # interval
                        src, dst, w = pc["src"], pc["dst"], pc["w"]
                        cand = problem.edge_candidates_np(
                            values[src], w,
                            src_deg[src] if src_deg is not None else None,
                        )
                        if problem.kind == "min":
                            acc = np.full(ni, INF, dtype=np.float32)
                            np.minimum.at(acc, dst - lo, cand)
                        else:
                            acc = np.zeros(ni, dtype=np.float32)
                            np.add.at(acc, dst - lo, cand)
                        partials.append(acc)

                    # trace: prefetch dst values; edges; semi-sequential
                    # source value loads (sorted by src, duplicates filtered
                    # by the vertex value buffer); update writes — all
                    # static, prebuilt above
                    st.values_read += ni + len(pc["usrc"])
                    st.edges_read += pc["n_edges"]
                    st.updates_written += ni
                    sg_phase[ch] = sg_static[i][c]
                pt.add_phase(sg_phase)

                # ---- apply (combine chunk partials, write to all copies) ----
                if not on_device:
                    if problem.kind == "min":
                        comb = np.minimum.reduce(partials) if partials else np.full(ni, INF)
                        nv = np.minimum(new_values[lo:hi], comb)
                        changed = nv < new_values[lo:hi]
                        new_values[lo:hi] = nv
                        if changed.any():
                            any_change = True
                    else:
                        comb = np.sum(partials, axis=0)
                        scale = 0.85 if problem.name == "pr" else 1.0
                        new_values[lo:hi] += np.float32(scale) * comb

                apply_phase: list[Trace] = []
                for c in range(p):
                    st.updates_read += ni
                    st.values_written += ni
                    apply_phase.append(apply_static[i][c])
                pt.add_phase(apply_phase)

            if not on_device:
                values = new_values
            stats.append(st)
            if problem.single_iteration:
                break
            if problem.kind == "min" and not any_change:
                break

        if on_device:
            values = values_dev.cpu().numpy()
        return values, iters, pt, stats, extras
