"""HitGraph model (Zhou et al., TPDS'19) — paper Sect. 3.2.3, Fig. 6.

Edge-centric on a horizontally partitioned (by source interval) edge list,
2-phase update propagation, p processing elements — one per memory channel;
partitions are statically assigned to channels.

Per iteration: the controller schedules all k partitions for the *scatter*
phase (produce updates), then all for the *gather* phase (apply updates).

Scatter(partition i): prefetch the partition's n/k source values
sequentially, then read its ~m/k edges sequentially (8B unweighted / 12B
weighted); each edge produces an update routed through the crossbar to the
destination partition's update queue (sequential, cache-line coalesced
writes on the destination partition's channel).

Gather(partition j): prefetch n/k values, read partition j's update queues
sequentially, apply and write back changed values (coalesced, with
locality when edges were sorted by destination).

Optimizations (paper Sect. 4.5): partition skipping; edge sorting by
destination (gather write locality); update combining (updates with equal
destination combined -> u < |V| x p); update filtering (bitmap of
vertices changed last iteration; edges from inactive sources produce no
update).
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
    seq_read,
    seq_write,
)
from repro_torch.graph.layout import partition_balance
from repro_torch.graph.partition import horizontal_partition, interval_routing
from repro_torch.graph.problems import Problem
from repro_torch.graph.structure import Graph


class HitGraph(Accelerator):
    name = "hitgraph"
    default_dram = "hitgraph"
    supports_weights = True
    supports_multichannel = True

    @staticmethod
    def _partition_prep(g: Graph, idx: np.ndarray, k: int, interval_size: int,
                        sort_opt: bool, weighted: bool):
        """Static per-partition state: endpoint arrays (destination-sorted
        when edge sorting is on) and the crossbar routing — a stable
        grouping of the partition's edges by destination interval, computed
        once and reused every iteration."""
        if sort_opt:
            idx = idx[np.argsort(g.dst[idx], kind="stable")]
        src, dst = g.src[idx], g.dst[idx]
        w = g.weights[idx] if weighted else None
        route, jb = interval_routing(dst, k, interval_size)
        return dict(n_edges=len(idx), src=src, dst=dst, w=w, route=route, jb=jb)

    def _execute(self, g: Graph, problem: Problem, root: int,
                 init=None, engine="numpy"):
        cfg = self.config
        p = max(cfg.n_pes, 1)  # PEs == channels
        ivl = cfg.effective_interval
        parts = horizontal_partition(g, ivl, by="src")
        k = parts.k
        extras = dict(
            effective_interval=ivl,
            balance=partition_balance([len(parts.edge_idx[i]) for i in range(k)]),
        )
        weighted = bool(g.weighted and problem.needs_weights)
        edge_bytes = 12 if weighted else 8

        sort_opt = cfg.has("edge_sorting")
        combine_opt = cfg.has("update_combining") and sort_opt
        filter_opt = cfg.has("update_filtering") and problem.kind == "min"
        skip_opt = cfg.has("partition_skipping") and problem.kind == "min"

        prep = ARTIFACTS.get_or_build(
            (g.fingerprint, "hitgraph.prep", ivl, sort_opt, weighted),
            lambda: [self._partition_prep(g, parts.edge_idx[i], k,
                                          ivl, sort_opt, weighted)
                     for i in range(k)],
        )

        # Channel-local layouts; partition i lives on channel i % p.
        layouts = [MemoryLayout() for _ in range(p)]
        for i in range(k):
            ch = i % p
            layouts[ch].alloc(f"vals{i}", (parts.interval(i)[1] - parts.interval(i)[0]) * 4)
            layouts[ch].alloc(f"edges{i}", max(prep[i]["n_edges"], 1) * edge_bytes)
        for j in range(k):
            # update queue for destination partition j (written by all PEs)
            layouts[j % p].alloc(f"upd{j}", max(g.m, 1) * 8)

        values = problem.init_values(g, root) if init is None else init.copy()
        src_deg = g.degrees_out.astype(np.float32) if problem.name == "pr" else None
        active = np.ones(g.n, dtype=bool)  # bitmap: changed last iteration
        dirty = np.ones(k, dtype=bool)
        pt = PhasedTrace()
        stats: list[IterationStats] = []
        iters = 0

        for _ in range(cfg.max_iters):
            iters += 1
            st = IterationStats(partitions_total=k)
            # ---------------- scatter ----------------
            scatter_traces: list[list[Trace]] = [[] for _ in range(p)]
            # update buffers per destination partition: (dst, value)
            upd_dst: list[list[np.ndarray]] = [[] for _ in range(k)]
            upd_val: list[list[np.ndarray]] = [[] for _ in range(k)]

            for i in range(k):
                if skip_opt and not dirty[i]:
                    st.partitions_skipped += 1
                    continue
                ch = i % p
                pi = prep[i]
                src, dst, w = pi["src"], pi["dst"], pi["w"]
                lo, hi = parts.interval(i)

                # Crossbar routing: the static stable grouping by
                # destination interval (``route``/``jb``) is precomputed;
                # with filtering only the kept-edge mask is applied per
                # iteration (order within each interval is preserved, so
                # the routed streams equal a fresh per-iteration sort).
                if filter_opt:
                    keep = active[src]
                    mask_sorted = keep[pi["route"]]
                    routed = pi["route"][mask_sorted]
                    csum = np.concatenate(
                        ([0], np.cumsum(mask_sorted, dtype=np.int64)))
                    jb = csum[pi["jb"]]
                else:
                    routed, jb = pi["route"], pi["jb"]

                src_r, dst_r = src[routed], dst[routed]
                w_r = w[routed] if w is not None else None
                cand = problem.edge_candidates_np(
                    values[src_r], w_r,
                    src_deg[src_r] if src_deg is not None else None)
                # route updates to destination partitions
                for j in range(k):
                    b0, b1 = jb[j], jb[j + 1]
                    if b0 == b1:
                        continue
                    d, v = dst_r[b0:b1], cand[b0:b1]
                    if combine_opt:
                        # combine updates with equal destination
                        # (interval-local scratch: partition j's updates
                        # only touch its own vertex interval)
                        jlo, jhi = parts.interval(j)
                        if problem.kind == "min":
                            acc = np.full(jhi - jlo, INF, dtype=np.float32)
                            np.minimum.at(acc, d - jlo, v)
                        else:
                            acc = np.zeros(jhi - jlo, dtype=np.float32)
                            np.add.at(acc, d - jlo, v)
                        d = np.unique(d)
                        v = acc[d - jlo]
                    upd_dst[j].append(d)
                    upd_val[j].append(v)

                # trace: prefetch -> edges -> update writes (concurrent)
                pre = seq_read(layouts[ch].base(f"vals{i}"), (hi - lo) * 4)
                edges_tr = seq_read(layouts[ch].base(f"edges{i}"), pi["n_edges"] * edge_bytes)
                st.values_read += hi - lo
                st.edges_read += pi["n_edges"]
                scatter_traces[ch].append(concat(pre, edges_tr))

            nupd_arr = np.array(
                [sum(len(a) for a in upd_dst[j]) for j in range(k)],
                dtype=np.int64)
            # update-queue writes happen on the owning channel, sequential
            upd_write_traces: list[list[Trace]] = [[] for _ in range(p)]
            for j in range(k):
                if nupd_arr[j] > 0:
                    nupd = int(nupd_arr[j])
                    st.updates_written += nupd
                    upd_write_traces[j % p].append(
                        seq_write(layouts[j % p].base(f"upd{j}"), nupd * 8)
                    )
            scatter_phase = []
            for ch in range(p):
                rd = concat(*scatter_traces[ch]) if scatter_traces[ch] else Trace.empty()
                wr = concat(*upd_write_traces[ch]) if upd_write_traces[ch] else Trace.empty()
                scatter_phase.append(proportional_interleave(rd, wr))
            pt.add_phase(scatter_phase)

            # ---------------- gather ----------------
            if problem.kind == "acc":
                base_const = (1.0 - 0.85) / g.n if problem.name == "pr" else 0.0
                new_values = np.full(g.n, base_const, dtype=np.float32)
            else:
                new_values = values.copy()
            changed_global = np.zeros(g.n, dtype=bool)
            any_change = False
            gtr: list[list[Trace]] = [[] for _ in range(p)]
            for j in range(k):
                if nupd_arr[j] == 0:
                    continue
                ch = j % p
                lo, hi = parts.interval(j)
                st.updates_read += int(nupd_arr[j])
                d = np.concatenate(upd_dst[j])
                v = np.concatenate(upd_val[j])
                if problem.kind == "min":
                    # interval-local apply: partition j's updates only
                    # touch vertices in [lo, hi)
                    acc = np.full(hi - lo, INF, dtype=np.float32)
                    np.minimum.at(acc, d - lo, v)
                    old = new_values[lo:hi]
                    nv = np.minimum(old, acc)
                    changed = (nv < old).nonzero()[0] + lo
                    new_values[lo:hi] = nv
                    changed_global[changed] = True
                    if len(changed):
                        any_change = True
                else:
                    np.add.at(new_values, d, v if problem.name != "pr" else np.float32(0.85) * v)
                    changed = np.unique(d)

                pre = seq_read(layouts[ch].base(f"vals{j}"), (hi - lo) * 4)
                upd_rd = seq_read(layouts[ch].base(f"upd{j}"), int(nupd_arr[j]) * 8)
                # value writes (filter abstraction): "min" writes the values
                # an update actually lowered, "acc" writes every accumulated
                # destination — both are exactly ``changed``
                writes = random_write(layouts[ch].base(f"vals{j}"), changed - lo, 4)
                st.values_read += hi - lo
                st.values_written += len(changed)
                gtr[ch].append(concat(pre, proportional_interleave(upd_rd, writes)))
            gather_phase = [concat(*trs) if trs else Trace.empty() for trs in gtr]
            pt.add_phase(gather_phase)

            if problem.kind == "acc":
                values = new_values  # damping applied per-update above
                stats.append(st)
                break  # single iteration
            dirty = np.zeros(k, dtype=bool)
            ch_parts = np.unique(changed_global.nonzero()[0] // ivl)
            dirty[ch_parts] = True
            active = changed_global
            values = new_values
            stats.append(st)
            if not any_change:
                break

        return values, iters, pt, stats, extras
