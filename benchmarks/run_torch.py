"""Benchmark harness of the PyTorch port: one bench per paper table/figure,
through ``repro_torch.sweep``, plus a kernel micro-bench.

    PYTHONPATH=src python -m benchmarks.run_torch                  # on the card
    PYTHONPATH=src python -m benchmarks.run_torch --device cpu --graphs sd
    PYTHONPATH=src python -m benchmarks.run_torch --benches tab4,fig9 --workers 4

The counterpart of ``benchmarks/run.py`` (the JAX reference's harness):
the same SweepSpecs, CSV names, columns and ``validation.json`` keys, so
the two harnesses' outputs compare line for line.  ``--device`` names the
device the sweeps run on: the CUDA card when it is left out (the run
raises without one), ``cpu`` for the kernels' plain versions.

Benches (paper artifact -> bench):
    tab4      Tab.4 / Fig.8  : DDR4 runtimes, 4 accels x graphs x BFS/PR/WCC
                               + rank-agreement validation against the paper
    tab5      Tab.5          : weighted problems (SSSP, SpMV)
    tab6      Tab.6 / Fig.11 : DDR3 + HBM vs DDR4 (insight 6)
    tab7      Tab.7 / Fig.12 : multi-channel scaling (insights 7, 8, 9)
    tab8      Tab.8 / Fig.13 : per-optimization ablations
    fig9      Fig.9          : critical metrics (iterations, bytes/edge, ...)
    fig10     Fig.10/14      : MREPS by skew / average degree
    kernels   (framework)    : the four CUDA kernels through their ops, each
                               beside its plain version, us_per_call
    roofline  (framework)    : summarise the port's dry-run JSONs
                               (``python -m repro_torch.launch.dryrun``, under
                               results/dryrun_torch) into the roofline CSV

Every paper bench is a thin ``SweepSpec`` executed through
``repro_torch.sweep.run_sweep``: results are content-address cached under
the port's own keys, sweeps parallelise with --workers, and one failing
scenario does not kill the artifact run.

CSV outputs land in --out (default results/bench_torch); a validation
summary is printed and written to validation.json.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np

from repro_torch.configs.graphsim import NONE
from repro_torch.core.dram import dram_config
from repro_torch.sweep import ConfigOverride, SweepSpec, rank, run_sweep, spearman, write_csv

from benchmarks import paper_data as paper

DEFAULT_GRAPHS = ["sd", "db", "yt", "wt", "pk", "rd", "bk", "r21", "lj", "or", "tw", "r24"]


def _write(path: str, rows: list[dict]):
    write_csv(path, rows)
    if rows:
        print(f"  wrote {path} ({len(rows)} rows)")


def _reports(result):
    """(scenario, SimReport, record) triples of the completed scenarios."""
    out = []
    for r in result.results:
        rep = r.report
        if rep is None:
            err = (r.record.get("error") or "").strip()
            print(f"  ERROR {r.scenario.scenario_id}: "
                  f"{err.splitlines()[-1] if err else 'unknown error'}")
            continue
        out.append((r.scenario, rep, r.record))
    return out


# ---------------------------------------------------------------------------


def bench_tab4(graphs, out, validation, sweep):
    spec = SweepSpec(name="tab4", accelerators=tuple(paper.ACCELS),
                     graphs=tuple(graphs), problems=tuple(paper.PROBLEMS_TAB4))
    rows = []
    ours: dict = {}
    for s, rep, rec in _reports(sweep(spec)):
        rows.append(dict(
            graph=s.graph.name, accelerator=s.accelerator, problem=s.problem,
            runtime_s=rep.runtime_s, mteps=rep.mteps,
            iterations=rep.iterations, bytes_per_edge=rep.bytes_per_edge,
            bw_utilization=rep.timing.bw_utilization,
            wall_s=rec.get("wall_s", 0.0),
        ))
        ours.setdefault((s.graph.name, s.problem), {})[s.accelerator] = rep.runtime_s
    _write(os.path.join(out, "tab4_ddr4_runtimes.csv"), rows)

    # validation: accelerator rank agreement vs the paper per (graph, prob)
    corrs, top_match = [], []
    for (gname, prob), vals in ours.items():
        if gname not in paper.TAB4:
            continue
        pvals = {a: paper.TAB4[gname][a][prob] for a in paper.ACCELS}
        corrs.append(spearman(rank(vals), rank(pvals)))
        top_match.append(rank(vals)[0] == rank(pvals)[0])
    validation["tab4_rank_spearman_mean"] = float(np.mean(corrs)) if corrs else None
    validation["tab4_fastest_accel_match_frac"] = (
        float(np.mean(top_match)) if top_match else None
    )

    # insight 1: immediate propagation converges in fewer iterations
    it = {}
    for r in rows:
        if r["problem"] in ("bfs", "wcc"):
            it.setdefault(r["accelerator"], []).append(r["iterations"])
    if all(a in it for a in paper.ACCELS):
        imm = np.mean(it["accugraph"] + it["foregraph"])
        two = np.mean(it["hitgraph"] + it["thundergp"])
        validation["insight1_immediate_fewer_iterations"] = bool(imm < two)
        validation["insight1_iter_ratio"] = float(imm / two)
    # insight 2: CSR / compressed edges -> fewer bytes per edge
    bpe = {}
    for r in rows:
        if r["problem"] == "pr":
            bpe.setdefault(r["accelerator"], []).append(r["bytes_per_edge"])
    if all(a in bpe for a in paper.ACCELS):
        validation["insight2_bytes_per_edge"] = {
            a: float(np.mean(v)) for a, v in bpe.items()
        }
        validation["insight2_csr_fewer_bytes"] = bool(
            np.mean(bpe["accugraph"]) < np.mean(bpe["hitgraph"])
            and np.mean(bpe["foregraph"]) < np.mean(bpe["hitgraph"])
        )


def bench_tab5(graphs, out, validation, sweep):
    spec = SweepSpec(name="tab5", accelerators=("hitgraph", "thundergp"),
                     graphs=tuple(graphs), problems=("sssp", "spmv"))
    rows = [dict(graph=s.graph.name, accelerator=s.accelerator, problem=s.problem,
                 runtime_s=rep.runtime_s, mteps=rep.mteps, iterations=rep.iterations)
            for s, rep, _ in _reports(sweep(spec))]
    _write(os.path.join(out, "tab5_weighted.csv"), rows)
    # paper: weighted runs are slower than unweighted due to 12B edges,
    # otherwise no significant differences
    validation["tab5_ran"] = len(rows)


def bench_tab6(graphs, out, validation, sweep):
    spec = SweepSpec(name="tab6", accelerators=tuple(paper.ACCELS),
                     graphs=tuple(graphs), problems=("bfs",),
                     drams=("default", "ddr3", "hbm"))
    reps = {(s.graph.name, s.accelerator, s.dram.name): rep
            for s, rep, _ in _reports(sweep(spec))}
    rows = []
    speedups = {"ddr3": [], "hbm": []}
    for gname in graphs:
        for accel in paper.ACCELS:
            base_rep = reps.get((gname, accel, "default"))
            if base_rep is None:
                continue
            base = base_rep.runtime_s
            for dram in ("ddr3", "hbm"):
                r = reps.get((gname, accel, dram))
                if r is None:
                    continue
                sp = base / max(r.runtime_s, 1e-12)
                rows.append(dict(graph=gname, accelerator=accel, dram=dram,
                                 runtime_s=r.runtime_s, speedup_over_ddr4=sp,
                                 row_hits=r.timing.hits, row_misses=r.timing.misses,
                                 row_conflicts=r.timing.conflicts,
                                 bw_utilization=r.timing.bw_utilization))
                speedups[dram].append(sp)
    _write(os.path.join(out, "tab6_dram_types.csv"), rows)
    # insight 6: HBM does not outperform (paper: HBM slower than DDR4;
    # DDR3 roughly on par or faster at these access patterns)
    validation["insight6_hbm_mean_speedup"] = float(np.mean(speedups["hbm"]))
    validation["insight6_ddr3_mean_speedup"] = float(np.mean(speedups["ddr3"]))
    validation["insight6_hbm_not_faster"] = bool(np.mean(speedups["hbm"]) <= 1.05)


TAB7_CHANNELS = (("default", (1, 2, 4)), ("ddr3", (1, 2, 4)), ("hbm", (1, 2, 4, 8)))


def bench_tab7(graphs, out, validation, sweep):
    targets = [g for g in ("db", "lj", "or", "rd") if g in graphs] or ["db", "rd"]
    drams = tuple((d, c) for d, chans in TAB7_CHANNELS for c in chans)
    spec = SweepSpec(name="tab7", accelerators=("hitgraph", "thundergp"),
                     graphs=tuple(targets), problems=("bfs",), drams=drams)
    reps = {(s.graph.name, s.accelerator, s.dram.name, s.dram.channels): rep
            for s, rep, _ in _reports(sweep(spec))}
    rows = []
    scaling: dict = {}
    for gname in targets:
        for accel in ("hitgraph", "thundergp"):
            for dram_name, chans in TAB7_CHANNELS:
                base_rep = reps.get((gname, accel, dram_name, chans[0]))
                if base_rep is None:
                    continue  # no 1-channel baseline -> speedups undefined
                base = base_rep.runtime_s
                for c in chans:
                    r = reps.get((gname, accel, dram_name, c))
                    if r is None:
                        continue
                    sp = base / max(r.runtime_s, 1e-12)
                    rows.append(dict(graph=gname, accelerator=accel,
                                     dram=dram_name, channels=c,
                                     runtime_s=r.runtime_s, speedup=sp))
                    scaling.setdefault((accel, dram_name), {}).setdefault(c, []).append(sp)
    _write(os.path.join(out, "tab7_channel_scaling.csv"), rows)
    # insights 7/8: HitGraph scales ~linearly; ThunderGP sub-linearly
    hit4 = np.mean(scaling.get(("hitgraph", "default"), {}).get(4, [1.0]))
    tgp4 = np.mean(scaling.get(("thundergp", "default"), {}).get(4, [1.0]))
    validation["insight7_hitgraph_4ch_speedup"] = float(hit4)
    validation["insight8_thundergp_4ch_speedup"] = float(tgp4)
    validation["insight8_thundergp_sublinear_vs_hitgraph"] = bool(tgp4 < hit4)
    # insight 9: memory footprint n+m+n vs n*c+m+n*c
    validation["insight9_footprint_ratio_4ch"] = "thundergp n*c+m+n*c vs hitgraph n+m+n (structural; see DESIGN.md)"


TAB8_ABLATIONS = {
    "accugraph": [("none", NONE),
                  ("prefetch_skipping", frozenset({"prefetch_skipping"})),
                  ("partition_skipping", frozenset({"partition_skipping"})),
                  ("all", frozenset({"all"}))],
    "foregraph": [("none", NONE),
                  ("edge_shuffling", frozenset({"edge_shuffling"})),
                  ("shard_skipping", frozenset({"shard_skipping"})),
                  ("stride_mapping", frozenset({"stride_mapping"})),
                  ("all", frozenset({"all"}))],
    "hitgraph": [("none", NONE),
                 ("partition_skipping", frozenset({"partition_skipping"})),
                 ("edge_sorting", frozenset({"edge_sorting"})),
                 ("update_combining", frozenset({"edge_sorting", "update_combining"})),
                 ("update_filtering", frozenset({"update_filtering"})),
                 ("all", frozenset({"all"}))],
    "thundergp": [("none", NONE),
                  ("chunk_scheduling", frozenset({"chunk_scheduling"})),
                  ("all", frozenset({"all"}))],
}


def bench_tab8(graphs, out, validation, sweep):
    targets = [g for g in ("db", "lj", "or", "rd") if g in graphs] or ["db", "rd"]
    results: dict = {}
    for accel, opts in TAB8_ABLATIONS.items():
        spec = SweepSpec(
            name=f"tab8-{accel}", accelerators=(accel,), graphs=tuple(targets),
            problems=("bfs",),
            overrides=tuple(ConfigOverride(label=nm, optimizations=opt)
                            for nm, opt in opts),
        )
        for s, rep, _ in _reports(sweep(spec)):
            results[(s.accelerator, s.label, s.graph.name)] = rep.runtime_s
    rows = [dict(graph=gname, accelerator=accel, optimization=opt_name,
                 runtime_s=results[(accel, opt_name, gname)])
            for gname in targets
            for accel, opts in TAB8_ABLATIONS.items()
            for opt_name, _ in opts
            if (accel, opt_name, gname) in results]
    _write(os.path.join(out, "tab8_optimizations.csv"), rows)

    # directional checks from Sect. 4.5 / Fig. 13
    def ratio(accel, opt, gname):
        a = results.get((accel, opt, gname))
        b = results.get((accel, "none", gname))
        return a / b if a and b else None

    shuf = [ratio("foregraph", "edge_shuffling", g) for g in targets]
    shuf = [s for s in shuf if s]
    validation["tab8_edge_shuffling_alone_hurts"] = bool(shuf and np.mean(shuf) > 1.0)
    allv = [ratio(a, "all", g) for a in TAB8_ABLATIONS for g in targets
            if results.get((a, "all", g))]
    allv = [v for v in allv if v]
    validation["tab8_all_opts_helps_mean_ratio"] = float(np.mean(allv)) if allv else None


def bench_fig9(graphs, out, validation, sweep):
    # Same scenarios as tab4's BFS column -> pure cache hits after tab4.
    spec = SweepSpec(name="fig9", accelerators=tuple(paper.ACCELS),
                     graphs=tuple(graphs), problems=("bfs",))
    rows = [dict(graph=s.graph.name, accelerator=s.accelerator,
                 iterations=rep.iterations,
                 bytes_per_edge=rep.bytes_per_edge,
                 values_read_per_iteration=rep.values_read_per_iteration,
                 edges_read_per_iteration=rep.edges_read_per_iteration)
            for s, rep, _ in _reports(sweep(spec))]
    _write(os.path.join(out, "fig9_critical_metrics.csv"), rows)


def bench_fig10(graphs, out, validation, sweep):
    spec = SweepSpec(name="fig10", accelerators=tuple(paper.ACCELS),
                     graphs=tuple(graphs), problems=("bfs",))
    rows = [dict(graph=s.graph.name, accelerator=s.accelerator,
                 skewness=rec["graph_stats"]["degree_skewness"],
                 avg_degree=rec["graph_stats"]["avg_degree"],
                 mreps=rep.mreps, mteps=rep.mteps)
            for s, rep, rec in _reports(sweep(spec))]
    _write(os.path.join(out, "fig10_skewness.csv"), rows)


@contextlib.contextmanager
def _swapped(module, attr: str, fn):
    """``module.attr`` replaced by ``fn`` for the duration of the block."""
    saved = getattr(module, attr)
    setattr(module, attr, fn)
    try:
        yield
    finally:
        setattr(module, attr, saved)


def bench_kernels(graphs, out, validation, sweep, device=None):
    """Micro-bench: name,us_per_call of each CUDA kernel through its op
    (``simulate_trace_batch``, ``relax_step``, ``spmv``,
    ``flash_attention``: host copies and the sync included) and of the
    same op with the kernel's wrapper swapped for its plain version, at the
    reference's micro-bench shapes.  On the card each row is CUDA-event
    time over a run of calls; on the CPU, where both rows take the plain
    version, a host clock.  ``device`` as for the sweeps."""
    import torch

    from repro_torch.core.trace import Trace
    from repro_torch.graph.generators import uniform_random
    from repro_torch.kernels._platform import resolve_device
    from repro_torch.kernels.attention import attention_plain
    from repro_torch.kernels.attention import ops as attention_ops
    from repro_torch.kernels.dram_timing import dram_timing_batch_plain
    from repro_torch.kernels.dram_timing import ops as dram_timing_ops
    from repro_torch.kernels.edge_update import edge_update_plain
    from repro_torch.kernels.edge_update import ops as edge_update_ops
    from repro_torch.kernels.spmv import ops as spmv_ops
    from repro_torch.kernels.spmv import spmv_ell_plain

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    calls = 20 if on_card else 3
    rows = []

    def timeit(name, fn):
        fn()  # build / warm
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            us = start.elapsed_time(end) * 1e3 / calls
        else:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            us = (time.perf_counter() - t0) / calls * 1e6
        rows.append(dict(name=name, us_per_call=round(us, 1)))

    def pair(name, fn, module, attr, plain):
        timeit(f"{name}_{dev.type}", fn)
        with _swapped(module, attr, plain):
            timeit(f"{name}_plain", fn)

    g = uniform_random(512, 4096, seed=0).with_weights()
    x = np.random.default_rng(0).normal(size=g.n).astype(np.float32)
    v0 = np.where(np.arange(g.n) == 0, 0, np.inf).astype(np.float32)
    pair("spmv", lambda: spmv_ops.spmv(g, x, device=dev),
         spmv_ops, "spmv_ell", spmv_ell_plain)
    pair("edge_update", lambda: edge_update_ops.relax_step(g, v0, "bfs", device=dev),
         edge_update_ops, "edge_update", edge_update_plain)
    tr = Trace(np.arange(4096, dtype=np.int64), np.zeros(4096, dtype=bool))
    cfg = dram_config("default")
    pair("dram_timing", lambda: dram_timing_ops.simulate_trace_batch([tr], cfg, device=dev),
         dram_timing_ops, "dram_timing_batch", dram_timing_batch_plain)
    rng = np.random.default_rng(1)
    q = torch.tensor(rng.normal(size=(1, 256, 4, 64)), dtype=torch.float32, device=dev)
    k = torch.tensor(rng.normal(size=(1, 256, 2, 64)), dtype=torch.float32, device=dev)
    vv = torch.tensor(rng.normal(size=(1, 256, 2, 64)), dtype=torch.float32, device=dev)
    pair("flash_attention", lambda: attention_ops.flash_attention(q, k, vv),
         attention_ops, "attention_fwd", attention_plain)
    _write(os.path.join(out, "kernels_microbench.csv"), rows)
    for r in rows:
        print(f"  {r['name']},{r['us_per_call']}")


def bench_roofline(graphs, out, validation, sweep, dryrun_dir="results/dryrun_torch"):
    """Summarise the port's dry-run JSONs (H100 roofline terms per device)
    into roofline_summary.csv, the reference's columns plus the peak."""
    rows = []
    for mesh in ("single", "multi"):
        d = os.path.join(dryrun_dir, mesh)
        if not os.path.isdir(d):
            continue
        for fn in sorted(os.listdir(d)):
            with open(os.path.join(d, fn)) as f:
                rec = json.load(f)
            if rec["status"] != "ok":
                continue
            r, mem = rec["roofline"], rec["memory"]
            rows.append(dict(
                arch=rec["arch"], shape=rec["shape"], mesh=mesh,
                step=rec["step_kind"],
                compute_ms=round(r["compute_s"] * 1e3, 2),
                memory_ms=round(r["memory_s"] * 1e3, 2),
                collective_ms=round(r["collective_s"] * 1e3, 2),
                dominant=r["dominant"],
                useful_flops_ratio=round(rec.get("useful_flops_ratio") or 0, 3),
                temp_gib=round((mem["peak_bytes"] - mem["argument_bytes"]) / 2**30, 2),
                peak_gib=round(mem["peak_bytes"] / 2**30, 2),
            ))
    _write(os.path.join(out, "roofline_summary.csv"), rows)
    if rows:
        dom = {}
        for r in rows:
            dom[r["dominant"]] = dom.get(r["dominant"], 0) + 1
        validation["roofline_cells"] = len(rows)
        validation["roofline_dominant_histogram"] = dom


BENCHES = {
    "tab4": bench_tab4,
    "tab5": bench_tab5,
    "tab6": bench_tab6,
    "tab7": bench_tab7,
    "tab8": bench_tab8,
    "fig9": bench_fig9,
    "fig10": bench_fig10,
    "kernels": bench_kernels,
    "roofline": bench_roofline,
}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m benchmarks.run_torch",
        description="The paper's benches through the PyTorch port, and the "
                    "roofline bench, which reads the port's LM dry-run JSONs "
                    "(python -m repro_torch.launch.dryrun).")
    ap.add_argument("--benches", default=",".join(BENCHES),
                    help=f"comma list from: {','.join(BENCHES)}")
    ap.add_argument("--graphs", default=",".join(DEFAULT_GRAPHS))
    ap.add_argument("--out", default="results/bench_torch")
    ap.add_argument("--workers", type=int, default=0,
                    help="sweep process-pool size; <=1 runs serially")
    ap.add_argument("--mode", default="batch", choices=("scenario", "batch"),
                    help="sweep execution mode: batch groups each chunk's "
                         "DRAM traces into a few kernel launches")
    ap.add_argument("--cache", default="results/sweep_cache_torch",
                    help="sweep result cache directory ('' disables caching)")
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the CUDA card, raising "
                         "without one; cpu: the kernels' plain versions)")
    args = ap.parse_args(argv)
    graphs = [g for g in args.graphs.split(",") if g]

    def sweep(spec):
        return run_sweep(spec, cache_dir=args.cache or None,
                         workers=args.workers, mode=args.mode,
                         progress=lambda msg: print(f"  {msg}", flush=True),
                         device=args.device)

    validation: dict = {}
    for name in args.benches.split(","):
        if not name:
            continue
        print(f"[bench] {name} ...", flush=True)
        t0 = time.time()
        if name == "kernels":
            bench_kernels(graphs, args.out, validation, sweep, device=args.device)
        else:
            BENCHES[name](graphs, args.out, validation, sweep)
        print(f"  done in {time.time() - t0:.1f}s", flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "validation.json"), "w") as f:
        json.dump(validation, f, indent=1)
    print("\n=== validation summary ===")
    for k, v in validation.items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
