"""Host-pipeline throughput bench through the PyTorch port: the eager
host pipeline against the lazy one with its caches.

The port's twin of ``benchmarks/bench_host.py``.  It times the simulator's
host half (graph, partitions, semantic execution, trace assembly) two ways
on a tab4-style chunk swept across memory technologies (DDR3 / DDR4 / HBM,
the paper's Tab. 6 axis), with the chunk's traces timed on ``--device``
(``csrc/dram_timing.cu`` on the card):

- **sequential-host**: eager trace combinators
  (``repro_torch.core.trace.eager_traces``) and no artifact reuse
  (``repro_torch.core.hostcache.disabled``);
- **overhauled**: the lazy trace IR plus the in-process host caches, which
  share partition indices and semantic executions across scenarios that
  differ only in the accelerator or DRAM axes.

Both must give byte-identical traces (the golden trace hashes) and equal
``SimReport`` s (asserted on every run).  The wall split into host prepare,
device timing and finalize, the DRAM kernel's launches and the card's name
and power limit go to ``results/bench_torch/BENCH_host.json`` unless
``--out`` says otherwise.

    PYTHONPATH=src python -m benchmarks.bench_host_torch                # tab4 chunk, the card
    PYTHONPATH=src python -m benchmarks.bench_host_torch --tiny --device cpu
"""
from __future__ import annotations

import argparse
import json
import os

from benchmarks.torch_common import card, clock, device_or_exit

DRAM_AXIS = ("ddr3", "default", "hbm")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden_hashes_tiny.json")


def _build_spec(args):
    from repro_torch.core.accelerators import ACCELERATORS
    from repro_torch.graph.generators import GraphSpec
    from repro_torch.sweep.spec import SweepSpec

    if args.tiny:
        return SweepSpec(
            name="bench-host-tiny",
            accelerators=tuple(ACCELERATORS),  # all four: trace-hash coverage
            graphs=(GraphSpec("tiny", "uniform", 256, 1024, True, 1, 0),),
            problems=("bfs",),
            drams=("default", "hbm"),
        )
    return SweepSpec(
        name="bench-tab4",
        accelerators=tuple(x for x in args.accels.split(",") if x),
        graphs=tuple(x for x in args.graphs.split(",") if x),
        problems=tuple(x for x in args.problems.split(",") if x),
        drams=DRAM_AXIS,
    )


def _run_chunk(scenarios, dev) -> tuple[list, dict, list[str]]:
    """Every scenario's host half, the chunk's traces timed in one grouped
    pass on ``dev``, then finalize.  Returns (reports, wall breakdown,
    trace hashes); the caller sets the trace mode and the caches."""
    from repro_torch.core.accelerators import ACCELERATORS
    from repro_torch.core.engine import simulate_many
    from repro_torch.core.trace import trace_stream_hash
    from repro_torch.graph.problems import PROBLEMS
    from repro_torch.kernels._platform import LAUNCHES, reset_launches
    from repro_torch.sweep.runner import _graph

    reset_launches()
    t0 = clock(dev)
    pendings = []
    for s in scenarios:
        g = _graph(s.graph)
        accel = ACCELERATORS[s.accelerator](s.config)
        pendings.append(accel.prepare(g, PROBLEMS[s.problem], root=s.root, dram=s.dram))
    traces = [p.traces() for p in pendings]
    t1 = clock(dev)

    items = []
    for p, trs in zip(pendings, traces):
        items += [(tr, p.dram, p.config.engine, p.config.scan_cutoff) for tr in trs]
    flat_reports = simulate_many(items, device=dev)
    t2 = clock(dev)

    reports, at = [], 0
    for p, trs in zip(pendings, traces):
        reports.append(p.finalize(flat_reports[at: at + len(trs)]))
        at += len(trs)
    t3 = clock(dev)

    hashes = [trace_stream_hash(trs) for trs in traces]
    walls = dict(host_prepare_s=t1 - t0, device_timing_s=t2 - t1, finalize_s=t3 - t2,
                 total_s=t3 - t0, traces=len(items), requests=sum(tr.n for tr, *_ in items),
                 dram_timing_launches=LAUNCHES["dram_timing"])
    return reports, walls, hashes


def _print(label: str, w: dict) -> None:
    print(f"  {label}: host {w['host_prepare_s']:.4f}s + device {w['device_timing_s']:.4f}s "
          f"+ finalize {w['finalize_s']:.4f}s = {w['total_s']:.4f}s, "
          f"{w['dram_timing_launches']} launches")


def main(argv=None) -> int:
    from repro_torch.core.accelerators import ACCELERATORS

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--graphs", default="sd,db",
                    help="graph suite keys for the tab4-style chunk")
    ap.add_argument("--accels", default=",".join(ACCELERATORS))
    ap.add_argument("--problems", default="bfs,pr")
    ap.add_argument("--device", default=None,
                    help="device of the DRAM timing (default: the CUDA card; "
                         "cpu: the kernel's plain version)")
    ap.add_argument("--out", default=os.path.join("results", "bench_torch", "BENCH_host.json"))
    ap.add_argument("--tiny", action="store_true",
                    help="CI smoke: all 4 accelerators x 1 tiny graph x bfs")
    args = ap.parse_args(argv)
    dev = device_or_exit(args.device)

    from repro_torch.core import hostcache
    from repro_torch.core.trace import eager_traces

    spec = _build_spec(args)
    scenarios = spec.scenarios()
    print(f"[bench_host_torch] {spec.name}: {len(scenarios)} scenarios "
          f"({len(spec.accelerators)} accels x {len(spec.graphs)} graphs x "
          f"{len(spec.problems)} problems x {len(spec.drams)} drams), device {dev}")

    # each variant runs twice and is measured on the second pass: the two
    # batch different (B, L) shapes (deduplication shrinks the batch axis),
    # so each warms its own length buckets
    with eager_traces(), hostcache.disabled():
        hostcache.clear_all()
        _run_chunk(scenarios, dev)
        hostcache.clear_all()
        seq_reports, seq, seq_hashes = _run_chunk(scenarios, dev)
    _print("sequential-host (eager combinators, no artifact reuse)", seq)

    hostcache.clear_all()
    _run_chunk(scenarios, dev)
    hostcache.clear_all()
    new_reports, new, new_hashes = _run_chunk(scenarios, dev)
    cache = hostcache.stats_all()
    _print("overhauled (lazy trace IR + host artifact caches)", new)

    assert seq_hashes == new_hashes, "lazy trace IR diverged from the eager oracle"
    mismatches = sum(a.timing != b.timing or a.iterations != b.iterations
                     for a, b in zip(seq_reports, new_reports))
    assert mismatches == 0, f"{mismatches}/{len(scenarios)} SimReports diverged"
    print(f"  equivalence: {len(scenarios)}/{len(scenarios)} trace hashes + reports identical")
    if dev.type == "cuda":
        assert seq["dram_timing_launches"] > 0 and new["dram_timing_launches"] > 0, (seq, new)

    result = dict(
        workload=dict(name=spec.name, scenarios=len(scenarios), traces=new["traces"],
                      requests=new["requests"], drams=list(spec.drams)),
        device=str(dev),
        card=card(dev),
        sequential_host=seq,
        overhauled=new,
        host_speedup=seq["host_prepare_s"] / max(new["host_prepare_s"], 1e-9),
        wall_speedup=seq["total_s"] / max(new["total_s"], 1e-9),
        host_cache=cache,
        traces_identical=True,
        reports_identical=True,
        reports=[r.to_dict() for r in new_reports],
        golden_trace_hashes={s.scenario_id: h[:16] for s, h in zip(scenarios, new_hashes)},
    )
    if args.tiny:
        with open(GOLDEN) as f:
            golden = json.load(f)
        mismatches = {s.scenario_id: (h[:16], golden.get(s.scenario_id))
                      for s, h in zip(scenarios, new_hashes)
                      if golden.get(s.scenario_id) != h[:16]}
        assert not mismatches, f"golden hash drift: {mismatches}"
        result["golden_match"] = f"{len(scenarios)}/{len(scenarios)}"
        print(f"  golden: {len(scenarios)}/{len(scenarios)} hashes match "
              f"{os.path.basename(GOLDEN)}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"  wrote {args.out} (host speedup {result['host_speedup']:.2f}x, "
          f"end-to-end {result['wall_speedup']:.2f}x)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
