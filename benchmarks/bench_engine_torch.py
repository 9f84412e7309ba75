"""Engine throughput bench through the PyTorch port: sequential against
batched DRAM timing dispatch.

The port's twin of ``benchmarks/bench_engine.py``.  It builds a tab4-style
sweep chunk (accelerators x graphs x problems on one DDR4 device), runs
every scenario's semantic half once, then times the chunk's DRAM traces
twice on ``--device``:

- **sequential**: ``repro_torch.core.engine.simulate_sequential`` a trace at
  a time, one launch of ``csrc/dram_timing.cu`` and one host sync each;
- **batched**: ``simulate_many``, one launch a (timing config x length
  bucket) group over the whole chunk.

Both passes must give identical ``TimingReport`` s (asserted on every run).
Wall, traces/s, the engine's dispatch counts, the kernel's launches and
the reports go to ``results/bench_torch/BENCH_engine.json`` unless
``--out`` says otherwise, with the card's name and power limit.

    PYTHONPATH=src python -m benchmarks.bench_engine_torch                # tab4-sized, the card
    PYTHONPATH=src python -m benchmarks.bench_engine_torch --tiny --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import time

from benchmarks.torch_common import card, clock, device_or_exit


def _prepare_chunk(spec):
    """Semantic halves of all scenarios -> flat (trace, cfg, engine,
    cutoff) work items plus per-scenario (pending, trace count)."""
    from repro_torch.core.accelerators import ACCELERATORS
    from repro_torch.graph.problems import PROBLEMS
    from repro_torch.sweep.runner import _graph

    items, slices = [], []
    for s in spec.scenarios():
        g = _graph(s.graph)
        accel = ACCELERATORS[s.accelerator](s.config)
        pending = accel.prepare(g, PROBLEMS[s.problem], root=s.root, dram=s.dram)
        traces = pending.traces()
        slices.append((pending, len(traces)))
        items += [(tr, pending.dram, s.config.engine, s.config.scan_cutoff) for tr in traces]
    return items, slices


def _run_sequential(items, dev):
    from repro_torch.core.engine import simulate_sequential

    return [simulate_sequential([tr], cfg, engine, cutoff, device=dev)[0]
            for tr, cfg, engine, cutoff in items]


def _run_batched(items, dev):
    from repro_torch.core.engine import simulate_many

    return simulate_many(items, device=dev)


def _timed(label: str, fn, items, dev):
    from repro_torch.core.engine import dispatch_stats, reset_dispatch_stats
    from repro_torch.kernels._platform import LAUNCHES, reset_launches

    reset_dispatch_stats()
    reset_launches()
    t0 = clock(dev)
    reports = fn(items, dev)
    wall = clock(dev) - t0
    stats = dispatch_stats()
    rec = dict(wall_s=wall, traces=len(items), requests=sum(tr.n for tr, *_ in items),
               device_dispatches=stats["dispatches"], dram_timing_launches=LAUNCHES["dram_timing"],
               traces_per_s=len(items) / max(wall, 1e-9))
    print(f"  {label:>10}: {wall:.4f}s wall, {rec['device_dispatches']} dispatches, "
          f"{rec['dram_timing_launches']} launches, {rec['traces_per_s']:.1f} traces/s")
    return reports, rec


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
    ap.add_argument("--out", default=os.path.join("results", "bench_torch",
                                                  "BENCH_engine.json"))
    ap.add_argument("--tiny", action="store_true",
                    help="CI smoke: 2 accelerators x 1 small graph x bfs")
    args = ap.parse_args(argv)
    dev = device_or_exit(args.device)

    from repro_torch.graph.generators import GraphSpec
    from repro_torch.sweep.spec import SweepSpec

    if args.tiny:
        spec = SweepSpec(name="bench-tiny", accelerators=("accugraph", "foregraph"),
                         graphs=(GraphSpec("tiny", "uniform", 256, 1024, True, 1, 0),),
                         problems=("bfs",))
    else:
        spec = SweepSpec(name="bench-tab4",
                         accelerators=tuple(x for x in args.accels.split(",") if x),
                         graphs=tuple(x for x in args.graphs.split(",") if x),
                         problems=tuple(x for x in args.problems.split(",") if x))

    print(f"[bench_engine_torch] preparing {spec.name} chunk (device {dev}) ...")
    t0 = time.perf_counter()
    items, slices = _prepare_chunk(spec)
    print(f"  {len(slices)} scenarios, {len(items)} traces, "
          f"{sum(tr.n for tr, *_ in items)} requests "
          f"(semantics: {time.perf_counter() - t0:.1f}s)")

    # warm both paths with a full pass: the kernel's first load, the
    # allocator and each length bucket's scratch are not in the measured wall
    _run_sequential(items, dev)
    _run_batched(items, dev)

    seq_reports, seq = _timed("sequential", _run_sequential, items, dev)
    bat_reports, bat = _timed("batched", _run_batched, items, dev)

    mismatches = sum(a != b for a, b in zip(seq_reports, bat_reports))
    assert mismatches == 0, (
        f"batched reports diverge from sequential on {mismatches}/{len(items)} traces")
    print(f"  equivalence: {len(items)}/{len(items)} reports identical")
    if dev.type == "cuda":
        assert seq["dram_timing_launches"] > 0 and bat["dram_timing_launches"] > 0, (seq, bat)

    result = dict(
        workload=dict(name=spec.name, scenarios=len(slices), traces=len(items),
                      requests=seq["requests"]),
        device=str(dev),
        card=card(dev),
        sequential=seq,
        batched=bat,
        dispatch_reduction=seq["device_dispatches"] / max(bat["device_dispatches"], 1),
        wall_speedup=seq["wall_s"] / max(bat["wall_s"], 1e-9),
        reports_identical=True,
        reports=[r.to_dict() for r in bat_reports],
    )
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"  wrote {args.out} (dispatch reduction {result['dispatch_reduction']:.2f}x, "
          f"wall speedup {result['wall_speedup']:.2f}x)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
