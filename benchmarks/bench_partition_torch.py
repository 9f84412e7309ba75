"""Partitioning & graph-layout sensitivity bench through the PyTorch port:
the sweepable layout axes.

The port's twin of ``benchmarks/bench_partition.py``.  It measures how
much each accelerator moves across the axes the pluggable layout layer
exposes:

- vertex reordering: identity (generator order, the paper's implicit
  layout) vs descending-degree sort vs BFS locality order vs a seeded
  random shuffle (destroys crawl/community id-locality),
- interval scaling: x1 vs x2 on each accelerator's preset interval size
  (partition granularity).

Default matrix: 4 accelerators x {identity, degree, bfs, random} x {1, 2}
interval scales over 2 graphs (``pk``, ``rd``: a social graph and a road
network, both large enough that every accelerator runs multi-partition at
its preset interval size) on BFS = 64 scenarios, run by
``repro_torch.sweep.run_sweep`` on ``--device`` (DRAM timing in
``csrc/dram_timing.cu`` on the card).  Every scenario must execute
cleanly, every row must carry the layout columns (effective interval,
edges/partition CV, shard fill for ForeGraph), and the per-corner cycles
+ row-hit / partition-skip deltas vs the identity/x1 corner land in the
result beside the rows, the kernel's launches, the device and the card's
name and power limit (``results/bench_torch/BENCH_partition.json`` unless
``--out`` says otherwise).

``--tiny`` (CI smoke) also hashes the identity/x1 request streams of all
four accelerators and asserts them equal to
``benchmarks/golden_hashes_tiny.json``: the layout layer at its default
corner must never drift from the pre-layout pipeline.

    PYTHONPATH=src python -m benchmarks.bench_partition_torch              # full, the card
    PYTHONPATH=src python -m benchmarks.bench_partition_torch --tiny --device cpu
"""
from __future__ import annotations

import argparse
import json
import os

from benchmarks.torch_common import card, clock, device_or_exit

ACCELS = ("accugraph", "foregraph", "hitgraph", "thundergp")
GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden_hashes_tiny.json")


def _build_spec(args):
    from repro_torch.configs.graphsim import LAYOUT_AXES
    from repro_torch.sweep.spec import SweepSpec

    if args.tiny:
        from repro_torch.graph.generators import GraphSpec

        graphs: tuple = (GraphSpec("tiny", "uniform", 256, 1024, True, 1, 0),)
        drams: tuple = ("default", "hbm")  # both golden-hash presets
    else:
        graphs = tuple(x for x in args.graphs.split(",") if x)
        drams = ("default",)
    return SweepSpec(
        name="bench-partition",
        accelerators=ACCELS,
        graphs=graphs,
        problems=("bfs",),
        drams=drams,
        **LAYOUT_AXES,
    )


def _check_identity_golden_hashes(spec) -> int:
    """Hash the identity/x1 request streams and compare them to the goldens;
    returns the number of scenarios checked (asserts on drift)."""
    from repro_torch.core.accelerators import ACCELERATORS
    from repro_torch.core.trace import trace_stream_hash
    from repro_torch.graph.problems import PROBLEMS
    from repro_torch.sweep.runner import _graph

    baseline = json.load(open(GOLDEN_PATH))
    checked = 0
    for s in spec.scenarios():
        if s.config.reorder != "identity" or s.config.interval_scale != 1:
            continue
        want = baseline.get(s.scenario_id)
        if want is None:
            continue
        pending = ACCELERATORS[s.accelerator](s.config).prepare(
            _graph(s.graph), PROBLEMS[s.problem], root=s.root, dram=s.dram)
        got = trace_stream_hash(pending.traces())[:16]
        assert got == want, (
            f"identity-layout trace stream drifted from the goldens: "
            f"{s.scenario_id} {got} != {want}")
        checked += 1
    return checked


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--graphs", default="pk,rd")
    ap.add_argument("--device", default=None,
                    help="device of the DRAM timing (default: the CUDA card; "
                         "cpu: the kernel's plain version)")
    ap.add_argument("--out", default=os.path.join("results", "bench_torch",
                                                  "BENCH_partition.json"))
    ap.add_argument("--tiny", action="store_true",
                    help="CI smoke: 1 tiny graph + golden-hash assertion")
    args = ap.parse_args(argv)
    dev = device_or_exit(args.device)

    from repro_torch.configs.graphsim import LAYOUT_AXES
    from repro_torch.kernels._platform import LAUNCHES, reset_launches
    from repro_torch.sweep.results import result_rows
    from repro_torch.sweep.runner import run_sweep

    spec = _build_spec(args)
    reset_launches()
    t0 = clock(dev)
    result = run_sweep(spec, cache_dir=None, mode="batch", device=dev,
                       progress=lambda m: print(m, flush=True))
    wall = clock(dev) - t0
    launches = dict(LAUNCHES)
    rows = result_rows(result, with_status=True)

    errors = [r for r in rows if r["status"] == "error"]
    assert not errors, f"{len(errors)} scenario(s) failed: {errors[0]}"
    n_corners = len(LAYOUT_AXES["reorders"]) * len(LAYOUT_AXES["interval_scales"])
    assert len(rows) == len(spec.accelerators) * len(spec.graphs) \
        * len(spec.drams) * n_corners, len(rows)
    for r in rows:
        assert r["effective_interval"], r
        assert r["edges_per_partition_cv"] is not None, r
        if r["accelerator"] == "foregraph":
            assert r["shard_fill"] is not None, r
    if dev.type == "cuda":
        assert launches["dram_timing"] > 0, launches
    print(f"[bench_partition_torch] {len(rows)} scenarios ok in {wall:.1f}s "
          f"(device {dev}, {launches['dram_timing']} dram_timing launches)")

    golden_checked = 0
    if args.tiny:
        golden_checked = _check_identity_golden_hashes(spec)
        assert golden_checked, "no identity scenarios matched the golden keys"
        print(f"[bench_partition_torch] {golden_checked} identity-layout golden "
              f"trace hashes identical")

    # ---- per-(graph, accelerator) deltas vs the identity/x1 corner --------
    by_corner = {}
    for r in rows:
        by_corner[(r["graph"], r["dram"], r["accelerator"], r["reorder"],
                   r["interval_scale"])] = r
    deltas: dict[str, dict] = {}
    for (graph, dram, accel, reorder, scale), r in sorted(by_corner.items()):
        base = by_corner[(graph, dram, accel, "identity", 1)]
        label = f"{reorder}/x{scale}"
        cycles = int(round(r["runtime_s"] / max(base["runtime_s"], 1e-12) * 1000)) / 1000
        deltas.setdefault(f"{graph}/{dram}", {}).setdefault(accel, {})[label] = dict(
            runtime_ratio=cycles,
            row_hit_delta=int(r["row_hits"] - base["row_hits"]),
            partition_skip_delta=int(r["partitions_skipped"] - base["partitions_skipped"]),
            edges_per_partition_cv=r["edges_per_partition_cv"],
            shard_fill=r.get("shard_fill"),
        )
    for gkey, per_accel in deltas.items():
        print(f"  {gkey}:")
        for accel, corners in per_accel.items():
            worst = max(corners.values(), key=lambda c: c["runtime_ratio"])
            best = min(corners.values(), key=lambda c: c["runtime_ratio"])
            print(f"    {accel:10s} runtime ratio vs identity/x1: "
                  f"best {best['runtime_ratio']}, worst {worst['runtime_ratio']}")

    out = dict(
        workload=dict(
            name=spec.name,
            scenarios=len(rows),
            accelerators=list(spec.accelerators),
            graphs=[g if isinstance(g, str) else g.name for g in spec.graphs],
            drams=list(spec.drams),
            reorders=list(spec.reorders),
            interval_scales=list(spec.interval_scales),
            wall_s=wall,
        ),
        device=str(dev),
        card=card(dev),
        launches=launches,
        golden_identity_hashes_checked=golden_checked,
        deltas=deltas,
        rows=[{k: v for k, v in r.items() if k != "status"} for r in rows],
    )
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"  wrote {args.out} ({len(rows)} scenarios)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
