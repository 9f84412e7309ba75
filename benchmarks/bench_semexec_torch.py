"""Semantic-execution engine bench through the PyTorch port: the numpy host
loop against ``semexec="device"``.

The port's twin of ``benchmarks/bench_semexec.py``.  Both engines run every
scenario's host half (``prepare``: semantic execution and trace assembly)
on a paper-scale graph, the semantics cache cleared before each pass as the
reference does.  The device engine keeps the graph state on ``--device``
and takes its scatter-min through ``csrc/edge_update.cu`` and PageRank's
sum through ``csrc/spmv.cu`` on the card.  Each engine is warmed once, then
the two alternate for ``--rounds`` turns (numpy then device, then device
then numpy), so both are measured within the same drift.  The contract
that makes the device engine a drop-in is asserted on every pass:

- request streams byte-identical (trace hash per scenario),
- iteration counts equal,
- min-problem values bit-identical, acc values allclose (1e-5 / 1e-6).

    PYTHONPATH=src python -m benchmarks.bench_semexec_torch               # lj, the card
    PYTHONPATH=src python -m benchmarks.bench_semexec_torch --tiny --device cpu

``--tiny`` replays the 8 golden tiny scenarios (4 accelerators x 2 DRAMs x
bfs) under both engines and asserts every hash equals
``benchmarks/golden_hashes_tiny.json``.  The result goes to
``results/bench_torch/BENCH_semexec.json`` unless ``--out`` says otherwise:
each engine's median, min and max seconds a pass, the device/numpy ratio
of the medians, whether the two ranges overlap, the edge-update and SpMV
launches of the device engine's passes, and the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics

import numpy as np

from benchmarks.torch_common import card, clock, device_or_exit

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_hashes_tiny.json")
ENGINES = ("numpy", "device")


def _build_spec(args):
    from repro_torch.core.accelerators import ACCELERATORS
    from repro_torch.graph.generators import GraphSpec
    from repro_torch.sweep.spec import SweepSpec

    if args.tiny:
        return SweepSpec(
            name="bench-semexec-tiny",
            accelerators=tuple(ACCELERATORS),
            graphs=(GraphSpec("tiny", "uniform", 256, 1024, True, 1, 0),),
            problems=("bfs",),
            drams=("default", "hbm"),
        )
    return SweepSpec(
        name="bench-semexec",
        accelerators=tuple(x for x in args.accels.split(",") if x),
        graphs=tuple(x for x in args.graphs.split(",") if x),
        problems=tuple(x for x in args.problems.split(",") if x),
        drams=("default",),
    )


def _prepare_all(scenarios, engine: str, dev):
    """Every scenario's host half under ``engine``, the semantics cache
    cleared first so each engine pays its full per-iteration cost
    (partition and layout artifacts stay warm: the same for both engines).
    Returns (pendings, seconds a scenario, trace hashes, launches)."""
    from repro_torch.core import hostcache
    from repro_torch.core.accelerators import ACCELERATORS
    from repro_torch.core.trace import trace_stream_hash
    from repro_torch.graph.problems import PROBLEMS
    from repro_torch.kernels._platform import launch_counts, reset_launches
    from repro_torch.sweep.runner import _graph

    hostcache.SEMANTICS.clear()
    reset_launches()
    pendings, walls = [], []
    for s in scenarios:
        g = _graph(s.graph)
        cfg = dataclasses.replace(s.config, semexec=engine)
        accel = ACCELERATORS[s.accelerator](cfg)
        t0 = clock(dev)
        pendings.append(accel.prepare(g, PROBLEMS[s.problem], root=s.root, dram=s.dram,
                                      device=dev))
        walls.append(clock(dev) - t0)
    launches = launch_counts()
    hashes = [trace_stream_hash(p.traces()) for p in pendings]
    return pendings, walls, hashes, launches


def _check_equivalence(scenarios, host, dev) -> None:
    from repro_torch.graph.problems import PROBLEMS

    for s, h, d in zip(scenarios, host, dev):
        assert h.iterations == d.iterations, s.scenario_id
        assert h.layout["engine"] == "numpy" and d.layout["engine"] == "device"
        if PROBLEMS[s.problem].kind == "min":
            np.testing.assert_array_equal(h.values, d.values, err_msg=s.scenario_id)
        else:
            np.testing.assert_allclose(h.values, d.values, rtol=1e-5, atol=1e-6,
                                       err_msg=s.scenario_id)


def _spread(passes: list[float]) -> dict:
    return dict(median_s=statistics.median(passes), min_s=min(passes), max_s=max(passes),
                passes_s=passes)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--graphs", default="lj",
                    help="graph suite keys (default: lj, ~1.07M edges)")
    ap.add_argument("--accels", default="hitgraph,thundergp")
    ap.add_argument("--problems", default="bfs,pr")
    ap.add_argument("--rounds", type=int, default=8,
                    help="measured turns of each engine, alternating the order")
    ap.add_argument("--device", default=None,
                    help="device of the device engine (default: the CUDA card; "
                         "cpu: the kernels' plain versions)")
    ap.add_argument("--out", default=os.path.join("results", "bench_torch",
                                                  "BENCH_semexec.json"))
    ap.add_argument("--tiny", action="store_true",
                    help="CI smoke: golden tiny scenarios under both engines")
    args = ap.parse_args(argv)
    dev = device_or_exit(args.device)
    if args.rounds < 1:
        ap.error("--rounds must be at least 1")

    from repro_torch.core.semexec import SUPPORTED

    spec = _build_spec(args)
    scenarios = spec.scenarios()
    unsupported = [s.scenario_id for s in scenarios
                   if s.problem not in SUPPORTED.get(s.accelerator, ())]
    assert not unsupported, unsupported
    print(f"[bench_semexec_torch] {spec.name}: {len(scenarios)} scenarios, "
          f"device {dev}, {args.rounds} rounds")

    # warm partition artifacts, the kernels and the allocator once an engine
    first = {engine: _prepare_all(scenarios, engine, dev) for engine in ENGINES}
    assert first["numpy"][2] == first["device"][2], "device traces diverged from numpy"
    passes = {engine: [] for engine in ENGINES}
    per_scenario = {engine: [[] for _ in scenarios] for engine in ENGINES}
    launches = []
    for r in range(args.rounds):
        order = ENGINES if r % 2 == 0 else ENGINES[::-1]
        got = {}
        for engine in order:
            got[engine] = _prepare_all(scenarios, engine, dev)
            pendings, walls, hashes, counts = got[engine]
            assert hashes == first["numpy"][2], f"{engine} traces drifted in round {r}"
            passes[engine].append(sum(walls))
            for i, w in enumerate(walls):
                per_scenario[engine][i].append(w)
            if engine == "device":
                launches.append(counts)
        _check_equivalence(scenarios, got["numpy"][0], got["device"][0])
        print(f"  round {r}: " + ", ".join(f"{e} {passes[e][-1]:.4f}s" for e in order))
    print(f"  equivalence: {len(scenarios)}/{len(scenarios)} trace hashes, values and "
          f"iteration counts agree in every round")

    numpy_s, device_s = _spread(passes["numpy"]), _spread(passes["device"])
    overlap = max(numpy_s["min_s"], device_s["min_s"]) <= min(numpy_s["max_s"],
                                                              device_s["max_s"])
    ratio = device_s["median_s"] / numpy_s["median_s"]
    hashes = first["numpy"][2]
    result = dict(
        workload=dict(name=spec.name, scenarios=len(scenarios),
                      graphs=sorted({s.graph.name for s in scenarios}),
                      edges={s.graph.name: s.graph.target_m for s in scenarios}),
        device=str(dev),
        card=card(dev),
        rounds=args.rounds,
        numpy=numpy_s,
        device_engine=device_s,
        device_over_numpy=ratio,
        ranges_overlap=overlap,
        per_scenario={s.scenario_id: {e: statistics.median(per_scenario[e][i])
                                      for e in ENGINES}
                      for i, s in enumerate(scenarios)},
        launches_per_pass=launches[-1],
        launches_every_pass_equal=all(c == launches[0] for c in launches),
        traces_identical=True,
        values_identical=True,
        golden_trace_hashes={s.scenario_id: h[:16] for s, h in zip(scenarios, hashes)},
    )
    if dev.type == "cuda":  # the device engine went through B2 (bfs) and B3 (pr)
        problems = {s.problem for s in scenarios}
        for kernel, problem in (("edge_update", "bfs"), ("spmv", "pr")):
            if problem in problems:
                assert launches[-1][kernel] > 0, (kernel, launches[-1])

    if args.tiny:
        with open(GOLDEN) as f:
            golden = json.load(f)
        mismatches = {s.scenario_id: (h[:16], golden.get(s.scenario_id))
                      for s, h in zip(scenarios, hashes)
                      if golden.get(s.scenario_id) != h[:16]}
        assert not mismatches, f"golden hash drift: {mismatches}"
        result["golden_match"] = f"{len(scenarios)}/{len(scenarios)}"
        print(f"  golden: {len(scenarios)}/{len(scenarios)} hashes match "
              f"{os.path.basename(GOLDEN)}")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"  numpy {numpy_s['median_s']:.4f}s ({numpy_s['min_s']:.4f}-"
          f"{numpy_s['max_s']:.4f}), device {device_s['median_s']:.4f}s "
          f"({device_s['min_s']:.4f}-{device_s['max_s']:.4f}) a pass: device/numpy "
          f"{ratio:.4f}, ranges {'overlap' if overlap else 'apart'}; launches "
          f"{launches[-1]}")
    print(f"  wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
