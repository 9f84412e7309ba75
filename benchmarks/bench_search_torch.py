"""Adaptive-search bench through the PyTorch port: executions-to-optimum
vs the full grid.

The port's twin of ``benchmarks/bench_search.py``.  How much of a
design-space grid has to be simulated to find its best configuration?
Both sides run on the same space, the memory-controller sensitivity
matrix of ``bench_memory`` widened by a channel axis (4 accelerators x {1,
4, 8} HBM channels x {row, bank_xor} x {open, closed} x {hbm, hbm-pc} on
the synthetic tiny graph, 64 points), through ``repro_torch.sweep`` on
``--device`` (DRAM timing in ``csrc/dram_timing.cu`` on the card):

- **full-grid cost**: scenarios executed by ``run_sweep``,
- **executions-to-optimum** per seed: cumulative executions after the
  round where the search's incumbent first lands within 5% of the true
  grid optimum,
- the **regret curve** per seed: (cumulative executions, relative
  regret) per round,
- the **budget check**: every seed must reach the 5% band within the 25%
  budget the search defaults to (the bench fails otherwise).

``--tiny`` is the CI smoke: a search over the 8-scenario tiny grid with
trace fingerprints on; every probe's ``trace_hash`` must match
``benchmarks/golden_hashes_tiny.json`` and every probe row must equal the
same scenario's ``run_sweep`` row, then a warm re-search must execute
nothing.  The result, with the device, the card's name and power limit
and the kernel's launches, goes to
``results/bench_torch/BENCH_search.json`` unless ``--out`` says otherwise.

    PYTHONPATH=src python -m benchmarks.bench_search_torch                # full, the card
    PYTHONPATH=src python -m benchmarks.bench_search_torch --tiny --device cpu
"""
from __future__ import annotations

import argparse
import json
import math
import os
import tempfile

from benchmarks.torch_common import card, clock, device_or_exit

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_hashes_tiny.json")

TOLERANCE = 0.05   # "found it" = within 5% of the grid optimum
BUDGET_FRAC = 0.25  # acceptance bar: optimum found inside a quarter grid


def _tiny_graph():
    from repro_torch.graph.generators import GraphSpec

    return GraphSpec("tiny", "uniform", 256, 1024, True, 1, 0)


def search_space():
    """bench_memory's controller-sensitivity matrix widened by a channel
    axis, on the tiny graph: 64 valid points."""
    from repro_torch.configs.graphsim import MEMORY_SENSITIVITY_AXES
    from repro_torch.sweep.spec import SweepSpec

    return SweepSpec(
        name="bench-search",
        accelerators=("accugraph", "foregraph", "hitgraph", "thundergp"),
        graphs=(_tiny_graph(),),
        problems=("bfs",),
        drams=("hbm", ("hbm", 4), ("hbm", 8)),
        **MEMORY_SENSITIVITY_AXES,
    )


def _write(out: str, result: dict) -> None:
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"  wrote {out}")


# ---- full bench -------------------------------------------------------------


def run_full(out: str, seeds: int, dev) -> int:
    from repro_torch.kernels._platform import LAUNCHES, reset_launches
    from repro_torch.sweep import run_sweep
    from repro_torch.sweep.results import result_rows
    from repro_torch.sweep.search import SearchSpec, run_search

    spec = search_space()
    pool = len(spec.scenarios())
    budget = math.ceil(BUDGET_FRAC * pool)
    with tempfile.TemporaryDirectory(prefix="bench_search_torch_") as tmp:
        print(f"[bench_search_torch] grid: {pool} scenarios (full-grid baseline, device {dev})")
        reset_launches()
        t0 = clock(dev)
        grid = run_sweep(spec, cache_dir=os.path.join(tmp, "grid"), device=dev)
        grid_wall = clock(dev) - t0
        grid_launches = LAUNCHES["dram_timing"]
        rows = [r for r in result_rows(grid, with_status=False)
                if r.get("runtime_s") is not None]
        assert len(rows) == pool, "grid must execute cleanly"
        optimum = min(r["runtime_s"] for r in rows)
        print(f"  optimum runtime_s={optimum:.6g} in {grid_wall:.1f}s "
              f"({grid_launches} dram_timing launches)")

        per_seed, curves = [], []
        reset_launches()
        t1 = clock(dev)
        for seed in range(seeds):
            res = run_search(SearchSpec(space=spec, budget=budget, batch=3, seed=seed),
                             cache_dir=os.path.join(tmp, f"search{seed}"), device=dev)
            assert res.best is not None
            gap = res.best["value"] / optimum - 1.0
            to_opt, curve = None, []
            for h in res.history:
                regret = None if h["best"] is None else round(h["best"] / optimum - 1.0, 6)
                curve.append(dict(executed=h["executed"], regret=regret))
                if to_opt is None and regret is not None and regret <= TOLERANCE:
                    to_opt = h["executed"]
            per_seed.append(dict(
                seed=seed, executed=res.executed, rounds=res.rounds,
                best=res.best["value"], best_scenario=res.best["scenario_id"],
                gap=round(gap, 6), executions_to_optimum=to_opt))
            curves.append(curve)
            print(f"  seed {seed}: best={res.best['value']:.6g} (gap {gap:+.2%}) after "
                  f"{res.executed}/{pool} executions; within {TOLERANCE:.0%} at {to_opt}")
            # the acceptance bar: a quarter of the grid finds the optimum band
            assert gap <= TOLERANCE, (
                f"seed {seed}: search missed the optimum by {gap:.1%} "
                f"with {res.executed} executions (budget {budget})")
            assert res.executed <= budget <= pool * BUDGET_FRAC + 1
        search_wall = clock(dev) - t1
        search_launches = LAUNCHES["dram_timing"]
    if dev.type == "cuda":
        assert grid_launches > 0 and search_launches > 0, (grid_launches, search_launches)

    mean_to_opt = sum(s["executions_to_optimum"] for s in per_seed) / seeds
    _write(out, dict(
        mode="full",
        device=str(dev),
        card=card(dev),
        space=dict(pool=pool, spec=spec.name),
        tolerance=TOLERANCE,
        budget=dict(frac=BUDGET_FRAC, executions=budget),
        full_grid=dict(executions=pool, wall_s=grid_wall, optimum=optimum,
                       dram_timing_launches=grid_launches),
        seeds=seeds,
        per_seed=per_seed,
        mean_executions_to_optimum=round(mean_to_opt, 2),
        cost_fraction=round(mean_to_opt / pool, 4),
        regret_curves=curves,
        search_wall_s=search_wall,
        search_dram_timing_launches=search_launches,
    ))
    print(f"  mean executions-to-optimum {mean_to_opt:.1f}/{pool} "
          f"({mean_to_opt / pool:.0%} of the grid)")
    return 0


# ---- CI smoke ---------------------------------------------------------------


def run_tiny(out: str, dev) -> int:
    from repro_torch.kernels._platform import LAUNCHES, reset_launches
    from repro_torch.sweep import ResultCache, run_sweep, scenario_hash
    from repro_torch.sweep.cache import canonical_json
    from repro_torch.sweep.results import result_rows
    from repro_torch.sweep.search import RunnerExecutor, SearchSpec, run_search
    from repro_torch.sweep.spec import SweepSpec

    spec = SweepSpec(
        name="search-tiny",
        accelerators=("accugraph", "foregraph", "hitgraph", "thundergp"),
        graphs=(_tiny_graph(),),
        problems=("bfs",),
        drams=("default", "hbm"),
    )
    scenarios = spec.scenarios()
    pool = len(scenarios)
    by_hash = {scenario_hash(s): s for s in scenarios}
    golden = json.load(open(GOLDEN))
    with tempfile.TemporaryDirectory(prefix="bench_search_torch_") as tmp:
        cache = ResultCache(os.path.join(tmp, "c"), memo_capacity=256)

        print(f"[bench_search_torch] tiny: exhaustive search over {pool} scenarios, "
              f"trace fingerprints on (device {dev})")
        reset_launches()
        t0 = clock(dev)
        res = run_search(SearchSpec(space=spec, budget=pool, batch=2, seed=0), cache=cache,
                         executor=RunnerExecutor(cache, with_trace_hash=True, device=dev),
                         device=dev)
        wall = clock(dev) - t0
        launches = LAUNCHES["dram_timing"]
        assert res.executed == pool and not res.errors, res.summary()
        if dev.type == "cuda":
            assert launches > 0, LAUNCHES

        # golden trace hashes: the adaptive path simulated the exact streams
        mismatches = {}
        for p in res.probes:
            sid = by_hash[p["hash"]].scenario_id
            got = cache.get(p["hash"]).get("trace_hash")
            if golden.get(sid) != got:
                mismatches[sid] = (got, golden.get(sid))
        assert not mismatches, f"probe trace hashes diverged: {mismatches}"
        print(f"  golden: {pool}/{len(golden)} trace hashes match ({wall:.1f}s)")

        # probe rows equal to an independent grid sweep's rows
        grid = run_sweep(spec, cache_dir=os.path.join(tmp, "grid"), device=dev)
        grid_rows = {scenario_hash(sr.scenario): row for sr, row in
                     zip(grid.results, result_rows(grid, with_status=False))}
        for p in res.probes:
            assert canonical_json(p["row"]) == canonical_json(grid_rows[p["hash"]]), p["hash"]
        print(f"  rows: {pool}/{pool} byte-identical to run_sweep")

        # a warm re-search answers from the cache without executing
        reset_launches()
        res2 = run_search(SearchSpec(space=spec, budget=pool, batch=2, seed=3), cache=cache,
                          device=dev)
        assert res2.executed == 0 and res2.warm == pool, res2.summary()
        assert res2.best["value"] == res.best["value"]
        assert LAUNCHES["dram_timing"] == 0, LAUNCHES
        print("  warm re-search: 0 executions, no launch, same answer")

    _write(out, dict(
        mode="tiny",
        device=str(dev),
        card=card(dev),
        dram_timing_launches=launches,
        pool=pool,
        wall_s=wall,
        golden_hashes_checked=pool,
        golden_ok=True,
        rows_byte_identical=True,
        warm_research_zero_executions=True,
        best=res.best["scenario_id"],
    ))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--tiny", action="store_true",
                    help="CI smoke: golden trace hashes + row byte-identity")
    ap.add_argument("--seeds", type=int, default=3, help="search repetitions in full mode")
    ap.add_argument("--device", default=None,
                    help="device of the DRAM timing (default: the CUDA card; "
                         "cpu: the kernel's plain version)")
    ap.add_argument("--out", default=os.path.join("results", "bench_torch",
                                                  "BENCH_search.json"))
    args = ap.parse_args(argv)
    dev = device_or_exit(args.device)
    if args.tiny:
        return run_tiny(args.out, dev)
    return run_full(args.out, args.seeds, dev)


if __name__ == "__main__":
    raise SystemExit(main())
