"""Memory-controller sensitivity bench through the PyTorch port: the
sweepable controller axes.

The port's twin of ``benchmarks/bench_memory.py``.  It measures how much
the *controller* configuration (not just the memory technology) moves
each accelerator, across the axes the pluggable controller layer exposes:

- address mapping: row-interleaved (paper default) vs XOR bank permutation,
- page policy: open vs closed,
- HBM pseudo-channels: off vs on (2x channels, half bus width, half banks).

Default matrix: 4 accelerators x {row, bank_xor} x {open, closed} x
{hbm, hbm-pc} = 32 scenarios on the ``sd`` graph (BFS), run by
``repro_torch.sweep.run_sweep`` on ``--device``, whose DRAM timing is
``csrc/dram_timing.cu`` on the card.  Every scenario must execute cleanly,
closed-page scenarios must report zero row hits/conflicts, and the default
corner (row/open/no-pc) must carry non-zero hits; on the card the sweep
must have launched the kernel.

The bench also measures the **scan-vs-fast engine error** on the
non-default corners (closed page, bank_xor): each such scenario runs once
with the exact scan engine and once with the analytic fast engine
(``core/engine.py::simulate_channel_fast``, ``classify_fast``), and the
relative ``runtime_s`` error distribution lands in the result beside the
rows, the kernel's launches, the device and the card's name and power
limit.  The result goes to ``results/bench_torch/BENCH_memory.json``
unless ``--out`` says otherwise.

    PYTHONPATH=src python -m benchmarks.bench_memory_torch                # full, the card
    PYTHONPATH=src python -m benchmarks.bench_memory_torch --tiny --device cpu
"""
from __future__ import annotations

import argparse
import json
import os

from benchmarks.torch_common import card, clock, device_or_exit

ACCELS = ("accugraph", "foregraph", "hitgraph", "thundergp")


def _build_spec(args, overrides=None):
    from repro_torch.configs.graphsim import MEMORY_SENSITIVITY_AXES
    from repro_torch.sweep.spec import ConfigOverride, SweepSpec

    if args.tiny:
        from repro_torch.graph.generators import GraphSpec

        graphs: tuple = (GraphSpec("tiny", "uniform", 256, 1024, True, 1, 0),)
        accels: tuple = ("accugraph", "hitgraph")
    else:
        graphs = tuple(x for x in args.graphs.split(",") if x)
        accels = ACCELS
    return SweepSpec(
        name="bench-memory",
        accelerators=accels,
        graphs=graphs,
        problems=("bfs",),
        drams=("hbm",),
        overrides=overrides or (ConfigOverride(),),
        **MEMORY_SENSITIVITY_AXES,
    )


def _row_key(row: dict) -> tuple:
    return (row["graph"], row["accelerator"], row["problem"], row["dram"],
            row["address_mapping"], row["page_policy"], row["pseudo_channels"])


def _axis_label(row: dict) -> str:
    parts = [row["address_mapping"], row["page_policy"]]
    if row["pseudo_channels"]:
        parts.append("pc")
    return "/".join(parts)


def _ratio(rows: dict, accel: str, num: tuple, den: tuple) -> float | None:
    """runtime ratio between two (mapping, policy, pc) corners."""
    a = rows.get((accel,) + num)
    b = rows.get((accel,) + den)
    if a is None or b is None or not b["runtime_s"]:
        return None
    return round(a["runtime_s"] / b["runtime_s"], 3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--graphs", default="sd")
    ap.add_argument("--device", default=None,
                    help="device of the DRAM timing (default: the CUDA card; "
                         "cpu: the kernel's plain version)")
    ap.add_argument("--out", default=os.path.join("results", "bench_torch",
                                                  "BENCH_memory.json"))
    ap.add_argument("--tiny", action="store_true",
                    help="CI smoke: 2 accelerators x 1 tiny graph")
    args = ap.parse_args(argv)
    dev = device_or_exit(args.device)

    from repro_torch.kernels._platform import LAUNCHES, reset_launches
    from repro_torch.sweep.results import result_rows
    from repro_torch.sweep.runner import run_sweep
    from repro_torch.sweep.spec import ConfigOverride

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
    assert len(rows) >= 16, f"expected >= 16 scenarios, got {len(rows)}"
    for r in rows:
        if r["page_policy"] == "closed":
            assert r["row_hits"] == 0 and r["row_conflicts"] == 0, r
        if (r["address_mapping"], r["page_policy"], r["pseudo_channels"]) == \
                ("row", "open", 0):
            assert r["row_hits"] > 0, r
    if dev.type == "cuda":
        assert launches["dram_timing"] > 0, launches
    print(f"[bench_memory_torch] {len(rows)} scenarios ok in {wall:.1f}s "
          f"(device {dev}, {launches['dram_timing']} dram_timing launches)")

    # ---- per-accelerator sensitivity (runtime ratios vs the default corner)
    by_corner = {}
    for r in rows:
        by_corner[(r["accelerator"], r["address_mapping"], r["page_policy"],
                   r["pseudo_channels"])] = r
    default = ("row", "open", 0)
    sensitivity = {}
    for accel in spec.accelerators:
        sensitivity[accel] = dict(
            closed_over_open=_ratio(by_corner, accel, ("row", "closed", 0), default),
            bank_xor_over_row=_ratio(by_corner, accel, ("bank_xor", "open", 0), default),
            pseudo_channels_over_legacy=_ratio(by_corner, accel, ("row", "open", 1), default),
        )
        print(f"  {accel:10s} closed/open={sensitivity[accel]['closed_over_open']} "
              f"xor/row={sensitivity[accel]['bank_xor_over_row']} "
              f"pc/legacy={sensitivity[accel]['pseudo_channels_over_legacy']}")

    # ---- scan-vs-fast engine error on the non-default corners ------------
    print("[bench_memory_torch] scan vs fast on closed-page / bank_xor corners ...")
    engine_rows, engine_wall = {}, {}
    for eng in ("scan", "fast"):
        t1 = clock(dev)
        res = run_sweep(_build_spec(args, overrides=(ConfigOverride(label=eng, engine=eng),)),
                        cache_dir=None, mode="batch", device=dev)
        engine_wall[eng] = clock(dev) - t1
        engine_rows[eng] = {_row_key(r): r for r in result_rows(res)
                            if r.get("runtime_s") is not None}
    rel_errors = {}
    for key, scan_row in engine_rows["scan"].items():
        if scan_row["page_policy"] == "open" and scan_row["address_mapping"] == "row":
            continue  # the default corner's error is the engine bench's
        fast_row = engine_rows["fast"].get(key)
        if fast_row is None or not scan_row["runtime_s"]:
            continue
        err = abs(fast_row["runtime_s"] - scan_row["runtime_s"]) / scan_row["runtime_s"]
        rel_errors[f"{key[1]}/{_axis_label(scan_row)}"] = round(err, 4)
    errs = sorted(rel_errors.values())
    err_stats = dict(
        scenarios=len(errs),
        median=round(errs[len(errs) // 2], 4) if errs else None,
        mean=round(sum(errs) / len(errs), 4) if errs else None,
        max=round(errs[-1], 4) if errs else None,
    )
    print(f"  rel runtime error: median={err_stats['median']} "
          f"mean={err_stats['mean']} max={err_stats['max']} "
          f"over {err_stats['scenarios']} non-default scenarios")

    out = dict(
        workload=dict(
            name=spec.name,
            scenarios=len(rows),
            accelerators=list(spec.accelerators),
            graphs=[g if isinstance(g, str) else g.name for g in spec.graphs],
            drams=list(spec.drams),
            mappings=list(spec.mappings),
            page_policies=list(spec.page_policies),
            pseudo_channels=[int(p) for p in spec.pseudo_channels],
            wall_s=wall,
        ),
        device=str(dev),
        card=card(dev),
        launches=launches,
        engine_wall_s=engine_wall,
        sensitivity=sensitivity,
        scan_vs_fast=dict(stats=err_stats, per_scenario=rel_errors),
        rows=[{k: v for k, v in r.items() if k != "status"} for r in rows],
    )
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"  wrote {args.out} ({len(rows)} scenarios)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
