"""CLI for ad-hoc scenario sweeps on the port, the reference's flags plus
``--device``.

    PYTHONPATH=src python -m repro_torch.sweep \
        --accels accugraph,foregraph,hitgraph,thundergp \
        --graphs sd,db --problems bfs,pr --drams default,hbm \
        --workers 4 --cache results/sweep_cache_torch --out results/sweep

``--device`` names the device the sweep runs on: the CUDA card when it is
left out (the run raises without one), ``cpu`` for the kernels' plain
versions.

``--channels`` crosses each DRAM preset with explicit channel counts (the
Tab. 7 axis); ``--mappings`` / ``--page-policies`` / ``--pseudo-channels``
cross in the memory-controller axes (e.g. ``--mappings row,bank_xor
--page-policies open,closed --pseudo-channels 0,1`` — invalid combinations
such as pseudo-channels on DDR4 are filtered, not errors); ``--reorders``
/ ``--interval-scales`` cross in the graph-layout axes (vertex reordering
before partitioning and power-of-two partition-granularity scaling —
combinations a model rejects, e.g. ForeGraph past its 65,536-vertex
interval cap, are likewise filtered); ``--list`` prints the expanded
scenarios (and what was filtered out) without simulating anything.

The reference's ``search`` subcommand (adaptive search) is not ported
yet: ``python -m repro_torch.sweep search ...`` exits with code 2.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.core.accelerators import ACCELERATORS
from repro_torch.graph.generators import PAPER_GRAPHS
from repro_torch.graph.problems import PROBLEMS
from repro_torch.sweep.results import result_rows, write_csv, write_json
from repro_torch.sweep.runner import ExecutionPolicy, run_sweep
from repro_torch.sweep.spec import ConfigOverride, SweepSpec


def _csv_list(text: str) -> tuple[str, ...]:
    return tuple(x for x in text.split(",") if x)


_BOOL_TOKENS = {"0": False, "off": False, "false": False, "no": False,
                "1": True, "on": True, "true": True, "yes": True}


def _csv_bools(text: str, flag: str) -> tuple[bool, ...]:
    vals = []
    for tok in _csv_list(text):
        if tok.lower() not in _BOOL_TOKENS:
            raise ValueError(f"bad {flag} value {tok!r} (use 0/1 or on/off)")
        vals.append(_BOOL_TOKENS[tok.lower()])
    return tuple(vals) or (False,)


def build_spec(args: argparse.Namespace) -> SweepSpec:
    drams: tuple = _csv_list(args.drams)
    if args.channels:
        chans = [int(c) for c in _csv_list(args.channels)]
        drams = tuple((d, c) for d in drams for c in chans)
    overrides: tuple = (ConfigOverride(engine=args.engine) if args.engine
                        else ConfigOverride(),)
    try:
        scales = tuple(int(x) for x in _csv_list(args.interval_scales)) or (1,)
    except ValueError:
        raise ValueError(
            f"bad --interval-scales value in {args.interval_scales!r} "
            f"(use a comma list of power-of-two integers)")
    return SweepSpec(
        name=args.name,
        accelerators=_csv_list(args.accels),
        graphs=_csv_list(args.graphs),
        problems=_csv_list(args.problems),
        drams=drams,
        mappings=_csv_list(args.mappings) or ("row",),
        page_policies=_csv_list(args.page_policies) or ("open",),
        pseudo_channels=_csv_bools(args.pseudo_channels, "--pseudo-channels"),
        overrides=overrides,
        reorders=_csv_list(args.reorders) or ("identity",),
        interval_scales=scales,
        engines=_csv_list(args.engines) or ("numpy",),
    )


def add_spec_args(ap: argparse.ArgumentParser) -> None:
    """The sweep-axis flags, the reference's (``python -m repro.sweep``)
    flag for flag, so a spec means the same thing in both packages."""
    ap.add_argument("--name", default="sweep", help="sweep name (output file stem)")
    ap.add_argument("--accels", default=",".join(ACCELERATORS),
                    help=f"comma list from: {','.join(ACCELERATORS)}")
    ap.add_argument("--graphs", default="sd,db",
                    help=f"comma list from: {','.join(PAPER_GRAPHS)}")
    ap.add_argument("--problems", default="bfs",
                    help=f"comma list from: {','.join(PROBLEMS)}")
    ap.add_argument("--drams", default="default",
                    help="DRAM presets (default,ddr3,hbm,...)")
    ap.add_argument("--channels", default="",
                    help="optional channel counts crossed with --drams (e.g. 1,2,4)")
    ap.add_argument("--mappings", default="row",
                    help="address mappings (row,bank,bank_xor; scheme@lines "
                         "sets channel-interleave granularity, e.g. row@32)")
    ap.add_argument("--page-policies", default="open",
                    help="row-buffer page policies (open,closed)")
    ap.add_argument("--pseudo-channels", default="0",
                    help="HBM pseudo-channel axis (comma list of 0/1; "
                         "1 on non-HBM presets is filtered, not an error)")
    ap.add_argument("--reorders", default="identity",
                    help="graph-layout vertex reorderings applied before "
                         "partitioning (identity,degree,random,bfs)")
    ap.add_argument("--interval-scales", default="1",
                    help="power-of-two multipliers on each accelerator's "
                         "interval size (e.g. 1,2,4; combinations a model "
                         "rejects are filtered, not errors)")
    ap.add_argument("--engines", default="numpy",
                    help="semantic execution engines (numpy,device); device "
                         "falls back to numpy, with a warning, on "
                         "accelerator/problem pairs without a device path")
    ap.add_argument("--engine", default="", help="DRAM engine override (scan|fast)")


def add_policy_args(ap: argparse.ArgumentParser) -> None:
    """Robustness knobs (ExecutionPolicy) of the CLI runner."""
    ap.add_argument("--timeout-per-scenario", type=float, default=None,
                    metavar="SECONDS",
                    help="best-effort wall-clock bound per scenario; a "
                         "timed-out scenario becomes an error row (and "
                         "retries under --retries)")
    ap.add_argument("--retries", type=int, default=0,
                    help="re-execute a failed/timed-out scenario up to N "
                         "more times before recording the error")
    ap.add_argument("--retry-backoff", type=float, default=0.25,
                    metavar="SECONDS",
                    help="sleep before retry k is backoff * 2**k")


def build_policy(args: argparse.Namespace) -> ExecutionPolicy | None:
    if args.timeout_per_scenario is None and not args.retries:
        return None
    return ExecutionPolicy(timeout_s=args.timeout_per_scenario,
                           retries=args.retries,
                           backoff_s=args.retry_backoff)


def main(argv: list[str] | None = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "search":
        print("error: adaptive search is not ported yet (ROADMAP A8)",
              file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(prog="python -m repro_torch.sweep",
                                 description=__doc__)
    add_spec_args(ap)
    add_policy_args(ap)
    ap.add_argument("--workers", type=int, default=0,
                    help="process-pool size; <=1 runs serially")
    ap.add_argument("--mode", default="scenario", choices=("scenario", "batch"),
                    help="batch: group all DRAM traces of a worker's chunk "
                         "into a few batched device dispatches")
    ap.add_argument("--cache", default="results/sweep_cache",
                    help="result cache directory ('' disables caching)")
    ap.add_argument("--out", default="results/sweep", help="output directory")
    ap.add_argument("--list", action="store_true",
                    help="print expanded scenarios and exit")
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the CUDA card, raising "
                         "without one; cpu: the kernels' plain versions)")
    args = ap.parse_args(argv)

    try:
        spec = build_spec(args)
        spec.expand()
        policy = build_policy(args)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.list:
        scenarios, skipped = spec.expand()
        for s in scenarios:
            print(f"run  {s.scenario_id}")
        for sk in skipped:
            print(f"skip {sk.graph}/{sk.accelerator}/{sk.problem}/{sk.dram}: {sk.reason}")
        print(f"{len(scenarios)} scenarios, {len(skipped)} skipped")
        return 0

    result = run_sweep(
        spec,
        cache_dir=args.cache or None,
        workers=args.workers,
        mode=args.mode,
        policy=policy,
        progress=lambda msg: print(msg, flush=True),
        device=args.device,
    )
    rows = result_rows(result, with_status=True)
    if rows:
        csv_path = f"{args.out}/{spec.name}.csv"
        write_csv(csv_path, rows)
        write_json(f"{args.out}/{spec.name}.json", rows)
        print(f"wrote {csv_path} ({len(rows)} rows)")
    else:
        print("no runnable scenarios (all combinations filtered); nothing written")
    print(result.summary())
    return 1 if result.n_errors else 0


if __name__ == "__main__":
    sys.exit(main())
