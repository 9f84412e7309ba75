"""CLI for adaptive sweep search.

    PYTHONPATH=src python -m repro_torch.sweep search \
        --accels accugraph,foregraph,hitgraph,thundergp \
        --graphs sd --problems bfs,pr \
        --drams hbm --channels 4,8 --mappings row,bank_xor \
        --page-policies open,closed \
        --objective runtime_s --budget-frac 0.25 --seed 0 \
        --cache results/sweep_cache --out results/sweep

Takes the same axis flags as the grid sweep (``python -m repro_torch.sweep``)
but *searches* the expanded space instead of executing all of it: a
surrogate model proposes the next batch of scenarios, only those run,
and the answer (best configuration, or — with ``--frontier`` — the
contexts where the ``--rank-over`` ranking flips) comes back at a
fraction of full-grid cost.  Probes execute through the grid runner
path, so their rows and cache records are byte-identical to a grid
sweep's; re-running a search over a space the cache has seen costs zero
executions.

``--device`` names the device the probes run on, as in the grid CLI: the
CUDA card when it is left out (without one the CLI prints ``error: ...``
and exits 2), ``cpu`` for the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.kernels._platform import resolve_device
from repro_torch.sweep.results import write_csv
from repro_torch.sweep.search.loop import (
    ACQUISITIONS,
    SearchSpec,
    run_search,
)
from repro_torch.sweep.search.surrogate import SURROGATES
from repro_torch.sweep.spec import SweepSpec


def add_search_args(ap: argparse.ArgumentParser) -> None:
    """The search-query flags, shared by ``python -m repro_torch.sweep search``
    and the serve client (``python -m repro_torch.serve --search``)."""
    ap.add_argument("--objective", default="runtime_s",
                    help="result-row column to optimize (runtime_s, mteps, "
                         "bw_utilization, ...)")
    ap.add_argument("--direction", default="min", choices=("min", "max"))
    ap.add_argument("--frontier", action="store_true",
                    help="frontier mode: find contexts where the --rank-over "
                         "ranking flips, instead of optimizing")
    ap.add_argument("--rank-over", default="accelerator",
                    help="frontier mode: the axis whose per-context ranking "
                         "is under question")
    ap.add_argument("--group-by", default="",
                    help="objective mode: comma list of axis fields; report "
                         "the best candidate per group (e.g. graph,problem)")
    ap.add_argument("--budget", type=int, default=0,
                    help="max executions (0: --budget-frac of the pool)")
    ap.add_argument("--budget-frac", type=float, default=0.25,
                    help="execution budget as a fraction of the candidate "
                         "pool when --budget is 0")
    ap.add_argument("--batch", type=int, default=8,
                    help="proposals per search round")
    ap.add_argument("--init", type=int, default=0,
                    help="random probes before the surrogate fits (0: auto)")
    ap.add_argument("--surrogate", default="forest",
                    choices=tuple(SURROGATES),
                    help="surrogate model over the design space")
    ap.add_argument("--acquisition", default="ei", choices=ACQUISITIONS,
                    help="acquisition score ranking unprobed candidates")
    ap.add_argument("--epsilon", type=float, default=0.1,
                    help="exploration share of each batch (1.0: pure seeded "
                         "random, the tiny-budget bandit mode)")
    ap.add_argument("--seed", type=int, default=0,
                    help="search seed (proposals replay exactly under it)")
    ap.add_argument("--max-pool", type=int, default=100_000,
                    help="candidate-pool cap; larger spaces are subsampled "
                         "deterministically under --seed")
    ap.add_argument("--patience", type=int, default=0,
                    help="objective mode: stop after N rounds without "
                         "improvement (0: run out the budget)")


def build_search_spec(args: argparse.Namespace,
                      space: SweepSpec) -> SearchSpec:
    group_by = tuple(x for x in args.group_by.split(",") if x)
    return SearchSpec(
        space=space,
        objective=args.objective,
        direction=args.direction,
        mode="frontier" if args.frontier else "objective",
        group_by=group_by,
        rank_over=args.rank_over,
        budget=args.budget,
        budget_frac=args.budget_frac,
        batch=args.batch,
        init=args.init,
        surrogate=args.surrogate,
        acquisition=args.acquisition,
        epsilon=args.epsilon,
        seed=args.seed,
        max_pool=args.max_pool,
        patience=args.patience,
    )


def _print_answer(result: dict) -> None:
    """Human-readable answer from a ``SearchResult.to_dict()`` payload
    (shared with the serve client, which only ever sees the dict)."""
    objective = result["objective"]
    if result.get("best") is not None:
        b = result["best"]
        print(f"best: {b['scenario_id']}  {objective}={b['value']:.6g}")
    if result.get("groups"):
        for key in sorted(result["groups"]):
            b = result["groups"][key]
            print(f"best[{key}]: {b['scenario_id']}  "
                  f"{objective}={b['value']:.6g}")
    if result.get("frontier") is not None:
        fr = result["frontier"]
        print(f"frontier over {fr['rank_over']}: baseline winner "
              f"{fr['baseline_winner']} ({fr['resolved']}/{fr['contexts']} "
              f"contexts resolved)")
        for f in fr["flips"]:
            ctx = ", ".join(f"{k}={v}" for k, v in f["context"].items())
            sure = ("resolved" if f["resolved"]
                    else f"p_flip={f['flip_probability']}")
            print(f"  flip [{ctx}]: {f['winner']} beats {f['runner_up']} "
                  f"by {100 * f['margin']:.1f}% ({sure})")


def main(argv: list[str] | None = None) -> int:
    from repro_torch.sweep.__main__ import (
        add_policy_args,
        add_spec_args,
        build_policy,
        build_spec,
    )
    ap = argparse.ArgumentParser(prog="python -m repro_torch.sweep search",
                                 description=__doc__)
    add_spec_args(ap)
    add_policy_args(ap)
    add_search_args(ap)
    ap.add_argument("--mode", default="batch", choices=("scenario", "batch"),
                    help="execution mode for proposal batches")
    ap.add_argument("--cache", default="results/sweep_cache",
                    help="result cache directory — warm start reads it, "
                         "probes write it ('' disables)")
    ap.add_argument("--out", default="results/sweep",
                    help="output directory")
    ap.add_argument("--device", default=None,
                    help="device the probes run on (default: the CUDA card; "
                         "cpu: the kernels' plain versions)")
    args = ap.parse_args(argv)

    try:
        space = build_spec(args)
        sspec = build_search_spec(args, space)
        policy = build_policy(args)
        device = resolve_device(args.device)
    except (ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    try:
        result = run_search(
            sspec,
            cache_dir=args.cache or None,
            policy=policy,
            exec_mode=args.mode,
            progress=lambda msg: print(msg, flush=True),
            device=device,
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    os.makedirs(args.out, exist_ok=True)
    report = f"{args.out}/{space.name}_search.json"
    result_dict = result.to_dict()
    with open(report, "w") as fh:
        json.dump(result_dict, fh, indent=2, sort_keys=True)
    rows = [dict(p["row"], status=p["status"]) for p in result.probes
            if p["row"] is not None]
    if rows:
        csv_path = f"{args.out}/{space.name}_probes.csv"
        write_csv(csv_path, rows)
        print(f"wrote {report} and {csv_path} ({len(rows)} probe rows)")
    else:
        print(f"wrote {report}")
    _print_answer(result_dict)
    print(result.summary())
    return 1 if result.errors else 0


if __name__ == "__main__":
    sys.exit(main())
