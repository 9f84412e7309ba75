"""Aggregation of sweep results into flat row dicts + CSV/JSON export.

Rows are deterministic functions of the simulation results (no wall-clock,
no cache status), so a cached re-run, a serial run and a parallel run of the
same spec all yield byte-identical exports.  The rank / Spearman helpers the
paper-validation benches use live here as well.
"""
from __future__ import annotations

import csv
import json
import os

import numpy as np

from repro_torch.sweep.runner import SweepResult


def scenario_row(scenario, record: dict, status: str | None = None) -> dict | None:
    """One scenario's flat result row from its execution record — THE row
    shape of every export surface (CLI CSV/JSON, the benches), with the
    reference's columns, names and order (``repro/sweep/results.py``).

    ``status`` adds the ok/cached/error column.  Error records become rows
    with an ``error`` column; a record with neither report nor error yields
    ``None`` (caller decides whether to keep it)."""
    from repro_torch.core.metrics import SimReport

    s = scenario
    row = dict(
        graph=s.graph.name,
        accelerator=s.accelerator,
        problem=s.problem,
        dram=s.dram.name,
        channels=s.dram.channels,
        address_mapping=s.dram.mapping.label,
        page_policy=s.dram.page_policy,
        pseudo_channels=int(s.dram.pseudo_channels),
        reorder=s.config.reorder,
        interval_scale=s.config.interval_scale,
        engine=s.config.semexec,  # requested; overridden by resolved below
        label=s.label,
    )
    if status is not None:
        row["status"] = status
    rep = (SimReport.from_dict(record["report"])
           if record.get("status") in ("ok", "cached") or "report" in record
           else None)
    if rep is not None:
        gs = record.get("graph_stats", {})
        lay = rep.layout or {}
        balance = lay.get("balance") or {}
        if lay.get("engine"):
            row["engine"] = lay["engine"]  # engine that actually ran
        row.update(
            n=rep.n,
            m=rep.m,
            runtime_s=rep.runtime_s,
            mteps=rep.mteps,
            mreps=rep.mreps,
            iterations=rep.iterations,
            bytes_per_edge=rep.bytes_per_edge,
            values_read_per_iteration=rep.values_read_per_iteration,
            edges_read_per_iteration=rep.edges_read_per_iteration,
            row_hits=rep.timing.hits,
            row_misses=rep.timing.misses,
            row_conflicts=rep.timing.conflicts,
            bw_utilization=rep.timing.bw_utilization,
            avg_degree=gs.get("avg_degree"),
            degree_skewness=gs.get("degree_skewness"),
            # graph-layout columns (None on records predating the layer)
            effective_interval=lay.get("effective_interval"),
            partitions=balance.get("partitions"),
            edges_per_partition_min=balance.get("edges_min"),
            edges_per_partition_max=balance.get("edges_max"),
            edges_per_partition_cv=balance.get("edges_cv"),
            shard_fill=balance.get("shard_fill"),
            partitions_skipped=rep.partitions_skipped_total,
        )
    elif "error" in record or record.get("status") == "error":
        err = (record.get("error") or "").strip()
        row["error"] = err.splitlines()[-1] if err else "unknown error"
        # retry/fault audit trail: how many attempts ran, what the final
        # one died of, and whether the scenario was quarantined as poison
        if "attempts" in record:
            row["attempts"] = record["attempts"]
        if "last_error" in record:
            row["last_error"] = record["last_error"]
        if record.get("poison"):
            row["poison"] = True
    else:
        return None
    if record.get("timeout_enforced") is False:
        # the policy asked for a per-scenario bound but SIGALRM was not
        # available (non-main-thread execution): the row says so
        row["timeout_enforced"] = False
    return row


def result_rows(
    result: SweepResult,
    include_errors: bool = True,
    with_status: bool = False,
) -> list[dict]:
    """One flat dict per scenario, in spec expansion order.

    ``with_status`` adds the ok/cached/error column (useful interactively;
    off by default so cached re-runs export identical bytes)."""
    rows = []
    for r in result.results:
        if r.status == "error" and not include_errors:
            continue
        row = scenario_row(r.scenario, r.record,
                           status=r.status if with_status else None)
        if row is not None:
            rows.append(row)
    return rows


def write_csv(path: str, rows: list[dict]) -> None:
    """Write rows with the union of all keys (error rows lack metric
    columns); missing cells are left empty."""
    if not rows:
        return
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    keys: list[str] = []
    for r in rows:
        for k in r:
            if k not in keys:
                keys.append(k)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys, restval="")
        w.writeheader()
        w.writerows(rows)


def write_json(path: str, rows: list[dict]) -> None:
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)


# ---- validation helpers (paper rank-agreement checks) ----------------------


def rank(values: dict) -> list:
    """Keys ordered by ascending value (runtime ranking)."""
    return sorted(values, key=lambda k: values[k])


def spearman(a: list, b: list) -> float:
    """Spearman rank correlation of two orderings of the same key set."""
    ra = {k: i for i, k in enumerate(a)}
    rb = {k: i for i, k in enumerate(b)}
    keys = list(ra)
    x = np.array([ra[k] for k in keys], float)
    y = np.array([rb[k] for k in keys], float)
    if x.std() == 0 or y.std() == 0:
        return 1.0
    return float(np.corrcoef(x, y)[0, 1])
