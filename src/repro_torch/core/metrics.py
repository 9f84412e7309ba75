"""Simulation reports and the paper's performance metrics (Sect. 4.1).

- MTEPS (Graph500): |E| / t_exec — normalised to graph size.
- MREPS: edges *read during execution* / t_exec — raw edge processing rate.
- bytes/edge, values read per iteration, edges read per iteration,
  iterations — the four critical metrics of Fig. 9.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.engine import TimingReport


@dataclasses.dataclass
class IterationStats:
    edges_read: int = 0
    values_read: int = 0  # number of vertex-value reads (4B each pre-coalesce)
    values_written: int = 0
    updates_read: int = 0
    updates_written: int = 0
    partitions_skipped: int = 0
    partitions_total: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "IterationStats":
        return IterationStats(**d)


@dataclasses.dataclass
class SimReport:
    accelerator: str
    graph: str
    problem: str
    dram: str
    n: int
    m: int
    timing: TimingReport
    iterations: int
    per_iteration: list[IterationStats]
    values: np.ndarray | None = None  # final vertex values (for validation)
    # graph-layout record (repro_torch.graph.layout): reorder, interval_scale,
    # effective_interval (what the partitioner actually used — ForeGraph may
    # clamp), balance (edges/partition min/max/cv, shard_fill for ForeGraph)
    layout: dict | None = None

    @property
    def runtime_s(self) -> float:
        return self.timing.time_ns * 1e-9

    @property
    def mteps(self) -> float:
        return self.m / max(self.timing.time_ns * 1e-3, 1e-12)  # |E| / us == MTEPS

    @property
    def edges_read_total(self) -> int:
        return sum(s.edges_read for s in self.per_iteration)

    @property
    def values_read_total(self) -> int:
        return sum(s.values_read for s in self.per_iteration)

    @property
    def mreps(self) -> float:
        return self.edges_read_total / max(self.timing.time_ns * 1e-3, 1e-12)

    @property
    def bytes_per_edge(self) -> float:
        """Total off-chip traffic per |E| (Fig. 9(b))."""
        return self.timing.bytes_total / max(self.m, 1)

    @property
    def edges_read_per_iteration(self) -> float:
        return self.edges_read_total / max(self.iterations, 1)

    @property
    def values_read_per_iteration(self) -> float:
        return self.values_read_total / max(self.iterations, 1)

    @property
    def partitions_skipped_total(self) -> int:
        return sum(s.partitions_skipped for s in self.per_iteration)

    def to_dict(self, include_values: bool = False) -> dict:
        """JSON-serialisable dict; round-trips via ``from_dict``.

        ``values`` (the final vertex array) is excluded by default — it is
        O(n) and only needed for semantic validation, not for performance
        reporting or the sweep result cache."""
        return dict(
            accelerator=self.accelerator,
            graph=self.graph,
            problem=self.problem,
            dram=self.dram,
            n=self.n,
            m=self.m,
            timing=self.timing.to_dict(),
            iterations=self.iterations,
            per_iteration=[s.to_dict() for s in self.per_iteration],
            values=(
                np.asarray(self.values).tolist()
                if include_values and self.values is not None
                else None
            ),
            layout=self.layout,
        )

    @staticmethod
    def from_dict(d: dict) -> "SimReport":
        values = d.get("values")
        return SimReport(
            accelerator=d["accelerator"],
            graph=d["graph"],
            problem=d["problem"],
            dram=d["dram"],
            n=d["n"],
            m=d["m"],
            timing=TimingReport.from_dict(d["timing"]),
            iterations=d["iterations"],
            per_iteration=[IterationStats.from_dict(s) for s in d["per_iteration"]],
            values=np.asarray(values, dtype=np.float32) if values is not None else None,
            layout=d.get("layout"),  # absent in pre-layout-layer records
        )

    def row(self) -> dict:
        lay = self.layout or {}
        balance = lay.get("balance") or {}
        return dict(
            accelerator=self.accelerator,
            graph=self.graph,
            problem=self.problem,
            dram=self.dram,
            runtime_s=self.runtime_s,
            mteps=self.mteps,
            mreps=self.mreps,
            iterations=self.iterations,
            bytes_per_edge=self.bytes_per_edge,
            row_hits=self.timing.hits,
            row_misses=self.timing.misses,
            row_conflicts=self.timing.conflicts,
            bw_utilization=self.timing.bw_utilization,
            reorder=lay.get("reorder", "identity"),
            interval_scale=lay.get("interval_scale", 1),
            effective_interval=lay.get("effective_interval"),
            partitions=balance.get("partitions"),
            edges_per_partition_cv=balance.get("edges_cv"),
            partitions_skipped=self.partitions_skipped_total,
        )
