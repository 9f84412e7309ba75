"""Shared machinery for accelerator models.

Semantic execution runs host-side in numpy by default (this mirrors the
paper's C++ simulation environment: trace generation is itself an offline
preprocessing step) or, with ``AccelConfig(semexec="device")``, as PyTorch
steps on the device (``repro_torch.core.semexec``), while DRAM timing runs
through the CUDA timing kernel on the card (its plain PyTorch version on
the CPU).

Timing is batched: ``simulate_phased`` collects every (phase, channel)
trace, dispatches them through :func:`repro_torch.core.engine.simulate_batch` in
one kernel launch per length bucket, and scatters the per-trace
reports back into the per-phase barrier semantics (sum over phases of the
max over channels).  ``Accelerator.prepare`` exposes the semantic half on
its own so a sweep runner can batch timing *across* scenarios
(:class:`PendingRun` + ``finalize``).
"""
from __future__ import annotations

import abc
import dataclasses

import numpy as np
import torch

from repro_torch.core.dram import DRAMConfig, dram_config
from repro_torch.core.engine import (
    SCAN_CUTOFF,
    TimingReport,
    simulate_batch,
    simulate_sequential,
)
from repro_torch.core import semexec
from repro_torch.core.hostcache import ARTIFACTS, SEMANTICS
from repro_torch.core.metrics import IterationStats, SimReport
from repro_torch.core.trace import Trace, split_round_robin
from repro_torch.kernels._platform import resolve_device
from repro_torch.graph.layout import (
    relabel_graph,
    relabel_values,
    undo_relabel,
    validate_interval_scale,
    validate_reorder,
)
from repro_torch.graph.problems import Problem
from repro_torch.graph.structure import Graph

INF = np.float32(np.inf)


@dataclasses.dataclass(frozen=True)
class AccelConfig:
    """Accelerator-model configuration.

    interval_size: vertices per interval (the scaled BRAM capacity).
    n_pes: processing elements (ForeGraph) / channels (HitGraph, ThunderGP).
    optimizations: which of the accelerator's optimizations are on.  "all"
      enables every optimization the accelerator proposes (paper default).
    engine: DRAM engine selection ("auto" | "scan" | "fast").
    reorder: vertex reordering applied before partitioning
      ("identity" | "degree" | "random" | "bfs" — repro_torch.graph.layout);
      results are mapped back to original ids, so semantics are unchanged.
    interval_scale: power-of-two multiplier on ``interval_size`` (the
      partition-granularity sweep axis; ``effective_interval`` is the
      product the partitioners actually see).
    semexec: semantic execution engine ("numpy" | "device") — where the
      per-iteration graph semantics run (repro_torch.core.semexec).
      "device" runs them on the entry point's device and falls back to
      numpy (with a warning) for pairs without a device formulation; the
      resolved engine is recorded in the run layout.
    """

    interval_size: int = 16384
    n_pes: int = 1
    optimizations: frozenset = frozenset({"all"})
    engine: str = "auto"
    max_iters: int = 4000
    scan_cutoff: int = SCAN_CUTOFF
    reorder: str = "identity"
    interval_scale: int = 1
    semexec: str = "numpy"

    def __post_init__(self):
        validate_reorder(self.reorder)
        validate_interval_scale(self.interval_scale)
        semexec.validate_engine(self.semexec)

    @property
    def effective_interval(self) -> int:
        """The interval size the partitioners see: base size x scale."""
        return self.interval_size * self.interval_scale

    def has(self, opt: str) -> bool:
        return "all" in self.optimizations or opt in self.optimizations

    # Fields that only affect DRAM timing, never the semantic execution;
    # every OTHER field (including ones added later) splits the semantic
    # cache, so a new semantics-relevant knob can never alias stale entries.
    _TIMING_ONLY_FIELDS = ("engine", "scan_cutoff")
    # Fields resolved per (accelerator, problem) before execution; prepare
    # appends the RESOLVED value to the semantic cache key instead, so a
    # requested "device" that falls back to numpy shares the numpy entry.
    _RESOLVED_FIELDS = ("semexec",)

    def semantic_key(self) -> tuple:
        """The config fields that determine a semantic execution (values,
        iterations, traces) — everything except the DRAM timing knobs and
        the per-problem resolved fields (appended post-resolution)."""
        key = []
        for f in dataclasses.fields(self):
            if f.name in self._TIMING_ONLY_FIELDS + self._RESOLVED_FIELDS:
                continue
            v = getattr(self, f.name)
            key.append(tuple(sorted(v)) if isinstance(v, frozenset) else v)
        return tuple(key)


@dataclasses.dataclass
class PhasedTrace:
    """Traces organised as [phase][channel]; phases are barriers (an
    iteration, or a scatter/gather phase within one)."""

    phases: list[list[Trace]] = dataclasses.field(default_factory=list)

    def add_phase(self, channel_traces: list[Trace]):
        if any(t.n for t in channel_traces):
            self.phases.append(channel_traces)

    def flatten(self) -> tuple[list[Trace], list[int]]:
        """The non-empty traces in (phase, channel) order, with each one's
        phase index — the batch the timing engine dispatches at once."""
        traces: list[Trace] = []
        phase_of: list[int] = []
        for pi, channel_traces in enumerate(self.phases):
            for tr in channel_traces:
                if tr.n:
                    traces.append(tr)
                    phase_of.append(pi)
        return traces, phase_of


def _assemble_phased(
    pt: PhasedTrace, phase_of: list[int], reports: list[TimingReport],
    cfg: DRAMConfig,
) -> TimingReport:
    """Scatter per-trace reports back into the barrier semantics: time =
    sum over phases of (max over that phase's channels); stats summed."""
    total = TimingReport.zero()
    phase_time = np.zeros(len(pt.phases), dtype=np.float64)
    for pi, r in zip(phase_of, reports):
        phase_time[pi] = max(phase_time[pi], r.time_ns)
        total.hits += r.hits
        total.misses += r.misses
        total.conflicts += r.conflicts
        total.bytes_total += r.bytes_total
        total.bytes_read += r.bytes_read
        total.bytes_written += r.bytes_written
        total.requests += r.requests
    time_ns = float(sum(phase_time.tolist()))
    total.time_ns = time_ns
    total.cycles = int(time_ns / cfg.tCK_ns) if time_ns else 0
    # actual channels used: the widest phase, counting non-empty traces only
    # (same denominator as simulate_dram).
    total.channels_used = max(
        (sum(1 for t in p if t.n) for p in pt.phases), default=0
    )
    peak = time_ns * cfg.bw_per_channel * max(total.channels_used, 1)
    total.bw_utilization = total.bytes_total / max(peak, 1e-9)
    return total


def expand_pseudo_channels(
    pt: PhasedTrace, cfg: DRAMConfig
) -> tuple[PhasedTrace, DRAMConfig]:
    """Resolve HBM pseudo-channel mode at the trace level: each channel
    trace is dealt across two pseudo-channels (lazy strided split at the
    mapping's channel-interleave granularity) and the config becomes the
    per-pseudo-channel view (half bus width, half banks).  Identity when
    the mode is off.  After expansion, "channels" everywhere downstream
    (phase max, channels_used, bw denominator) means pseudo-channels."""
    if not cfg.pseudo_channels:
        return pt, cfg
    g = cfg.mapping.channel_lines
    out = PhasedTrace()
    for channel_traces in pt.phases:
        # append directly: a non-empty phase stays non-empty after the
        # deal, and phase alignment must be preserved exactly
        out.phases.append(
            [pc for tr in channel_traces for pc in split_round_robin(tr, 2, g)]
        )
    return out, cfg.pseudo_channel_view()


def simulate_phased(
    pt: PhasedTrace, cfg: DRAMConfig, accel_cfg: AccelConfig,
    batched: bool = True, device=None,
) -> TimingReport:
    """Time = sum over phases of (max over channels); stats summed.

    ``batched=True`` (default) collects all phase/channel traces into one
    grouped dispatch; ``batched=False`` keeps the historical one-dispatch-
    per-trace path.  Both produce identical reports.
    """
    dev = resolve_device(device)
    pt, cfg = expand_pseudo_channels(pt, cfg)
    traces, phase_of = pt.flatten()
    if batched:
        reports = simulate_batch(traces, cfg, engine=accel_cfg.engine,
                                 scan_cutoff=accel_cfg.scan_cutoff, device=dev)
    else:
        reports = simulate_sequential(traces, cfg, accel_cfg.engine,
                                      accel_cfg.scan_cutoff, dev)
    return _assemble_phased(pt, phase_of, reports, cfg)


@dataclasses.dataclass
class PendingRun:
    """A completed semantic execution awaiting DRAM timing.

    Produced by ``Accelerator.prepare``; ``traces()`` exposes the flat
    trace list so callers (e.g. the sweep runner's batch mode) can time
    traces from many runs in one grouped dispatch, then ``finalize`` each
    run with its slice of per-trace reports.
    """

    accelerator: str
    graph: str
    problem: str
    dram: DRAMConfig
    config: AccelConfig
    n: int
    m: int
    values: np.ndarray
    iterations: int
    pt: PhasedTrace
    stats: list[IterationStats]
    # layout record: reorder, interval_scale, effective_interval (the
    # interval the partitioner actually used) and partition balance metrics
    layout: dict = dataclasses.field(default_factory=dict)

    def traces(self) -> list[Trace]:
        return self.pt.flatten()[0]

    def finalize(self, reports: list[TimingReport] | None = None,
                 device=None) -> SimReport:
        """Assemble the SimReport; ``reports`` must match ``traces()``
        one-to-one (omitted: simulate here, batched, on ``device``)."""
        traces, phase_of = self.pt.flatten()
        if reports is None:
            reports = simulate_batch(traces, self.dram, engine=self.config.engine,
                                     scan_cutoff=self.config.scan_cutoff,
                                     device=device)
        assert len(reports) == len(traces)
        timing = _assemble_phased(self.pt, phase_of, reports, self.dram)
        return SimReport(
            accelerator=self.accelerator,
            graph=self.graph,
            problem=self.problem,
            dram=self.dram.name,
            n=self.n,
            m=self.m,
            timing=timing,
            iterations=self.iterations,
            per_iteration=self.stats,
            values=self.values,
            layout=self.layout,
        )


class Accelerator(abc.ABC):
    """Base accelerator model.

    Subclasses implement ``_execute`` which performs the semantic iteration
    under the accelerator's scheme and fills a PhasedTrace + IterationStats,
    plus a small ``extras`` dict (effective interval, partition balance).
    """

    name: str = "base"
    default_dram: str = "default"
    supports_weights: bool = False
    supports_multichannel: bool = False

    def __init__(self, config: AccelConfig | None = None):
        self.config = config or AccelConfig()

    @abc.abstractmethod
    def _execute(
        self, g: Graph, problem: Problem, root: int,
        init: np.ndarray | None = None, engine: str = "numpy",
        device: torch.device | None = None,
    ) -> tuple[np.ndarray, int, PhasedTrace, list[IterationStats], dict]:
        """``init`` overrides ``problem.init_values`` — the layout layer
        passes the original-space initial values carried through the vertex
        relabeling, so per-vertex payloads (SpMV's x vector, WCC's id
        labels) follow their vertices instead of their slots.  ``engine``
        is the RESOLVED semantic engine ("numpy" | "device") — callers go
        through ``prepare``, which resolves ``config.semexec`` — and
        ``device`` the resolved device the ``device`` engine runs on."""
        ...

    def prepare(
        self,
        g: Graph,
        problem: Problem,
        root: int = 0,
        dram: DRAMConfig | str | None = None,
        device=None,
    ) -> PendingRun:
        """Run the semantic half (trace assembly) only; the returned
        :class:`PendingRun` carries everything ``finalize`` needs once the
        DRAM timing reports exist.

        Both halves of the host preprocessing are cached per process: the
        prepared (symmetrised/weighted) graph by content fingerprint, and
        the whole semantic execution by (graph, problem, root, semantic
        config) — it is DRAM-independent, so a DDR3/DDR4/HBM sweep of one
        scenario assembles traces once.

        The layout axis resolves here: a non-identity ``config.reorder``
        relabels the prepared graph (and the root) before ``_execute`` and
        maps the final values back to original ids afterwards, so callers
        compare against ``reference_solve`` unchanged.  The relabeled graph
        carries its own content fingerprint, so reordered partition indices
        and semantic executions cache independently of the identity layout.

        ``device`` is read only when the resolved engine is ``device``
        (``None``: the CUDA card, raising when there is none), so the numpy
        engine needs no card.  Its device joins the semantic cache key: a
        CUDA run never reuses a CPU execution, and acc values, which agree
        across devices only to tolerance, never alias."""
        if problem.needs_weights and not self.supports_weights:
            raise ValueError(f"{self.name} does not support weighted problems")
        if isinstance(dram, str):
            dram = dram_config(dram)
        dram = dram or dram_config(self.default_dram)
        gp = ARTIFACTS.get_or_build(
            (g.fingerprint, "prepared", problem.name),
            lambda: problem.prepare_graph(g),
        )
        perm = None
        gx, root_x = gp, root
        if self.config.reorder != "identity":
            gx, perm = relabel_graph(gp, self.config.reorder)
            root_x = int(perm[root])
        engine = semexec.resolve_engine(self.name, problem.name,
                                        self.config.semexec)
        dev = resolve_device(device) if engine == "device" else None

        def execute():
            # per-vertex initial payloads (SpMV's x, WCC's labels) must
            # follow their vertices through the relabeling; built inside
            # the cache miss so a SEMANTICS hit pays no O(n) init work
            init = None
            if perm is not None:
                init = relabel_values(problem.init_values(gp, root), perm)
            return self._execute(gx, problem, root_x, init, engine, dev)

        values, iters, pt, stats, extras = SEMANTICS.get_or_build(
            (gx.fingerprint, self.name, problem.name, root_x,
             self.config.semantic_key(), engine)
            + ((str(dev),) if dev is not None else ()),
            execute,
        )
        # hand out copies of the mutable pieces: a caller mutating
        # report.values, an IterationStats or a balance dict must not
        # corrupt the cached execution (the PhasedTrace is shared — trace
        # nodes are immutable); undo_relabel's gather already allocates
        stats = [dataclasses.replace(s) for s in stats]
        if perm is not None:
            values = undo_relabel(values, perm, problem.name)
        else:
            values = values.copy()
        layout = dict(reorder=self.config.reorder,
                      interval_scale=self.config.interval_scale,
                      engine=engine,
                      **{k: dict(v) if isinstance(v, dict) else v
                         for k, v in extras.items()})
        # pseudo-channel mode resolves here, so PendingRun.traces() and
        # PendingRun.dram are consistent for external batchers (the sweep
        # runner times traces() against dram directly)
        pt, dram = expand_pseudo_channels(pt, dram)
        return PendingRun(
            accelerator=self.name,
            graph=g.name,
            problem=problem.name,
            dram=dram,
            config=self.config,
            n=gp.n,
            m=gp.m,
            values=values,
            iterations=iters,
            pt=pt,
            stats=stats,
            layout=layout,
        )

    def run(
        self,
        g: Graph,
        problem: Problem,
        root: int = 0,
        dram: DRAMConfig | str | None = None,
        device=None,
    ) -> SimReport:
        dev = resolve_device(device)  # raise before the semantic half runs
        return self.prepare(g, problem, root=root, dram=dram,
                            device=dev).finalize(device=dev)


def run_accelerator(
    name: str,
    g: Graph,
    problem: Problem,
    root: int = 0,
    dram: str | DRAMConfig | None = None,
    config: AccelConfig | None = None,
    device=None,
) -> SimReport:
    """One scenario in, one SimReport out, on ``device`` (``None``: the
    CUDA card, raising when there is none): DRAM timing, and the semantics
    too under ``semexec="device"``."""
    from repro_torch.core.accelerators import ACCELERATORS

    cls = ACCELERATORS[name]
    return cls(config).run(g, problem, root=root, dram=dram, device=device)
