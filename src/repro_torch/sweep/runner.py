"""Sweep executor: cache short-circuit, parallel workers, failure isolation.

Execution pipeline per :class:`SweepSpec`:

1. expand the spec into scenarios (+ invalid combinations, pre-filtered),
2. look every scenario up in the content-addressed cache — hits are
   returned without simulating anything,
3. execute the misses, serially or on a ``ProcessPoolExecutor`` (spawn
   context: a CUDA context does not survive a fork), deduplicating
   identical scenarios,
4. record each execution in the cache (errors are *not* cached, so a fixed
   bug re-runs its scenarios on the next sweep).

One failing scenario becomes an ``error`` row with its traceback; the sweep
continues.  Result order is the spec's expansion order, independent of
completion order, so ``--workers N`` yields byte-identical result rows to a
serial run.

Two execution modes (``mode=``):

- ``"scenario"`` — each scenario times its own traces (a few kernel
  launches per scenario, one per length bucket).
- ``"batch"`` — scenarios in a worker's chunk run their *semantic* halves
  first (``Accelerator.prepare``), then every DRAM trace of the whole
  chunk is timed through ``repro_torch.core.engine.simulate_many`` in a
  handful of grouped launches (one per timing-config x length-bucket), and
  the per-trace reports are scattered back into each scenario's report.
  Results are identical to scenario mode; only the launch count and
  wall time differ.

Every entry point takes ``device=None``: the CUDA card, raising when there
is none (``repro_torch.kernels._platform.resolve_device``); ``"cpu"``
takes the kernels' plain versions.  The device is resolved before any
scenario runs and crosses into spawn workers as a string (``"cuda"``,
``"cuda:0"``, ``"cpu"``) that each worker resolves again, so a worker
without the card fails its chunk instead of running elsewhere.  The
device is not part of a record's cache key: records are equal on every
device.
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import random
import signal
import threading
import time
import traceback
from concurrent.futures import ProcessPoolExecutor, as_completed
from typing import Callable

import torch

from repro_torch.core.hostcache import stats_all
from repro_torch.core.metrics import SimReport
from repro_torch.graph.generators import GraphSpec
from repro_torch.graph.problems import PROBLEMS
from repro_torch.graph.structure import Graph
from repro_torch.kernels._platform import resolve_device
from repro_torch.sweep.cache import ResultCache, scenario_hash
from repro_torch.sweep.spec import Scenario, Skipped, SweepSpec

# Per-process graph memo: workers (and serial runs) build each GraphSpec
# once even when it appears in many scenarios (GraphSpec is frozen and
# seeded, so the spec IS the graph's canonical identity).  Downstream
# host artifacts — prepared graphs, partition indices, per-partition
# routing, semantic executions (which hold device tensors under the
# ``device`` engine, keyed on the device) — are likewise reused across the
# worker's scenarios through ``repro_torch.core.hostcache`` (keyed on graph content
# fingerprints + partitioning/config params), so scenarios differing only
# in the accelerator or DRAM axes skip the offline preprocessing.
_GRAPHS: dict[GraphSpec, Graph] = {}


def _graph(spec: GraphSpec) -> Graph:
    g = _GRAPHS.get(spec)
    if g is None:
        g = _GRAPHS[spec] = spec.build()
    return g


def _graph_stats(g) -> dict:
    return dict(
        n=g.n,
        m=g.m,
        avg_degree=g.avg_degree,
        degree_skewness=g.degree_skewness,
    )


def _ok_record(rep, graph_stats: dict, wall_s: float) -> dict:
    return dict(
        status="ok",
        report=rep.to_dict(),
        graph_stats=graph_stats,
        wall_s=round(wall_s, 3),
    )


def _error_record(t0: float) -> dict:
    return dict(
        status="error",
        error=traceback.format_exc(),
        wall_s=round(time.time() - t0, 3),
    )


def execute_scenario(scenario: Scenario, with_trace_hash: bool = False,
                     device=None) -> dict:
    """Run one scenario on ``device`` (``None``: the CUDA card) to a
    plain-dict record.  Raises only when the device cannot be had; every
    failure of the simulation is isolated into an ``{"status": "error"}``
    record.

    ``with_trace_hash`` adds the golden trace-stream fingerprint
    (``repro_torch.core.trace.trace_stream_hash``, truncated like the
    checked-in baselines) to ok records.  It is auxiliary metadata, never
    part of result rows."""
    from repro_torch.core.accelerators import ACCELERATORS

    dev = resolve_device(device)
    t0 = time.time()
    try:
        g = _graph(scenario.graph)
        accel = ACCELERATORS[scenario.accelerator](scenario.config)
        pending = accel.prepare(g, PROBLEMS[scenario.problem],
                                root=scenario.root, dram=scenario.dram,
                                device=dev)
        rep = pending.finalize(device=dev)
        rec = _ok_record(rep, _graph_stats(g), time.time() - t0)
        if with_trace_hash:
            from repro_torch.core.trace import trace_stream_hash
            rec["trace_hash"] = trace_stream_hash(pending.traces())[:16]
        return rec
    except Exception:
        return _error_record(t0)


# ---- robustness policy: per-scenario timeout + bounded retry ---------------


@dataclasses.dataclass(frozen=True)
class ExecutionPolicy:
    """Robustness knobs of the sweep runner (the reference's sweep server
    shares them; the port does not carry that server yet).

    timeout_s: best-effort per-scenario wall-clock bound (SIGALRM-based, so
      it needs the executing thread to be the process main thread — true for
      serial runs and spawn-pool workers; elsewhere it is skipped and the
      record carries ``timeout_enforced: false`` so rows stay honest about
      policy coverage).  A long C-level call delays delivery until control
      returns to the interpreter.  A previously armed ITIMER_REAL is
      restored (minus elapsed time) on the way out.
    retries: how many times a failed/timed-out scenario re-executes.
    backoff_s: base of the exponential retry backoff — see ``backoff_for``.
    fault_plan: optional :class:`repro_torch.distributed.faults.FaultPlan`
      consulted per attempt at the ``"scenario"`` site (tests and the chaos
      bench exercise the retry machinery through it; pickles to workers).
    """

    timeout_s: float | None = None
    retries: int = 0
    backoff_s: float = 0.25
    fault_plan: "object | None" = None

    def __post_init__(self):
        if self.timeout_s is not None and self.timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {self.timeout_s}")
        if self.retries < 0:
            raise ValueError(f"retries must be >= 0, got {self.retries}")
        if self.backoff_s < 0:
            raise ValueError(f"backoff_s must be >= 0, got {self.backoff_s}")

    @property
    def is_default(self) -> bool:
        return (self.timeout_s is None and self.retries == 0
                and self.fault_plan is None)

    def backoff_for(self, attempt: int, key: str = "") -> float:
        """Sleep before retry ``attempt`` (1-based): exponential in the
        attempt, with *deterministic* jitter in ``[0.5, 1.5)`` seeded from
        the scenario key — retried scenarios desynchronise (no thundering
        herd after a shared failure) yet every re-run of the same sweep
        sleeps the same schedule, keeping runs reproducible."""
        base = self.backoff_s * (2 ** (attempt - 1))
        return base * (0.5 + random.Random(f"{key}:{attempt}").random())


class ScenarioTimeout(BaseException):
    """Raised by the SIGALRM handler; derives from BaseException so the
    blanket ``except Exception`` failure isolation inside
    ``execute_scenario`` cannot swallow it."""


def _execute_with_timeout(scenario: Scenario, timeout_s: float | None,
                          with_trace_hash: bool, device: torch.device) -> dict:
    if timeout_s is None:
        return execute_scenario(scenario, with_trace_hash=with_trace_hash,
                                device=device)
    if threading.current_thread() is not threading.main_thread():
        # SIGALRM only fires on the main thread; the scenario runs
        # unbounded, and the record says so (``timeout_enforced: false``
        # flows into the exported row) instead of silently claiming the
        # policy's bound was applied.
        rec = execute_scenario(scenario, with_trace_hash=with_trace_hash,
                               device=device)
        rec["timeout_enforced"] = False
        return rec

    def on_alarm(signum, frame):
        raise ScenarioTimeout

    t0 = time.time()
    t0_mono = time.monotonic()
    old_handler = signal.signal(signal.SIGALRM, on_alarm)
    # setitimer returns the timer it displaced; a caller further up the
    # stack (nested policied execution, a host harness with its own alarm)
    # may have one pending, and it must survive us
    old_delay, old_interval = signal.setitimer(signal.ITIMER_REAL, timeout_s)
    try:
        try:
            return execute_scenario(scenario, with_trace_hash=with_trace_hash,
                                    device=device)
        except ScenarioTimeout:
            if device.type == "cuda":
                # launches the interrupted scenario left queued finish
                # here, so their time is not charged to the next scenario
                torch.cuda.synchronize(device)
            return dict(
                status="error",
                error=(f"scenario timed out after {timeout_s}s "
                       f"(--timeout-per-scenario)"),
                timed_out=True,
                wall_s=round(time.time() - t0, 3),
            )
    finally:
        # disarm before the old handler comes back, so a late alarm of
        # ours can never invoke it
        signal.setitimer(signal.ITIMER_REAL, 0.0)
        signal.signal(signal.SIGALRM, old_handler)
        if old_delay:
            remaining = max(old_delay - (time.monotonic() - t0_mono), 1e-6)
            signal.setitimer(signal.ITIMER_REAL, remaining, old_interval)


def execute_scenario_policied(
    scenario: Scenario,
    policy: ExecutionPolicy | None = None,
    with_trace_hash: bool = False,
    device=None,
) -> dict:
    """``execute_scenario`` under an :class:`ExecutionPolicy`: best-effort
    timeout, then bounded retry with exponential, deterministically
    jittered backoff (``ExecutionPolicy.backoff_for``).  The returned
    record carries ``attempts`` (and on failure ``last_error``, the final
    attempt's one-line cause, plus ``timed_out`` when that attempt hit the
    timeout) so retried scenarios stay auditable in exported rows; like
    all error records it is never cached.  ``device`` as for
    :func:`execute_scenario`."""
    dev = resolve_device(device)
    if policy is None or policy.is_default:
        rec = execute_scenario(scenario, with_trace_hash=with_trace_hash,
                               device=dev)
        if policy is not None:
            rec["attempts"] = 1
        return rec
    rec: dict = {}
    for attempt in range(policy.retries + 1):
        if attempt:
            time.sleep(policy.backoff_for(attempt,
                                          key=scenario.scenario_id))
        rec = _attempt_with_faults(scenario, policy, attempt,
                                   with_trace_hash, dev)
        rec["attempts"] = attempt + 1
        if rec["status"] == "ok":
            break
    if rec.get("status") == "error" and rec.get("error"):
        rec["last_error"] = rec["error"].strip().splitlines()[-1]
    return rec


def _attempt_with_faults(scenario: Scenario, policy: ExecutionPolicy,
                         attempt: int, with_trace_hash: bool,
                         device: torch.device) -> dict:
    """One policied attempt, with the policy's fault plan (if any) consulted
    first: ``error`` injects a synthetic failure record (driving the retry
    path without touching the simulator); crash/hang/stall/delay apply as
    process-level pre-work faults."""
    if policy.fault_plan is not None:
        from repro_torch.distributed import faults

        action = policy.fault_plan.action("scenario", index=attempt,
                                          keys=(scenario.scenario_id,))
        if action is not None:
            if action.kind == "error":
                return dict(status="error",
                            error=f"injected fault: {action.note}",
                            injected=True, wall_s=0.0)
            faults.apply_pre(action)
    return _execute_with_timeout(scenario, policy.timeout_s, with_trace_hash,
                                 device)


def execute_scenarios_batch(scenarios: list[Scenario],
                            with_trace_hash: bool = False,
                            device=None) -> list[dict]:
    """Run a chunk of scenarios on ``device`` with cross-scenario batched
    DRAM timing.

    All scenarios' semantic halves (``Accelerator.prepare``) run first;
    the chunk's traces are then timed in one ``simulate_many`` pass (one
    kernel launch per timing-config x length-bucket group) and scattered
    back.  Per-scenario failures are isolated exactly like
    ``execute_scenario``; a failure inside the shared timing pass falls
    back to per-scenario finalization on the same device, and every record
    of the chunk then carries ``timing_fallback``, so one bad trace batch
    cannot poison the chunk and the lost batching stays visible.  Records
    (and therefore reports) are identical to scenario-mode execution.
    """
    from repro_torch.core.accelerators import ACCELERATORS
    from repro_torch.core.engine import simulate_many

    dev = resolve_device(device)

    records: list[dict | None] = [None] * len(scenarios)
    prepared: list[tuple | None] = [None] * len(scenarios)
    hashes: list[str | None] = [None] * len(scenarios)
    for i, s in enumerate(scenarios):
        t0 = time.time()
        try:
            g = _graph(s.graph)
            accel = ACCELERATORS[s.accelerator](s.config)
            pending = accel.prepare(g, PROBLEMS[s.problem], root=s.root,
                                    dram=s.dram, device=dev)
            if with_trace_hash:
                from repro_torch.core.trace import trace_stream_hash
                hashes[i] = trace_stream_hash(pending.traces())[:16]
            # only the scalar stats are kept: the chunk must not pin every
            # graph's edge arrays until the last finalize
            prepared[i] = (pending, pending.traces(), _graph_stats(g),
                           time.time() - t0)
        except Exception:
            records[i] = _error_record(t0)

    items = []
    for p in prepared:
        if p is not None:
            pending, traces, _, _ = p
            items += [(tr, pending.dram, pending.config.engine,
                       pending.config.scan_cutoff) for tr in traces]
    timing_fallback = None
    try:
        t_sim = time.time()
        reports = simulate_many(items, device=dev)
        sim_share = (time.time() - t_sim) / max(len(items), 1)
    except Exception:
        reports = None  # grouped pass failed: fall back per scenario
        sim_share = 0.0
        # surface the degradation: results stay correct but the batched
        # dispatch win is gone, which must be visible in the records
        timing_fallback = traceback.format_exc(limit=3)

    offset = 0
    for i, p in enumerate(prepared):
        if p is None:
            continue
        pending, traces, gstats, prep_wall = p
        t_fin = time.time()
        try:
            if reports is None:
                rep = pending.finalize(device=dev)
            else:
                rep = pending.finalize(reports[offset : offset + len(traces)])
            # wall_s = own prepare + amortised share of the shared timing
            # pass + own finalize (comparable to scenario-mode wall_s)
            wall = prep_wall + sim_share * len(traces) + (time.time() - t_fin)
            records[i] = _ok_record(rep, gstats, wall)
            if hashes[i] is not None:
                records[i]["trace_hash"] = hashes[i]
            if timing_fallback is not None:
                records[i]["timing_fallback"] = timing_fallback
        except Exception:
            records[i] = _error_record(t_fin - prep_wall)
        offset += len(traces)
    return records  # type: ignore[return-value]


def execute_chunk(
    scenarios: list[Scenario],
    mode: str = "scenario",
    policy: ExecutionPolicy | None = None,
    with_trace_hash: bool = False,
    device=None,
) -> list[dict]:
    """Execute one worker chunk under a mode + policy — the single entry
    point of the sweep pool (and of a server's workers).

    ``mode="batch"`` groups the chunk's DRAM traces into a few batched
    dispatches; a per-scenario ``timeout_s`` forces per-scenario execution
    (a shared timing pass has no per-scenario clock), and with plain
    ``retries`` the batch pass runs once and only its failed scenarios
    re-execute individually under the policy.  ``device`` as for
    :func:`execute_scenario`; a spawn worker receives it as a string."""
    dev = resolve_device(device)
    policy = policy or ExecutionPolicy()
    if mode == "batch" and len(scenarios) > 1 and policy.timeout_s is None:
        records = execute_scenarios_batch(scenarios,
                                          with_trace_hash=with_trace_hash,
                                          device=dev)
        if policy.retries:
            retry = dataclasses.replace(policy, retries=policy.retries - 1)
            for i, rec in enumerate(records):
                if rec["status"] == "error":
                    time.sleep(policy.backoff_for(
                        1, key=scenarios[i].scenario_id))
                    records[i] = execute_scenario_policied(
                        scenarios[i], retry, with_trace_hash=with_trace_hash,
                        device=dev)
                    records[i]["attempts"] += 1
        return records
    return [execute_scenario_policied(s, policy,
                                      with_trace_hash=with_trace_hash,
                                      device=dev)
            for s in scenarios]


# ---- planning: cache partition + exact dedup -------------------------------


@dataclasses.dataclass
class ScenarioPlan:
    """The schedulable shape of a scenario list against a result cache:
    which indices are already served (``cached``) and which content hashes
    still need executing (``pending_by_hash`` — every index sharing a hash
    rides on one execution).  ``run_sweep`` plans through here, as the
    reference's serve scheduler does, so in- and out-of-process execution
    can never disagree on cache keys or dedup."""

    scenarios: list[Scenario]
    hashes: list[str]
    cached: list[tuple[int, dict]]
    pending_by_hash: dict[str, list[int]]

    @property
    def unique_pending(self) -> list[str]:
        return list(self.pending_by_hash)

    @property
    def n_duplicates(self) -> int:
        """Scenario instances collapsed onto another identical one."""
        return sum(len(v) - 1 for v in self.pending_by_hash.values())


def plan_scenarios(scenarios: list[Scenario],
                   cache: ResultCache) -> ScenarioPlan:
    hashes = [scenario_hash(s) for s in scenarios]
    found = cache.lookup_many(hashes)  # one directory pass, not N opens
    cached: list[tuple[int, dict]] = []
    pending_by_hash: dict[str, list[int]] = {}
    for i, h in enumerate(hashes):
        rec = found.get(h)
        if rec is not None and rec.get("status") == "ok":
            cached.append((i, rec))
        else:
            pending_by_hash.setdefault(h, []).append(i)
    return ScenarioPlan(scenarios, hashes, cached, pending_by_hash)


@dataclasses.dataclass
class ScenarioResult:
    """One scenario's outcome: ``ok`` (executed), ``cached`` (served from the
    store), or ``error`` (isolated failure; ``record['error']`` holds the
    traceback)."""

    scenario: Scenario
    hash: str
    status: str  # ok | cached | error
    record: dict

    @property
    def report(self) -> SimReport | None:
        if self.status in ("ok", "cached"):
            return SimReport.from_dict(self.record["report"])
        return None


@dataclasses.dataclass
class SweepResult:
    name: str
    results: list[ScenarioResult]
    skipped: list[Skipped]

    @property
    def n_cached(self) -> int:
        return sum(r.status == "cached" for r in self.results)

    @property
    def n_executed(self) -> int:
        return sum(r.status in ("ok", "error") for r in self.results)

    @property
    def n_errors(self) -> int:
        return sum(r.status == "error" for r in self.results)

    @property
    def all_cached(self) -> bool:
        """True iff the whole sweep was served from the cache (zero DRAM
        simulations ran)."""
        return bool(self.results) and self.n_executed == 0

    def summary(self) -> str:
        return (
            f"{self.name}: {len(self.results)} scenarios "
            f"({self.n_cached} cached, {self.n_executed} executed, "
            f"{self.n_errors} errors, {len(self.skipped)} skipped)"
        )


def _chunk_evenly(seq: list, k: int) -> list[list]:
    """Split into at most k contiguous chunks of near-equal size
    (contiguity keeps same-spec neighbours — which share graphs and DRAM
    configs — in the same batch group)."""
    k = max(1, min(k, len(seq)))
    size, extra = divmod(len(seq), k)
    chunks, at = [], 0
    for i in range(k):
        end = at + size + (1 if i < extra else 0)
        chunks.append(seq[at:end])
        at = end
    return chunks


def run_sweep(
    spec: SweepSpec,
    cache_dir: str | None = None,
    workers: int = 0,
    progress: Callable[[str], None] | None = None,
    mode: str = "scenario",
    policy: ExecutionPolicy | None = None,
    device=None,
) -> SweepResult:
    """Execute a sweep spec on ``device`` (``None``: the CUDA card, raising
    before anything runs when there is none).  ``workers <= 1`` runs
    serially in-process; ``workers > 1`` fans scenarios out to a
    spawn-context process pool, each worker on the same device.
    ``mode="batch"`` groups every chunk's DRAM traces into a few batched
    kernel launches (identical results, fewer launches).  ``policy`` adds
    the per-scenario timeout / bounded-retry robustness knobs
    (:class:`ExecutionPolicy`)."""
    if mode not in ("scenario", "batch"):
        raise ValueError(f"unknown mode {mode!r} (use scenario|batch)")
    dev = resolve_device(device)
    say = progress or (lambda msg: None)
    scenarios, skipped = spec.expand()
    for sk in skipped:
        say(f"[{spec.name}] skip {sk.graph}/{sk.accelerator}/{sk.problem}"
            f"/{sk.dram}: {sk.reason}")
    cache = ResultCache(cache_dir)
    plan = plan_scenarios(scenarios, cache)

    results: list[ScenarioResult | None] = [None] * len(scenarios)
    for i, rec in plan.cached:
        results[i] = ScenarioResult(scenarios[i], plan.hashes[i], "cached", rec)
    pending_by_hash = plan.pending_by_hash

    total = len(scenarios)
    done = total - sum(len(v) for v in pending_by_hash.values())
    if done:
        say(f"[{spec.name}] {done}/{total} served from cache")

    def finish(h: str, record: dict) -> None:
        nonlocal done
        if record["status"] == "ok":
            cache.put(h, record)
        for i in pending_by_hash[h]:
            s = scenarios[i]
            results[i] = ScenarioResult(s, h, record["status"], record)
            done += 1
            mark = "ok" if record["status"] == "ok" else "ERROR"
            say(f"[{spec.name}] {done}/{total} {mark} {s.scenario_id} "
                f"({record.get('wall_s', 0):.2f}s)")

    unique_pending = list(pending_by_hash)
    if mode == "batch":
        chunks = _chunk_evenly(unique_pending, workers if workers > 1 else 1)
        if workers > 1 and len(chunks) > 1:
            ctx = multiprocessing.get_context("spawn")
            with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
                futures = {
                    pool.submit(execute_chunk,
                                [scenarios[pending_by_hash[h][0]] for h in chunk],
                                "batch", policy, device=str(dev)):
                    chunk
                    for chunk in chunks
                }
                for fut in as_completed(futures):
                    chunk = futures[fut]
                    try:
                        records = fut.result()
                    except Exception:  # pool-level failure (broken process)
                        records = [dict(status="error",
                                        error=traceback.format_exc(),
                                        wall_s=0.0)] * len(chunk)
                    for h, record in zip(chunk, records):
                        finish(h, record)
        else:
            for chunk in chunks:
                records = execute_chunk(
                    [scenarios[pending_by_hash[h][0]] for h in chunk],
                    "batch", policy, device=dev)
                for h, record in zip(chunk, records):
                    finish(h, record)
            hc = stats_all()
            say(f"[{spec.name}] host artifact cache: "
                f"{hc['artifacts']['hits']}+{hc['semantics']['hits']} hits, "
                f"{hc['artifacts']['misses']}+{hc['semantics']['misses']} misses "
                f"(artifacts+semantics)")
    elif workers > 1 and len(unique_pending) > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
            futures = {
                pool.submit(execute_scenario_policied,
                            scenarios[pending_by_hash[h][0]], policy,
                            device=str(dev)): h
                for h in unique_pending
            }
            for fut in as_completed(futures):
                h = futures[fut]
                try:
                    record = fut.result()
                except Exception:  # pool-level failure (e.g. broken process)
                    record = dict(status="error", error=traceback.format_exc(),
                                  wall_s=0.0)
                finish(h, record)
    else:
        for h in unique_pending:
            finish(h, execute_scenario_policied(
                scenarios[pending_by_hash[h][0]], policy, device=dev))

    out = SweepResult(spec.name, [r for r in results if r is not None], skipped)
    say(f"[{spec.name}] {out.summary()}")
    return out
