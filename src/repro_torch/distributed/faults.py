"""Deterministic fault-injection harness for the sweep runner and service.

Every recovery path of the fault-tolerance layer — worker supervision,
chunk re-dispatch, the poison-scenario circuit breaker, retry backoff,
cache quarantine — is exercised through this module rather than through
ad-hoc monkeypatching, so the chaos benchmark and the tests drive the
*real* production code paths with a seeded, replayable schedule.

A :class:`FaultPlan` is a seeded list of :class:`FaultRule` entries.  Each
rule names a **site** (an instrumentation point: ``"worker.chunk"`` is
consulted by the scheduler at every chunk dispatch, ``"scenario"`` by
:func:`repro_torch.sweep.runner.execute_scenario_policied` at every attempt) and
a **kind**:

===========  ================================================================
``crash``    the worker process exits hard (``os._exit``) — exercises crash
             detection, respawn, and chunk re-dispatch
``hang``     the worker sleeps past the pool's task deadline — exercises
             liveness kills
``stall``    the worker SIGSTOPs itself, freezing even its heartbeat
             thread — exercises heartbeat-staleness detection
``delay``    sleep ``delay_s`` then proceed (latency injection)
``corrupt``  the chunk executes but its records are mangled before being
             returned — exercises the scheduler's record validation
``error``    (scenario site) the attempt returns a synthetic error record —
             exercises :class:`~repro_torch.sweep.runner.ExecutionPolicy` retries
``drop``     (``remote`` site) the chunk is assigned to a worker host but
             never delivered — exercises the remote pool's liveness
             deadline and re-dispatch
``disconnect``  (``remote`` site) the pool severs the host's control
             stream right after assignment — exercises loss-on-disconnect
             and host re-registration
===========  ================================================================

The ``"worker.chunk"`` site is consulted by the sweep server's scheduler
at every chunk dispatch (:mod:`repro_torch.serve.scheduler`); the
``"remote"`` site by the multi-host pool at every chunk assignment
(:mod:`repro_torch.distributed.remote`).  The schedule format, and what each kind means,
are the same as the reference's (``repro/distributed/faults.py``), so one
plan drives both packages.

Rules select occurrences three ways, all deterministic: ``at`` (explicit
occurrence indices at the site — for chunk dispatches, the scheduler's
dispatch sequence number; for scenario attempts, the attempt index),
``match`` (substring against the scenario ids involved — how a *poison*
scenario keeps killing every worker that touches it across re-dispatches),
and ``prob`` (a seeded per-occurrence coin: ``hash(seed, site, index)``).
``times`` bounds how often a rule fires in one plan instance.

Plans serialize to plain JSON (``plan_to_json`` / ``plan_from_json``) so
the server CLI can accept ``--faults`` and ship actions to workers, and
they pickle (firing counters reset, schedule preserved) so a plan can ride
inside an :class:`~repro_torch.sweep.runner.ExecutionPolicy` to a spawn worker.
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
import signal
import threading
import time
from collections import Counter

KINDS = ("crash", "hang", "stall", "delay", "corrupt", "error", "drop",
         "disconnect")
HANG_S = 3600.0  # a "hang" sleeps until the pool's liveness deadline kills it


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One line of a fault schedule.  ``at``/``match``/``prob`` compose with
    AND semantics; a rule with none of them fires on every occurrence
    (bound it with ``times``)."""

    site: str
    kind: str
    at: tuple[int, ...] = ()
    match: str = ""
    prob: float = 0.0
    times: int | None = None
    delay_s: float = 0.05
    exitcode: int = 13

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} (use {KINDS})")
        if not (0.0 <= self.prob <= 1.0):
            raise ValueError(f"prob must be in [0, 1], got {self.prob}")
        object.__setattr__(self, "at", tuple(int(i) for i in self.at))


@dataclasses.dataclass(frozen=True)
class FaultAction:
    """A rule that fired, resolved to the concrete thing a worker (or the
    runner) should do.  Picklable: it travels inside the chunk dispatch."""

    site: str
    kind: str
    delay_s: float = 0.05
    exitcode: int = 13
    note: str = ""


class FaultPlan:
    """Seeded, deterministic fault schedule.  The schedule (``seed`` +
    ``rules``) is immutable; only the per-rule firing counters are state,
    and they reset across pickling (each process replays its own view)."""

    def __init__(self, seed: int = 0, rules: tuple[FaultRule, ...] = ()):
        self.seed = int(seed)
        self.rules = tuple(rules)
        self._fired: Counter = Counter()
        self._lock = threading.Lock()

    def __eq__(self, other):
        return (isinstance(other, FaultPlan)
                and (self.seed, self.rules) == (other.seed, other.rules))

    def __hash__(self):
        return hash((self.seed, self.rules))

    def __repr__(self):
        return f"FaultPlan(seed={self.seed}, rules={len(self.rules)})"

    def __getstate__(self):
        return dict(seed=self.seed, rules=self.rules)

    def __setstate__(self, state):
        self.__init__(state["seed"], state["rules"])

    def _coin(self, site: str, index: int, rule_i: int) -> float:
        return random.Random(f"{self.seed}:{site}:{index}:{rule_i}").random()

    def action(self, site: str, index: int | None = None,
               keys: tuple[str, ...] = ()) -> FaultAction | None:
        """First matching rule wins; returns ``None`` when nothing fires."""
        for i, r in enumerate(self.rules):
            if r.site != site:
                continue
            if r.at and (index is None or index not in r.at):
                continue
            if r.match and not any(r.match in k for k in keys):
                continue
            if r.prob and self._coin(site, index or 0, i) >= r.prob:
                continue
            with self._lock:
                if r.times is not None and self._fired[i] >= r.times:
                    continue
                self._fired[i] += 1
            return FaultAction(site=site, kind=r.kind, delay_s=r.delay_s,
                               exitcode=r.exitcode,
                               note=f"rule[{i}] at {site}#{index}")
        return None


# ---- JSON (de)serialization: the server CLI's --faults format ---------------


def plan_to_json(plan: FaultPlan) -> str:
    return json.dumps(dict(
        seed=plan.seed,
        rules=[{k: v for k, v in dataclasses.asdict(r).items()
                if v not in ((), "", 0.0, None) or k in ("site", "kind")}
               for r in plan.rules],
    ), separators=(",", ":"), sort_keys=True)


def plan_from_json(text_or_dict) -> FaultPlan:
    d = (json.loads(text_or_dict) if isinstance(text_or_dict, str)
         else text_or_dict)
    if not isinstance(d, dict):
        raise ValueError(f"fault plan must be a JSON object, got {d!r}")
    try:
        rules = tuple(FaultRule(**{**r, "at": tuple(r.get("at", ()))})
                      for r in d.get("rules", ()))
        return FaultPlan(seed=int(d.get("seed", 0)), rules=rules)
    except (TypeError, ValueError) as e:
        raise ValueError(f"bad fault plan: {e}")


# ---- worker-side application ------------------------------------------------


def apply_pre(action: FaultAction | None) -> None:
    """Execute a pre-work fault inside the worker process.  ``crash`` and
    ``stall`` never return control normally; ``hang`` sleeps until the
    supervisor's deadline kills the process."""
    if action is None:
        return
    if action.kind == "crash":
        os._exit(action.exitcode)
    elif action.kind == "hang":
        time.sleep(HANG_S)
    elif action.kind == "stall":
        os.kill(os.getpid(), signal.SIGSTOP)  # frozen until SIGKILLed
    elif action.kind == "delay":
        time.sleep(action.delay_s)


def corrupt_records(records: list[dict]) -> list[dict]:
    """Mangle a chunk's records the way a bad pickle/torn buffer would:
    status still claims ok, but the report payload is garbage — the
    scheduler's record validation must catch this, never the cache."""
    return [dict(status="ok", report=dict(__corrupt__=True),
                 wall_s=rec.get("wall_s", 0.0)) if rec.get("status") == "ok"
            else rec
            for rec in records]


def probe(action: FaultAction | None, value=None):
    """Importable worker-pool payload for tests and benches: apply a fault,
    then echo ``value`` (pid-tagged so respawns are observable)."""
    apply_pre(action)
    return dict(value=value, pid=os.getpid())
