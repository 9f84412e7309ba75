"""Wire format of the sweep server: JSON specs in, JSONL events out.

A submission body is ``{"spec": <wire spec>}``; the response is a stream
of newline-delimited JSON events::

    {"type": "job", "job_id": ..., "total": N, "skipped": [...]}
    {"type": "row", "index": i, "status": "ok|cached|error",
     "row": {...}, "done": k, "total": N}       # one per scenario
    {"type": "done", "job_id": ..., "cached": c, "ok": o, "errors": e}
  | {"type": "cancelled", ...} | {"type": "interrupted", "completed": k, ...}

``row`` payloads are exactly :func:`repro_torch.sweep.results.scenario_row`
dicts, and ``index`` is the scenario's position in the spec's expansion
order — reassembling rows by index reproduces the CLI export byte for
byte.  Events may carry auxiliary fields (``trace_hash`` when the server
runs with golden-hash fingerprinting, ``poison: true`` on an error row
the scheduler's circuit breaker quarantined because the scenario kept
killing its workers); those never leak into ``row`` — except the error
row's own ``attempts``/``last_error``/``poison`` audit columns, which are
part of the :func:`~repro_torch.sweep.results.scenario_row` shape itself.

The wire spec is a plain-JSON rendering of :class:`repro_torch.sweep.SweepSpec`:
axis lists of strings stay strings, inline :class:`GraphSpec` recipes
become ``{"graph_spec": {...}}`` dicts, ``(dram, channels)`` pairs become
two-element lists, address mappings serialize to their ``label`` token
(``scheme`` / ``scheme@lines``), and config overrides to their field dict.
``spec_from_wire(spec_to_wire(s))`` expands to hash-identical scenarios —
the server caches under the same content addresses as the CLI.

The same framing carries the **worker-host protocol** of the multi-host
pool (:mod:`repro_torch.distributed.remote`): a
``chunk`` event is ``chunk_to_wire`` — fully resolved
:class:`~repro_torch.sweep.spec.Scenario` dicts (``scenario_to_wire``),
the execution mode, the :class:`~repro_torch.sweep.runner.ExecutionPolicy`
(``policy_to_wire``, fault plan included), and any dispatch-time
:class:`~repro_torch.distributed.faults.FaultAction` — everything
``repro_torch.serve.worker.run_chunk`` takes but the device, which each
worker host names for itself.  ``scenario_from_wire(scenario_to_wire(s))``
is hash-identical under :func:`repro_torch.sweep.cache.scenario_hash`,
the ``device`` engine axis included.

A *search* submission (``POST /search``, body ``{"search": <wire>}``)
wraps a wire spec as the candidate ``space`` plus the query fields of
:class:`repro_torch.sweep.search.SearchSpec`; its stream adds three event
types to the sweep vocabulary — ``proposal`` (the hashes one search
round decided to probe), ``progress`` (loop narration), and
``search_result`` (the full :class:`~repro_torch.sweep.search.SearchResult`
dict, right before ``done``).  ``row`` events are unchanged: probes are
ordinary scheduler deliveries, byte-identical to grid-sweep rows.
"""
from __future__ import annotations

import dataclasses
import json

from repro_torch.core.accelerators.base import AccelConfig
from repro_torch.core.dram import AddressMapping, DRAMConfig
from repro_torch.graph.generators import GraphSpec
from repro_torch.sweep.runner import ExecutionPolicy
from repro_torch.sweep.search.loop import SearchSpec
from repro_torch.sweep.spec import ConfigOverride, Scenario, SweepSpec


class ProtocolError(ValueError):
    """A malformed wire message (bad JSON shape, unknown fields...)."""


def spec_to_wire(spec: SweepSpec) -> dict:
    return dict(
        name=spec.name,
        accelerators=list(spec.accelerators),
        graphs=[g if isinstance(g, str)
                else dict(graph_spec=dataclasses.asdict(g))
                for g in spec.graphs],
        problems=list(spec.problems),
        drams=[d if isinstance(d, str) else [d[0], d[1]]
               for d in spec.drams],
        mappings=[m.label if isinstance(m, AddressMapping) else str(m)
                  for m in spec.mappings],
        page_policies=list(spec.page_policies),
        pseudo_channels=[bool(p) for p in spec.pseudo_channels],
        overrides=[dataclasses.asdict(o) | dict(
            optimizations=(sorted(o.optimizations)
                           if o.optimizations is not None else None))
            for o in spec.overrides],
        reorders=list(spec.reorders),
        interval_scales=list(spec.interval_scales),
        engines=list(spec.engines),
    )


def _graph_from_wire(g) -> str | GraphSpec:
    if isinstance(g, str):
        return g
    try:
        return GraphSpec(**g["graph_spec"])
    except (TypeError, KeyError) as e:
        raise ProtocolError(f"bad graph entry {g!r}: {e}")


def _override_from_wire(o: dict) -> ConfigOverride:
    try:
        kw = dict(o)
        if kw.get("optimizations") is not None:
            kw["optimizations"] = frozenset(kw["optimizations"])
        return ConfigOverride(**kw)
    except TypeError as e:
        raise ProtocolError(f"bad override entry {o!r}: {e}")


def spec_from_wire(d: dict) -> SweepSpec:
    if not isinstance(d, dict) or "name" not in d:
        raise ProtocolError("spec must be an object with at least a 'name'")
    known = {f.name for f in dataclasses.fields(SweepSpec)}
    unknown = sorted(set(d) - known)
    if unknown:
        raise ProtocolError(f"unknown spec field(s): {', '.join(unknown)}")
    kw: dict = dict(name=d["name"])
    for axis in ("accelerators", "problems", "page_policies", "reorders",
                 "mappings", "engines"):
        if axis in d:
            kw[axis] = tuple(d[axis])
    if "graphs" in d:
        kw["graphs"] = tuple(_graph_from_wire(g) for g in d["graphs"])
    if "drams" in d:
        kw["drams"] = tuple(x if isinstance(x, str) else (x[0], x[1])
                            for x in d["drams"])
    if "pseudo_channels" in d:
        kw["pseudo_channels"] = tuple(bool(p) for p in d["pseudo_channels"])
    if "interval_scales" in d:
        kw["interval_scales"] = tuple(int(x) for x in d["interval_scales"])
    if "overrides" in d:
        kw["overrides"] = tuple(_override_from_wire(o) for o in d["overrides"])
    try:
        return SweepSpec(accelerators=kw.pop("accelerators", ()),
                         graphs=kw.pop("graphs", ()), **kw)
    except TypeError as e:
        raise ProtocolError(f"bad spec: {e}")


# ---- worker-host wire: resolved scenarios, policies, chunk dispatches ------


def scenario_to_wire(s: Scenario) -> dict:
    """A fully *resolved* scenario as plain JSON (unlike the wire spec,
    which carries axis tokens): what a remote worker host needs to execute
    the exact simulation the scheduler content-addressed."""
    dram = dataclasses.asdict(s.dram)
    cfg = dataclasses.asdict(s.config)
    cfg["optimizations"] = sorted(s.config.optimizations)
    return dict(graph=dataclasses.asdict(s.graph), accelerator=s.accelerator,
                problem=s.problem, dram=dram, config=cfg, root=s.root,
                label=s.label)


def scenario_from_wire(d: dict) -> Scenario:
    """Inverse of :func:`scenario_to_wire`; the reconstructed scenario is
    hash-identical (``scenario_hash``) to the original, so remote results
    land at the same content addresses."""
    try:
        dram = dict(d["dram"])
        dram["mapping"] = AddressMapping(**dram["mapping"])
        cfg = dict(d["config"])
        cfg["optimizations"] = frozenset(cfg["optimizations"])
        return Scenario(
            graph=GraphSpec(**d["graph"]),
            accelerator=d["accelerator"],
            problem=d["problem"],
            dram=DRAMConfig(**dram),
            config=AccelConfig(**cfg),
            root=int(d.get("root", 0)),
            label=d.get("label", ""),
        )
    except (TypeError, KeyError, ValueError) as e:
        raise ProtocolError(f"bad scenario: {e}")


def policy_to_wire(policy: ExecutionPolicy | None) -> dict | None:
    if policy is None:
        return None
    from repro_torch.distributed.faults import plan_to_json

    return dict(
        timeout_s=policy.timeout_s,
        retries=policy.retries,
        backoff_s=policy.backoff_s,
        fault_plan=(json.loads(plan_to_json(policy.fault_plan))
                    if policy.fault_plan is not None else None),
    )


def policy_from_wire(d: dict | None) -> ExecutionPolicy | None:
    if d is None:
        return None
    from repro_torch.distributed.faults import plan_from_json

    try:
        plan = (plan_from_json(d["fault_plan"])
                if d.get("fault_plan") else None)
        return ExecutionPolicy(timeout_s=d.get("timeout_s"),
                               retries=int(d.get("retries", 0)),
                               backoff_s=float(d.get("backoff_s", 0.25)),
                               fault_plan=plan)
    except (TypeError, KeyError, ValueError) as e:
        raise ProtocolError(f"bad policy: {e}")


def action_to_wire(action) -> dict | None:
    """A dispatch-time :class:`~repro_torch.distributed.faults.FaultAction`."""
    return None if action is None else dataclasses.asdict(action)


def action_from_wire(d: dict | None):
    if d is None:
        return None
    from repro_torch.distributed.faults import FaultAction

    try:
        return FaultAction(**d)
    except TypeError as e:
        raise ProtocolError(f"bad fault action: {e}")


def chunk_to_wire(chunk_id: int, scenarios, mode: str,
                  policy: ExecutionPolicy | None, trace_hashes: bool,
                  inject=None) -> dict:
    """One chunk-dispatch event: exactly the ``run_chunk`` argument list,
    JSON-rendered, plus the pool's chunk id for result correlation."""
    return dict(type="chunk", chunk=int(chunk_id),
                scenarios=[scenario_to_wire(s) for s in scenarios],
                mode=mode, policy=policy_to_wire(policy),
                trace_hashes=bool(trace_hashes),
                inject=action_to_wire(inject))


def chunk_from_wire(d: dict) -> tuple:
    """-> ``(chunk_id, scenarios, mode, policy, trace_hashes, inject)``."""
    try:
        return (int(d["chunk"]),
                [scenario_from_wire(s) for s in d["scenarios"]],
                d["mode"],
                policy_from_wire(d.get("policy")),
                bool(d.get("trace_hashes", False)),
                action_from_wire(d.get("inject")))
    except (TypeError, KeyError, ValueError) as e:
        raise ProtocolError(f"bad chunk message: {e}")


_SEARCH_FIELDS = ("objective", "direction", "mode", "rank_over", "budget",
                  "budget_frac", "batch", "init", "surrogate", "acquisition",
                  "epsilon", "seed", "max_pool", "patience")


def search_to_wire(sspec: SearchSpec) -> dict:
    wire = dict(space=spec_to_wire(sspec.space),
                group_by=list(sspec.group_by))
    for f in _SEARCH_FIELDS:
        wire[f] = getattr(sspec, f)
    return wire


def search_from_wire(d: dict) -> SearchSpec:
    if not isinstance(d, dict) or "space" not in d:
        raise ProtocolError("search must be an object with a 'space' spec")
    known = set(_SEARCH_FIELDS) | {"space", "group_by"}
    unknown = sorted(set(d) - known)
    if unknown:
        raise ProtocolError(f"unknown search field(s): {', '.join(unknown)}")
    kw: dict = dict(space=spec_from_wire(d["space"]))
    if "group_by" in d:
        kw["group_by"] = tuple(d["group_by"])
    for f in _SEARCH_FIELDS:
        if f in d:
            kw[f] = d[f]
    try:
        return SearchSpec(**kw)
    except (TypeError, ValueError) as e:
        raise ProtocolError(f"bad search: {e}")


def dump_event(event: dict) -> bytes:
    """One JSONL frame (compact separators keep the stream light)."""
    return (json.dumps(event, separators=(",", ":")) + "\n").encode()


def parse_event(line: bytes | str) -> dict:
    try:
        ev = json.loads(line)
    except json.JSONDecodeError as e:
        raise ProtocolError(f"bad event line {line!r}: {e}")
    if not isinstance(ev, dict) or "type" not in ev:
        raise ProtocolError(f"event must be an object with a 'type': {ev!r}")
    return ev
