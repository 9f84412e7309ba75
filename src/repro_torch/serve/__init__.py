"""Simulation-as-a-service on the port: a persistent sweep server over the
runner, on one device or on the cards of many worker hosts.

``python -m repro_torch.serve`` starts a local HTTP server that keeps the
expensive state of ``repro_torch.sweep`` warm between requests — a
spawn-worker pool whose processes each hold a CUDA context, the loaded
kernel libraries and the host caches, plus the shared content-addressed
result cache.  Clients submit :class:`~repro_torch.sweep.SweepSpec` grids
and stream result rows back incrementally as JSONL; overlapping grids
from concurrent clients dedup against both the on-disk cache and each
other's in-flight work, so no scenario is ever simulated twice.

Layers (each usable on its own), module for module the reference's
``repro.serve``:

- :mod:`repro_torch.serve.protocol` — wire format: spec <-> JSON, event
  framing;
- :mod:`repro_torch.serve.scheduler` — queue, dedup, in-flight join,
  dispatch, drain; transport-agnostic (tests drive it directly);
- :mod:`repro_torch.serve.worker` — what runs inside a pool worker process
  (its CUDA context and kernels, one chunk at a time);
- :mod:`repro_torch.serve.server` — the HTTP/JSONL front + SIGTERM handling;
- :mod:`repro_torch.serve.client` — thin stdlib client (``ServeClient``);
- :mod:`repro_torch.serve.metrics` — counters/histograms behind ``/stats``;
- :mod:`repro_torch.serve.journal` — the crash-safe job journal.

Rows are byte-identical to ``python -m repro_torch.sweep`` output for the
same spec and cache state: both paths share the runner, the cache keys,
and :func:`repro_torch.sweep.results.scenario_row`.  Besides grid sweeps
the scheduler runs adaptive search jobs (``POST /search``) through the
same entry table and worker pool.  Partial failure is survivable at every
layer: crashed, hung or stalled workers are detected and respawned by the
supervised pool (:mod:`repro_torch.distributed.workpool`), their chunks
re-dispatched (with a poison-scenario circuit breaker), and accepted jobs
are journaled so a restarted server resumes unfinished work.  The
server's device is named once (``device=None``: the CUDA card, raising
without one) and handed to the workers as a string.

Multi-host serving (``--worker-listen`` and ``python -m repro_torch.serve
worker``) swaps the local pool for a
:class:`~repro_torch.distributed.remote.RemoteWorkerPool`: worker hosts
connect out to it, each runs a warm spawn pool on its own card, and
the rows are the single-host path's.  The LM serving scaffolding (batched
KV-cache ``ServeEngine`` over :mod:`repro_torch.models`) lives in
:mod:`repro_torch.serve.legacy`.
"""
from repro_torch.serve.client import (
    JobResult,
    SearchJobResult,
    ServeClient,
    ServeError,
)
from repro_torch.serve.journal import JobJournal
from repro_torch.serve.protocol import (
    ProtocolError,
    dump_event,
    parse_event,
    search_from_wire,
    search_to_wire,
    spec_from_wire,
    spec_to_wire,
)
from repro_torch.serve.scheduler import (
    TERMINAL_EVENTS,
    JobState,
    SearchJobState,
    SweepScheduler,
)
from repro_torch.serve.server import SweepServer

__all__ = [
    "JobJournal",
    "JobResult",
    "JobState",
    "ProtocolError",
    "SearchJobResult",
    "SearchJobState",
    "ServeClient",
    "ServeError",
    "SweepScheduler",
    "SweepServer",
    "TERMINAL_EVENTS",
    "dump_event",
    "parse_event",
    "search_from_wire",
    "search_to_wire",
    "spec_from_wire",
    "spec_to_wire",
]
