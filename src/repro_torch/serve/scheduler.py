"""Job scheduler of the sweep server: queue, dedup, in-flight join, drain.

The scheduler owns a table of *unique in-flight scenarios* keyed by their
content hash (the same :func:`repro_torch.sweep.cache.scenario_hash` address the
on-disk cache uses).  A submitted :class:`~repro_torch.sweep.SweepSpec` expands
to scenarios, and each one lands in exactly one of three buckets:

- **cache hit** — the on-disk store already has an ok record: the row is
  streamed back immediately, nothing executes;
- **in-flight join** — another job (or an earlier index of the same job)
  already queued the identical scenario: this job subscribes to the
  pending entry and receives the row when that one execution finishes —
  two clients asking overlapping grids collapse onto shared work;
- **miss** — a new entry joins the run queue, and the dispatcher shards
  queued entries into chunks across the persistent spawn-worker pool
  (:mod:`repro_torch.serve.worker` keeps its CUDA context, loaded kernels
  and host caches warm between jobs).

Completion fans out: the record is written to the content-addressed cache
(errors never are — identical failure isolation to the CLI path) and every
subscribed job gets its row event.  ``drain()`` is the SIGTERM path: stop
dispatching, let running chunks finish (their rows are cached and
delivered), cancel what never started, and mark still-open jobs
interrupted — a re-submission resumes from the cache.

Besides grid sweeps, the scheduler accepts **adaptive search jobs**
(:meth:`SweepScheduler.submit_search`): the
:mod:`repro_torch.sweep.search` loop runs on a per-job thread and funnels each
proposal round through the same entry table — probes dedup against the
cache and against in-flight sweep scenarios, execute on the warm worker
pool, and inherit every fault-tolerance layer below.  Search jobs
journal like sweeps (``kind: "search"``); an interrupted search resumes
from round zero on restart, with all previously executed probes coming
back as cache hits.

Fault tolerance (three layers, each independent):

- **Lost chunks re-dispatch.**  The supervised pool fails a dead worker's
  chunk with :class:`~repro_torch.distributed.workpool.WorkerLost`; every
  scenario of the chunk goes back on the queue with its per-entry attempt
  ledger bumped and its ``suspect`` flag set, so the retry runs as a
  *singleton* chunk — a poison scenario can no longer take innocent
  neighbours down with it.  A scenario whose dispatches have killed
  ``poison_threshold`` workers trips the circuit breaker: it is
  quarantined as a structured error row (``poison: true``, never cached)
  instead of crash-looping the pool.  Records that come back malformed
  (truncated pickles, corrupt payloads) are caught by validation and take
  the same path.
- **Crash-safe job journal.**  Accepted jobs are fsynced to an
  append-only journal under the cache dir before the submission is
  acknowledged; ``done``/``cancelled`` append a terminal op, interruption
  does not.  A restarted scheduler replays open jobs from the journal —
  finished scenarios are cache hits, so only the unfinished tail
  re-executes, and clients reconnect via ``GET /jobs/<id>``.
- **Deterministic fault injection.**  An optional
  :class:`~repro_torch.distributed.faults.FaultPlan` is consulted at every
  chunk dispatch (indexed by the scheduler's global dispatch counter, so
  the schedule is reproducible regardless of worker interleaving) and the
  resulting action ships inside the chunk for the worker to apply.

The scheduler runs on one device (``device=None``: the CUDA card, raising
without one).  It resolves the device once, without opening a CUDA
context of its own (its process launches nothing), and hands it on as a
string: to every worker's initializer, which opens the context there and
loads the kernels, and to every chunk.  Workers report the kernel
launches each chunk made, and ``stats()["launches"]`` sums them — the
evidence that served scenarios went through the kernels.
"""
from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time
from collections import Counter, deque
from concurrent.futures import CancelledError
from typing import Callable

from concurrent.futures import Future

from repro_torch.distributed.workpool import WorkerLost, WorkerPool
from repro_torch.kernels._platform import LAUNCHES, resolve_device
from repro_torch.serve import worker as worker_mod
from repro_torch.serve.journal import JobJournal
from repro_torch.serve.metrics import Metrics
from repro_torch.sweep.cache import ResultCache, scenario_hash
from repro_torch.sweep.results import scenario_row
from repro_torch.sweep.runner import ExecutionPolicy, plan_scenarios
from repro_torch.sweep.search.loop import SearchAborted, SearchSpec, run_search
from repro_torch.sweep.spec import Scenario, SweepSpec

TERMINAL_EVENTS = ("done", "cancelled", "interrupted")


class JobState:
    """One submitted sweep: its scenarios, progress, and event stream."""

    kind = "sweep"
    auto_finish = True  # finish when done == total (searches finish themselves)

    def __init__(self, job_id: str, spec: SweepSpec,
                 scenarios: list[Scenario], hashes: list[str], skipped: list):
        self.id = job_id
        self.name = spec.name
        self.scenarios = scenarios
        self.hashes = hashes
        self.skipped = skipped
        self.total = len(scenarios)
        self.done = 0
        self.counts: Counter = Counter()
        self.cancelled = False
        self.finished = False
        self.recovered = False
        self.t_submit = time.time()
        self.events: queue.Queue = queue.Queue()

    def emit(self, event: dict) -> None:
        self.events.put(event)

    def _delivered(self, index: int, record: dict, status: str) -> None:
        """Hook: a row for scenario ``index`` was just delivered (lock
        held).  Search jobs resolve their probe futures here."""

    def status(self) -> dict:
        return dict(
            job_id=self.id,
            kind=self.kind,
            name=self.name,
            total=self.total,
            done=self.done,
            counts=dict(self.counts),
            skipped=len(self.skipped),
            cancelled=self.cancelled,
            finished=self.finished,
            recovered=self.recovered,
            age_s=round(time.time() - self.t_submit, 3),
        )


class _Entry:
    """One unique pending scenario shared by all jobs that requested it.
    ``attempts`` counts dispatches that ended in a lost worker or a corrupt
    record; a suspect entry re-dispatches alone and is quarantined once the
    ledger reaches the scheduler's poison threshold."""

    __slots__ = ("scenario", "status", "subscribers", "t_queued",
                 "attempts", "suspect")

    def __init__(self, scenario: Scenario):
        self.scenario = scenario
        self.status = "queued"  # queued | running
        self.subscribers: list[tuple[JobState, int]] = []
        self.t_queued = time.time()
        self.attempts = 0
        self.suspect = False


class SearchJobState(JobState):
    """One adaptive search riding the scheduler: its scenario list grows
    round by round as the search loop proposes probes, each probe is an
    ordinary scheduler delivery (cache hit / in-flight join / dispatch),
    and the loop's answer lands in ``result``.  ``abort()`` — called on
    cancel and drain, lock held — unblocks the loop thread by failing
    every pending probe future with :class:`SearchAborted`."""

    kind = "search"
    auto_finish = False  # the search thread decides when the job is done

    def __init__(self, job_id: str, sspec: SearchSpec):
        super().__init__(job_id, sspec.space, [], [], [])
        self.sspec = sspec
        self.total = 0  # grows with each proposal round
        self.result = None  # SearchResult once the loop returns
        self.aborted = False
        self._futures: dict[int, Future] = {}

    def _delivered(self, index: int, record: dict, status: str) -> None:
        fut = self._futures.pop(index, None)
        if fut is not None:
            fut.set_result((record, status))

    def abort(self) -> None:
        self.aborted = True
        for fut in self._futures.values():
            fut.set_exception(SearchAborted("search job aborted"))
        self._futures.clear()

    def status(self) -> dict:
        st = super().status()
        st["have_result"] = self.result is not None
        return st


class SweepScheduler:
    """Single-process scheduler core; thread-safe, transport-agnostic (the
    HTTP layer and the tests drive it directly)."""

    def __init__(
        self,
        cache_dir: str | None,
        workers: int = 2,
        mode: str = "batch",
        policy: ExecutionPolicy | None = None,
        chunk_size: int = 4,
        trace_hashes: bool = False,
        history: int = 256,
        log: Callable[..., None] | None = None,
        pool_factory: Callable[[], object] | None = None,
        poison_threshold: int = 3,
        fault_plan=None,
        worker_deadline_s: float | None = 300.0,
        resume: bool = True,
        device=None,
    ):
        if mode not in ("scenario", "batch"):
            raise ValueError(f"unknown mode {mode!r} (use scenario|batch)")
        self.device = str(resolve_device(device))
        self.cache = ResultCache(cache_dir)
        self.mode = mode
        self.policy = policy
        self.chunk_size = max(1, chunk_size)
        self.trace_hashes = trace_hashes
        self.history = history
        self.poison_threshold = max(1, poison_threshold)
        self.fault_plan = fault_plan
        self.metrics = Metrics()
        self.log = log or (lambda event, **kw: None)
        self.t_start = time.time()

        self.pool = (pool_factory() if pool_factory is not None
                     else WorkerPool(max(1, workers),
                                     initializer=worker_mod.init_worker,
                                     initargs=(self.device,),
                                     task_deadline_s=worker_deadline_s))

        self.journal = JobJournal(cache_dir) if cache_dir else None
        if self.journal is not None:
            self.journal.compact()

        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._jobs: dict[str, JobState] = {}
        self._job_order: deque[str] = deque()
        self._entries: dict[str, _Entry] = {}
        self._queue: deque[str] = deque()
        self._inflight = 0
        self._dispatches = 0
        self._draining = False
        self._closed = False
        self._ids = itertools.count(1)

        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="sweep-dispatcher", daemon=True)
        self._dispatcher.start()
        if resume and self.journal is not None:
            self._recover_jobs()

    # ---- submission --------------------------------------------------------

    def submit(self, spec: SweepSpec) -> JobState:
        """Expand, dedup against cache and in-flight work, enqueue misses.
        Raises ``ValueError`` on a bad spec and ``RuntimeError`` once the
        scheduler is draining."""
        return self._submit_internal(spec)

    def _submit_internal(self, spec: SweepSpec, job_id: str | None = None,
                         recovered: bool = False) -> JobState:
        t0 = time.time()
        scenarios, skipped = spec.expand()  # ValueError -> caller's 4xx
        plan = plan_scenarios(scenarios, self.cache)
        self.metrics.observe("expand_s", time.time() - t0)

        with self._lock:
            if self._draining or self._closed:
                raise RuntimeError("server is draining; not accepting jobs")
            job = JobState(job_id or f"job-{next(self._ids):06d}", spec,
                           scenarios, plan.hashes, skipped)
            job.recovered = recovered
            if self.journal is not None and not recovered:
                # durable before acknowledged: a crash after this point
                # resumes the job instead of silently dropping it
                from repro_torch.serve.protocol import spec_to_wire
                self.journal.record_job(job.id, spec.name, spec_to_wire(spec))
            self._jobs[job.id] = job
            self._job_order.append(job.id)
            self._prune_jobs()
            self.metrics.inc("jobs_submitted")
            self.metrics.inc("scenarios_submitted", len(scenarios))
            self.metrics.inc("scenarios_skipped", len(skipped))
            if recovered:
                self.metrics.inc("jobs_recovered")

            job.emit(dict(
                type="job", job_id=job.id, name=job.name, total=job.total,
                skipped=[dataclasses.asdict(sk) for sk in skipped],
            ))
            for i, rec in plan.cached:
                self.metrics.inc("cache_hits")
                self._deliver(job, i, rec, "cached")
            scheduled = 0
            for h, idxs in plan.pending_by_hash.items():
                entry = self._entries.get(h)
                if entry is None:
                    entry = self._entries[h] = _Entry(scenarios[idxs[0]])
                    self._queue.append(h)
                    scheduled += 1
                    self.metrics.inc("scenarios_scheduled")
                else:
                    # the identical scenario is already queued or running
                    # under another job: join it instead of recomputing
                    self.metrics.inc("inflight_joins")
                entry.subscribers.extend((job, i) for i in idxs)
                # duplicates inside one submission collapse here too
                self.metrics.inc("dedup_joins", len(idxs) - 1)
            if job.total == 0 or job.done >= job.total:
                self._finish_job(job)
            if scheduled:
                self._wake.notify_all()
        self.log("job_submitted", job=job.id, name=job.name,
                 total=job.total, cached=len(plan.cached),
                 scheduled=scheduled, skipped=len(skipped),
                 recovered=recovered)
        return job

    def _recover_jobs(self) -> None:
        """Resubmit journal-open jobs under their original ids.  Finished
        scenarios come straight from the cache, so recovery re-executes only
        the tail the dead server never got to."""
        from repro_torch.serve.protocol import spec_from_wire
        open_ops = self.journal.load_open()
        if not open_ops:
            return
        top = 0
        for op in open_ops:
            tail = op["id"].rsplit("-", 1)[-1]
            if tail.isdigit():
                top = max(top, int(tail))
        self._ids = itertools.count(top + 1)  # never reuse a recovered id
        for op in open_ops:
            try:
                if op.get("kind", "sweep") == "search":
                    from repro_torch.serve.protocol import search_from_wire
                    # the search replays from round zero under its original
                    # id — every probe the dead server executed is a cache
                    # hit, so only the genuinely unexplored tail runs
                    self.submit_search(search_from_wire(op["spec"]),
                                       job_id=op["id"], recovered=True)
                    continue
                spec = spec_from_wire(op["spec"])
                self._submit_internal(spec, job_id=op["id"], recovered=True)
            except Exception as e:
                self.log("recover_failed", job=op.get("id"), error=repr(e))
                if self.journal is not None:
                    self.journal.record_end(op["id"], "unrecoverable")
        self.log("recovered", jobs=len(open_ops))

    # ---- search jobs -------------------------------------------------------

    def submit_search(self, sspec: SearchSpec,
                      job_id: str | None = None,
                      recovered: bool = False) -> SearchJobState:
        """Accept an adaptive search job.  The search loop runs on its own
        thread; each proposal round lands in the scheduler as ordinary
        scenario entries (cache hit, in-flight join with concurrent sweeps,
        dispatch over the warm worker pool), so probes cost and cache
        exactly what a grid submission of the same scenarios would."""
        with self._lock:
            if self._draining or self._closed:
                raise RuntimeError("server is draining; not accepting jobs")
            job = SearchJobState(job_id or f"job-{next(self._ids):06d}",
                                 sspec)
            job.recovered = recovered
            if self.journal is not None and not recovered:
                from repro_torch.serve.protocol import search_to_wire
                self.journal.record_job(job.id, job.name,
                                        search_to_wire(sspec), kind="search")
            self._jobs[job.id] = job
            self._job_order.append(job.id)
            self._prune_jobs()
            self.metrics.inc("searches_submitted")
            if recovered:
                self.metrics.inc("jobs_recovered")
            job.emit(dict(type="job", job_id=job.id, name=job.name,
                          kind="search", mode=sspec.mode, total=0,
                          skipped=[]))
        threading.Thread(target=self._run_search_job, args=(job,),
                         name=f"search-{job.id}", daemon=True).start()
        self.log("search_submitted", job=job.id, name=job.name,
                 mode=sspec.mode, recovered=recovered)
        return job

    def _run_search_job(self, job: SearchJobState) -> None:
        """Search-thread body: drive the loop, then finish the job."""
        try:
            result = run_search(
                job.sspec,
                cache=self.cache,
                executor=lambda scens: self._search_execute(job, scens),
                progress=lambda msg: job.emit(dict(
                    type="progress", job_id=job.id, message=msg)),
                on_proposal=lambda rnd, hashes: job.emit(dict(
                    type="proposal", job_id=job.id, round=rnd,
                    hashes=hashes)),
                device=self.device,
            )
        except SearchAborted:
            return  # cancel/drain already emitted the terminal event
        except Exception as e:
            with self._wake:
                if job.finished or job.cancelled:
                    return
                job.finished = True
                self.metrics.inc("searches_failed")
                if self.journal is not None:
                    try:
                        self.journal.record_end(job.id, "done")
                    except OSError:
                        pass
                job.emit(dict(type="search_error", job_id=job.id,
                              error=repr(e)))
                job.emit(dict(type="done", job_id=job.id, total=job.total,
                              cached=job.counts["cached"],
                              ok=job.counts["ok"],
                              errors=job.counts["error"] + 1))
            self.log("search_failed", job=job.id, error=repr(e))
            return
        with self._wake:
            if job.finished or job.cancelled:
                return
            job.result = result
            job.finished = True
            self.metrics.inc("searches_completed")
            if self.journal is not None:
                try:
                    self.journal.record_end(job.id, "done")
                except OSError:
                    pass
            job.emit(dict(type="search_result", job_id=job.id,
                          result=result.to_dict()))
            job.emit(dict(type="done", job_id=job.id, total=job.total,
                          cached=job.counts["cached"], ok=job.counts["ok"],
                          errors=job.counts["error"]))
        self.log("search_done", job=job.id, executed=result.executed,
                 cached=result.cached, warm=result.warm, pool=result.pool)

    def _search_execute(self, job: SearchJobState,
                        scenarios: list[Scenario]) -> list[tuple[dict, str]]:
        """The search loop's executor: register one proposal round as
        scheduler entries and block until every probe's record arrives.
        Runs on the search thread; raises :class:`SearchAborted` when the
        job is cancelled or the scheduler drains."""
        hashes = [scenario_hash(s) for s in scenarios]
        futures: list[Future | None] = [None] * len(scenarios)
        out: list[tuple[dict, str] | None] = [None] * len(scenarios)
        with self._wake:
            if job.cancelled or job.aborted or self._draining or self._closed:
                raise SearchAborted("scheduler unavailable")
            base = job.total
            job.scenarios.extend(scenarios)
            job.hashes.extend(hashes)
            job.total = len(job.scenarios)
            scheduled = 0
            for k, (h, s) in enumerate(zip(hashes, scenarios)):
                idx = base + k
                rec = self.cache.get(h)
                if rec is not None and rec.get("status") == "ok":
                    # finished (by a concurrent job) since the proposal was
                    # scored: deliver straight from the cache
                    self.metrics.inc("cache_hits")
                    out[k] = (rec, "cached")
                    self._deliver(job, idx, rec, "cached")
                    continue
                fut: Future = Future()
                job._futures[idx] = fut
                futures[k] = fut
                entry = self._entries.get(h)
                if entry is None:
                    entry = self._entries[h] = _Entry(s)
                    self._queue.append(h)
                    scheduled += 1
                    self.metrics.inc("scenarios_scheduled")
                else:
                    self.metrics.inc("inflight_joins")
                entry.subscribers.append((job, idx))
            if scheduled:
                self._wake.notify_all()
        for k, fut in enumerate(futures):
            if fut is None:
                continue
            out[k] = fut.result()  # SearchAborted propagates from abort()
        if job.cancelled or job.aborted:
            raise SearchAborted("search job aborted")
        return out  # type: ignore[return-value]

    def _prune_jobs(self) -> None:
        while len(self._job_order) > self.history:
            jid = self._job_order[0]
            if not self._jobs[jid].finished:
                break  # never drop a live job
            self._job_order.popleft()
            del self._jobs[jid]

    # ---- delivery (lock held) ----------------------------------------------

    def _deliver(self, job: JobState, index: int, record: dict,
                 status: str) -> None:
        if job.cancelled or job.finished:
            return
        job.done += 1
        job.counts[status] += 1
        if record.get("poison"):
            job.counts["poisoned"] += 1
        row = scenario_row(job.scenarios[index], record)
        event = dict(type="row", job_id=job.id, index=index, status=status,
                     row=row, done=job.done, total=job.total)
        if "trace_hash" in record:
            event["trace_hash"] = record["trace_hash"]
        if record.get("poison"):
            event["poison"] = True
        job.emit(event)
        self.metrics.inc("rows_streamed")
        self.metrics.observe("row_s", time.time() - job.t_submit)
        job._delivered(index, record, status)
        if job.auto_finish and job.done >= job.total:
            self._finish_job(job)

    def _finish_job(self, job: JobState) -> None:
        if job.finished:  # e.g. fully-cached job finished during delivery
            return
        job.finished = True
        self.metrics.inc("jobs_completed")
        if self.journal is not None:
            try:
                self.journal.record_end(job.id, "done")
            except OSError:
                pass  # a full disk must not take row delivery down
        job.emit(dict(type="done", job_id=job.id, total=job.total,
                      cached=job.counts["cached"], ok=job.counts["ok"],
                      errors=job.counts["error"]))
        self.log("job_done", job=job.id, **{k: v for k, v in
                                            job.counts.items()})

    def _complete_entry(self, h: str, record: dict) -> None:
        entry = self._entries.pop(h, None)
        if entry is None:
            return
        status = record.get("status", "error")
        if status == "ok":
            self.cache.put(h, record)
            self.metrics.inc("executed_ok")
        else:
            self.metrics.inc("executed_error")
            if record.get("timed_out"):
                self.metrics.inc("timeouts")
        self.metrics.inc("retries", max(0, record.get("attempts", 1) - 1))
        for job, idx in entry.subscribers:
            self._deliver(job, idx, record, status)

    # ---- loss handling (lock held) -----------------------------------------

    def _requeue_or_quarantine(self, h: str, cause: str) -> None:
        """A dispatch of this scenario lost its worker or produced garbage.
        Re-dispatch it (alone — it is now a suspect), unless its attempt
        ledger hit the poison threshold, in which case the circuit breaker
        turns it into a structured, never-cached error row."""
        entry = self._entries.get(h)
        if entry is None:
            return
        if not entry.subscribers:
            # every job that wanted it has cancelled: re-dispatching would
            # execute (and cache) work nobody asked for
            del self._entries[h]
            self.metrics.inc("scenarios_cancelled")
            return
        entry.attempts += 1
        entry.suspect = True
        if not self._draining and entry.attempts >= self.poison_threshold:
            self.metrics.inc("scenarios_poisoned")
            self.log("scenario_poisoned", scenario=entry.scenario.scenario_id,
                     attempts=entry.attempts, cause=cause)
            self._complete_entry(h, dict(
                status="error", poison=True, attempts=entry.attempts,
                wall_s=0.0, last_error=cause,
                error=(f"scenario quarantined after {entry.attempts} failed "
                       f"dispatch attempts; last cause: {cause}")))
        else:
            self.metrics.inc("scenarios_redispatched")
            entry.status = "queued"
            entry.t_queued = time.time()
            self._queue.append(h)
            self._wake.notify_all()

    def _record_valid(self, rec) -> bool:
        """A worker record must be shaped like the runner made it; an ok
        record must hold a reconstructible report — a corrupted payload must
        never reach the cache or a client row."""
        if not isinstance(rec, dict) or rec.get("status") not in ("ok",
                                                                  "error"):
            return False
        if rec.get("status") == "ok":
            from repro_torch.core.metrics import SimReport
            try:
                SimReport.from_dict(rec["report"])
            except Exception:
                return False
        return True

    # ---- dispatch ----------------------------------------------------------

    @property
    def _max_inflight(self) -> int:
        """In-flight chunk window: 2x the pool's *current* capacity.  Read
        per dispatch round, never cached — the reference's remote pool
        starts at zero seats and grows as worker hosts register, so the
        window must track it live.  The floor keeps a couple of chunks
        staged inside an empty pool."""
        return 2 * max(1, getattr(self.pool, "size", 1))

    def _dispatch_loop(self) -> None:
        while True:
            with self._wake:
                while not ((self._queue and self._inflight < self._max_inflight)
                           or self._draining or self._closed):
                    self._wake.wait()
                if self._draining or self._closed:
                    return
                chunk_hashes = []
                while self._queue and len(chunk_hashes) < self.chunk_size:
                    h = self._queue.popleft()
                    entry = self._entries.get(h)
                    if entry is None:  # cancelled while queued
                        continue
                    if entry.suspect and chunk_hashes:
                        # suspects ride alone: if this one kills its worker
                        # again, no innocent scenario shares the blast
                        self._queue.appendleft(h)
                        break
                    entry.status = "running"
                    self.metrics.observe("queue_wait_s",
                                         time.time() - entry.t_queued)
                    chunk_hashes.append(h)
                    if entry.suspect:
                        break
                if not chunk_hashes:
                    continue
                scenarios = [self._entries[h].scenario for h in chunk_hashes]
                dispatch_idx = self._dispatches
                self._dispatches += 1
                self._inflight += 1
            inject = None
            if self.fault_plan is not None:
                inject = self.fault_plan.action(
                    "worker.chunk", index=dispatch_idx,
                    keys=tuple(s.scenario_id for s in scenarios))
                if inject is not None:
                    self.metrics.inc("faults_injected")
            t0 = time.time()
            self.metrics.inc("chunks_dispatched")
            try:
                fut = self.pool.submit(worker_mod.run_chunk, scenarios,
                                       self.mode, self.policy,
                                       self.trace_hashes, inject, self.device)
            except Exception as e:  # broken pool must not kill the dispatcher
                self.log("dispatch_failed", error=repr(e),
                         chunk=len(chunk_hashes))
                records = [dict(status="error", wall_s=0.0,
                                error=f"worker pool rejected chunk: {e!r}")
                           ] * len(chunk_hashes)
                with self._wake:
                    for h, rec in zip(chunk_hashes, records):
                        self._complete_entry(h, rec)
                    self._inflight -= 1
                    self._wake.notify_all()
                continue
            fut.add_done_callback(
                lambda f, hs=chunk_hashes, t=t0: self._chunk_done(hs, t, f))

    def _chunk_done(self, chunk_hashes: list[str], t0: float, fut) -> None:
        records = lost = None
        try:
            out = fut.result()
            records = out["records"]
            for cache_name, delta in out["hostcache"].items():
                for k, v in delta.items():
                    self.metrics.inc(f"worker_hostcache_{cache_name}_{k}", v)
            for name, n in out.get("launches", {}).items():
                self.metrics.inc(f"worker_launches_{name}", n)
            self.metrics.observe("execute_s", time.time() - t0)
            if len(records) != len(chunk_hashes):
                lost = (f"chunk returned {len(records)} records for "
                        f"{len(chunk_hashes)} scenarios")
                records = None
        except CancelledError:
            pass  # drain cancelled the chunk before it started
        except WorkerLost as e:
            lost = str(e)
            self.metrics.inc("chunks_lost")
            self.log("chunk_lost", reason=e.reason, worker=e.worker_id,
                     chunk=len(chunk_hashes))
        except Exception as e:  # worker raised: scenarios failed, not lost
            records = [dict(status="error",
                            error=f"worker chunk failed: {e!r}", wall_s=0.0)
                       ] * len(chunk_hashes)
            self.log("chunk_failed", error=repr(e), chunk=len(chunk_hashes))
        with self._wake:
            if lost is not None:
                for h in chunk_hashes:
                    self._requeue_or_quarantine(h, lost)
            elif records is None:  # cancelled
                self.metrics.inc("chunks_cancelled")
                for h in chunk_hashes:  # back to queued, for accounting only
                    entry = self._entries.get(h)
                    if entry is not None:
                        entry.status = "queued"
            else:
                for h, rec in zip(chunk_hashes, records):
                    if self._record_valid(rec):
                        self._complete_entry(h, rec)
                    else:
                        self.metrics.inc("corrupt_records")
                        self._requeue_or_quarantine(
                            h, "worker returned a corrupt record")
            self._inflight -= 1
            self._wake.notify_all()

    # ---- job control -------------------------------------------------------

    def get_job(self, job_id: str) -> JobState | None:
        with self._lock:
            return self._jobs.get(job_id)

    def cancel(self, job_id: str) -> bool:
        """Cancel a job: it stops receiving rows, and queued scenarios no
        other job wants are dropped.  Running chunks finish (and their
        results are still cached for everyone's next submission) — but a
        running scenario that loses its worker after the cancel is dropped,
        not re-dispatched, once no subscriber remains."""
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None or job.finished or job.cancelled:
                return False
            job.cancelled = True
            self.metrics.inc("jobs_cancelled")
            if self.journal is not None:
                try:
                    self.journal.record_end(job.id, "cancelled")
                except OSError:
                    pass
            for h in list(self._entries):
                entry = self._entries[h]
                entry.subscribers = [(j, i) for j, i in entry.subscribers
                                     if j is not job]
                if not entry.subscribers and entry.status == "queued":
                    del self._entries[h]  # dispatcher skips its stale hash
                    self.metrics.inc("scenarios_cancelled")
            if isinstance(job, SearchJobState):
                job.abort()  # unblock the search thread's pending probes
            job.emit(dict(type="cancelled", job_id=job.id, done=job.done,
                          total=job.total))
        self.log("job_cancelled", job=job_id)
        return True

    # ---- lifecycle ---------------------------------------------------------

    def drain(self, timeout: float | None = 60.0) -> None:
        """Graceful shutdown: reject new jobs, let running chunks finish
        (rows delivered and cached), cancel never-started chunks, then mark
        open jobs interrupted so their streams terminate.  Interrupted jobs
        keep no terminal journal op — a restarted server resumes them."""
        with self._wake:
            if self._closed:
                return
            self._draining = True
            self._wake.notify_all()
        self.log("draining")
        self._dispatcher.join(timeout=10.0)
        # running chunks finish and deliver through their callbacks;
        # executor-queued ones are cancelled.  The supervised pool bounds
        # the wait: a hung worker is killed at its liveness deadline and
        # its chunk comes back WorkerLost (requeued, not quarantined).
        self.pool.shutdown(wait=True, cancel_pending=True)
        deadline = time.time() + (timeout or 0.0)
        with self._wake:
            while self._inflight > 0 and (timeout is None
                                          or time.time() < deadline):
                self._wake.wait(timeout=0.2)
            for job in self._jobs.values():
                if not job.finished and not job.cancelled:
                    self.metrics.inc("jobs_interrupted")
                    job.finished = True
                    if isinstance(job, SearchJobState):
                        # unblock the loop thread; no terminal journal op,
                        # so a restarted server resumes the search (probes
                        # done so far are cache hits)
                        job.abort()
                    job.emit(dict(type="interrupted", job_id=job.id,
                                  completed=job.done, total=job.total))
            self._closed = True
        self.log("drained")

    def close(self) -> None:
        """Hard stop (tests): no drain semantics, just tear down."""
        with self._wake:
            self._closed = True
            for job in self._jobs.values():
                if isinstance(job, SearchJobState) and not job.finished:
                    job.abort()  # never leave a loop thread blocked
            self._wake.notify_all()
        self._dispatcher.join(timeout=5.0)
        self.pool.shutdown(wait=False, cancel_pending=True)

    # ---- observability -----------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            queue_depth = len(self._queue)
            running = sum(e.status == "running"
                          for e in self._entries.values())
            suspects = sum(e.suspect for e in self._entries.values())
            active_jobs = sum(not j.finished and not j.cancelled
                              for j in self._jobs.values())
            draining = self._draining
            inflight = self._inflight
        snap = self.metrics.snapshot()
        pool_stats = (self.pool.stats() if hasattr(self.pool, "stats")
                      else {})
        counters = snap["counters"]
        return dict(
            uptime_s=round(time.time() - self.t_start, 3),
            draining=draining,
            device=self.device,
            launches={name: counters.get(f"worker_launches_{name}", 0)
                      for name in LAUNCHES},
            queue=dict(depth=queue_depth, running=running,
                       inflight_chunks=inflight, suspects=suspects),
            jobs=dict(active=active_jobs,
                      submitted=counters.get("jobs_submitted", 0),
                      completed=counters.get("jobs_completed", 0),
                      cancelled=counters.get("jobs_cancelled", 0),
                      interrupted=counters.get("jobs_interrupted", 0),
                      recovered=counters.get("jobs_recovered", 0)),
            faults=dict(
                chunks_lost=counters.get("chunks_lost", 0),
                scenarios_redispatched=counters.get(
                    "scenarios_redispatched", 0),
                scenarios_poisoned=counters.get("scenarios_poisoned", 0),
                corrupt_records=counters.get("corrupt_records", 0),
                faults_injected=counters.get("faults_injected", 0),
                workers_lost=pool_stats.get("workers_lost", 0),
                worker_respawns=pool_stats.get("respawns", 0)),
            workers=pool_stats,
            counters=counters,
            latency=snap["latency"],
        )
