"""Multi-host sweep serving: a remote worker pool and its host agent.

The single-host serving stack bounds a campaign by one machine's cores
and cards.  This module shards scenario chunks across worker *hosts*
instead, without changing anything above the scheduler's pool seam:

- :class:`RemoteWorkerPool` satisfies the same
  ``submit``/``shutdown``/``size``/``busy``/``stats`` contract as
  :class:`repro_torch.distributed.workpool.WorkerPool` (it is what the
  scheduler's ``pool_factory`` constructs under ``--worker-listen``),
  but it executes nothing itself — it listens on its own port and
  dispatches chunks to registered hosts over the serve wire format
  (JSONL events framed by :mod:`repro_torch.serve.protocol`).
- :class:`WorkerHostAgent` (``python -m repro_torch.serve worker
  --connect <scheduler>``) runs on each host: it connects *out* to the
  pool, registers its seats, executes dispatched chunks on a local warm
  supervised :class:`~repro_torch.distributed.workpool.WorkerPool`,
  streams heartbeats (with the ids of its running chunks) and result
  records back, and re-registers with backoff after any disconnect — the
  local pool (and its warm host caches, CUDA contexts and loaded kernels)
  survives scheduler restarts.

Each host runs on its own device, named once when its agent starts
(``device=None``: the host's CUDA card, raising without one).  The
agent's own process opens no CUDA context and launches nothing; it hands
the device on as a string to its seats' initializer, which opens the
context and loads the kernels there, and to every chunk.  The
scheduler's device names a card on the scheduler's host, so it never
crosses the wire: ``submit`` takes the scheduler's six ``run_chunk``
arguments and ships the first five.  A finished chunk's kernel-launch
delta travels back beside its records, so the scheduler's ``/stats``
sums the launches of every host.  A host registers with
``backend="repro_torch"``; any other backend is refused, so an agent of
another package cannot write rows under this port's cache addresses.

Transport is deliberately asymmetric so hosts need no listening port of
their own: the control *downlink* is the chunked response body of the
host's ``POST /register`` (``registered`` / ``chunk`` / ``cancel`` /
``ping`` / ``shutdown`` events), while the *uplink* is short POSTs —
``/result`` for finished chunks, ``/heartbeat`` for liveness.

Failure semantics are the supervised pool's, verbatim: a severed
downlink or protocol error fails the host's in-flight chunks with
``WorkerLost("crash")``, a stale heartbeat with ``WorkerLost("stall")``,
a chunk past the liveness deadline with ``WorkerLost("hang")`` — and a
chunk the host's *local* pool lost is forwarded loss-for-loss.  The
scheduler cannot tell a lost host from a lost process, so chunk
re-dispatch, suspect singletons, poison quarantine, journal resume and
drain all carry over unchanged.  All supervision deadlines are
``time.monotonic()``.  A :class:`~repro_torch.distributed.faults.FaultPlan`
is consulted at the ``"remote"`` site per assignment: ``drop`` assigns
but never delivers (the liveness deadline reclaims it), ``delay`` holds
the dispatch back, ``disconnect`` severs the host's downlink right after
delivery.

Records travel as the same JSON-safe dicts the result cache stores, and
``scenario_from_wire(scenario_to_wire(s))`` is hash-identical — so rows
served by remote hosts are byte-identical to the single-host path and
land at the same content addresses.
"""
from __future__ import annotations

import json
import os
import queue
import socket
import threading
import time
import traceback
from collections import deque
from concurrent.futures import CancelledError, Future
from http.client import HTTPConnection
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from repro_torch.distributed.workpool import WorkerLost, WorkerPool
from repro_torch.kernels._platform import resolve_device
from repro_torch.serve.protocol import (
    ProtocolError,
    chunk_from_wire,
    chunk_to_wire,
    dump_event,
    parse_event,
)

# what a host's /register must carry: the package whose rows it computes
BACKEND = "repro_torch"


def parse_address(address: str) -> tuple[str, int]:
    """``host:port`` (host defaults to loopback) -> ``(host, port)``."""
    host, _, port = str(address).rpartition(":")
    try:
        return host or "127.0.0.1", int(port)
    except ValueError:
        raise ValueError(f"bad address {address!r} (want host:port)")


class _RemoteTask:
    __slots__ = ("id", "args", "future", "host", "t_assign")

    def __init__(self, task_id: int, args: tuple):
        self.id = task_id
        self.args = args  # (scenarios, mode, policy, trace_hashes, inject)
        self.future: Future = Future()
        self.host: int | None = None
        self.t_assign = 0.0


class _Host:
    """One registered worker host (one /register downlink session)."""

    __slots__ = ("id", "name", "seats", "pid", "device", "tasks", "outbox",
                 "last_hb", "connected", "t_connect", "done", "running")

    def __init__(self, host_id: int, name: str, seats: int, pid: int,
                 device: str):
        self.id = host_id
        self.name = name
        self.seats = seats
        self.pid = pid
        self.device = device
        self.tasks: dict[int, _RemoteTask] = {}
        self.outbox: queue.Queue = queue.Queue()
        self.last_hb = time.monotonic()
        self.connected = True
        self.t_connect = time.monotonic()
        self.done = 0
        self.running: list[int] = []  # host-reported, via /heartbeat


class RemoteWorkerPool:
    """Scheduler-side half of multi-host serving.  Pool-contract compatible
    with :class:`~repro_torch.distributed.workpool.WorkerPool`, but
    ``submit`` only accepts the scheduler's one dispatch shape —
    ``submit(run_chunk, scenarios, mode, policy, trace_hashes, inject,
    device)`` — because the arguments must cross a wire, not a pickle
    pipe.  ``device`` names a card on the scheduler's host and stays
    behind: every host runs its chunks on its own device.

    ``size`` is dynamic: the total seats of currently connected hosts
    (0 until the first host registers — the scheduler reads it per
    dispatch round, so capacity grows live as hosts arrive)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 heartbeat_s: float = 1.0,
                 task_deadline_s: float | None = 300.0,
                 stall_deadline_s: float = 15.0,
                 fault_plan=None,
                 log: Callable[..., None] | None = None):
        self.heartbeat_s = heartbeat_s
        self.task_deadline_s = task_deadline_s
        self.stall_deadline_s = max(stall_deadline_s, 5 * heartbeat_s)
        self.fault_plan = fault_plan
        self.log = log or (lambda event, **kw: None)

        self._lock = threading.Lock()
        self._queue: deque[_RemoteTask] = deque()
        self._hosts: dict[int, _Host] = {}
        self._seen_names: set[str] = set()
        self._task_ids = iter(range(1, 1 << 62)).__next__
        self._host_ids = iter(range(1, 1 << 62)).__next__
        self._busy = 0
        self._submitted = 0
        self._workers_lost = 0
        self._registrations = 0
        self._reregistrations = 0
        self._dispatches = 0  # "remote" fault-site occurrence index
        self._stopping = False
        self._closed = False

        self.httpd = ThreadingHTTPServer((host, port), _PoolHandler)
        self.httpd.daemon_threads = True
        self.httpd.pool = self  # type: ignore[attr-defined]
        self.host, self.port = self.httpd.server_address[:2]
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, name="remote-pool-http",
            daemon=True)
        self._http_thread.start()
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         name="remote-pool-monitor",
                                         daemon=True)
        self._monitor.start()

    # ---- pool contract -----------------------------------------------------

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    @property
    def size(self) -> int:
        """Total seats of connected hosts — live, not a constructor value."""
        with self._lock:
            return sum(h.seats for h in self._hosts.values() if h.connected)

    def submit(self, fn: Callable, *args) -> Future:
        if getattr(fn, "__name__", "") != "run_chunk":
            raise TypeError(
                "RemoteWorkerPool only dispatches repro_torch.serve.worker."
                f"run_chunk chunks, not {fn!r} (arguments cross a wire)")
        if len(args) != 6:
            raise TypeError(f"run_chunk takes 6 arguments, got {len(args)}")
        with self._lock:
            if self._stopping:
                raise RuntimeError("remote worker pool is shut down")
            # the sixth, the scheduler host's device, does not travel
            task = _RemoteTask(self._task_ids(), args[:5])
            self._queue.append(task)
            self._busy += 1
            self._submitted += 1
            self._assign_locked()
        return task.future

    @property
    def busy(self) -> int:
        with self._lock:
            return self._busy

    def utilization(self) -> float:
        with self._lock:
            seats = sum(h.seats for h in self._hosts.values() if h.connected)
            return min(1.0, self._busy / max(1, seats))

    def stats(self) -> dict:
        with self._lock:
            now = time.monotonic()
            seats = sum(h.seats for h in self._hosts.values() if h.connected)
            hosts = {
                h.name: dict(
                    host_id=h.id, seats=h.seats, pid=h.pid, device=h.device,
                    busy=len(h.tasks), chunks_done=h.done,
                    running=list(h.running),
                    heartbeat_age_s=round(now - h.last_hb, 3),
                    connected_s=round(now - h.t_connect, 3))
                for h in self._hosts.values()
            }
            return dict(kind="remote", size=seats,
                        busy=min(self._busy, seats) if seats else self._busy,
                        queued=len(self._queue),
                        chunks_submitted=self._submitted,
                        utilization=min(1.0, self._busy / max(1, seats)),
                        alive=len(self._hosts),
                        hosts=hosts,
                        registrations=self._registrations,
                        workers_lost=self._workers_lost,
                        respawns=self._reregistrations)

    def shutdown(self, wait: bool = True, cancel_pending: bool = False,
                 grace_s: float | None = None) -> None:
        """Mirror of the local pool's drain: cancel queued chunks, give
        in-flight ones ``grace_s`` (default: the liveness deadline), then
        fail stragglers with ``WorkerLost("shutdown")``, tell every host
        goodbye, and stop the listener."""
        completions: list = []
        with self._lock:
            if self._closed:
                return
            self._stopping = True
            if cancel_pending:
                queued, self._queue = list(self._queue), deque()
                completions += [(t.future, None, True) for t in queued]
        self._fire(completions)
        if wait:
            grace = grace_s if grace_s is not None else self.task_deadline_s
            deadline = None if grace is None else time.monotonic() + grace
            while True:
                with self._lock:
                    running = any(h.tasks for h in self._hosts.values())
                    pending = bool(self._queue)
                if not running and not pending:
                    break
                if deadline is not None and time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        completions = []
        with self._lock:
            self._closed = True
            for h in self._hosts.values():
                for t in h.tasks.values():
                    completions.append(
                        (t.future,
                         WorkerLost("shutdown", h.id,
                                    f"host {h.name}: pool shut down before "
                                    "the chunk finished"), False))
                h.tasks.clear()
                h.outbox.put(("shutdown",))
            for t in self._queue:
                completions.append((t.future, None, True))
            self._queue.clear()
        self._fire(completions)
        self.httpd.shutdown()
        self.httpd.server_close()
        self._monitor.join(timeout=5.0)

    # ---- completion plumbing ----------------------------------------------

    def _fire(self, completions) -> None:
        """Resolve futures OUTSIDE the pool lock (the scheduler's done
        callbacks take its lock, and its stats path reads ours)."""
        for fut, outcome, cancel in completions:
            with self._lock:
                self._busy -= 1
            if cancel:
                fut.cancel()
            elif isinstance(outcome, BaseException):
                if not fut.cancelled():
                    fut.set_exception(outcome)
            else:
                if not fut.cancelled():
                    fut.set_result(outcome)

    # ---- assignment (lock held) --------------------------------------------

    def _assign_locked(self) -> None:
        """Hand queued chunks to the connected host with the most free
        seats; consult the fault plan's ``"remote"`` site per assignment."""
        while self._queue:
            best, best_free = None, 0
            for h in self._hosts.values():
                free = (h.seats - len(h.tasks)) if h.connected else 0
                if free > best_free:
                    best, best_free = h, free
            if best is None:
                return
            task = self._queue.popleft()
            if not task.future.set_running_or_notify_cancel():
                self._busy -= 1  # cancelled while queued (drain)
                continue
            task.host, task.t_assign = best.id, time.monotonic()
            best.tasks[task.id] = task
            action = None
            if self.fault_plan is not None:
                action = self.fault_plan.action(
                    "remote", index=self._dispatches,
                    keys=tuple(s.scenario_id for s in task.args[0]))
            self._dispatches += 1
            if action is not None and action.kind == "drop":
                # assigned but never delivered: the liveness deadline
                # reclaims it and the scheduler re-dispatches
                self.log("remote_fault", kind="drop", host=best.name,
                         chunk=task.id)
                continue
            event = chunk_to_wire(task.id, *task.args)
            if action is not None and action.kind == "delay":
                event["_delay_s"] = action.delay_s
            best.outbox.put(("event", event))
            if action is not None and action.kind == "disconnect":
                self.log("remote_fault", kind="disconnect", host=best.name,
                         chunk=task.id)
                best.outbox.put(("disconnect",))

    # ---- host lifecycle (handler/monitor threads) --------------------------

    def _register(self, name: str, seats: int, pid: int,
                  device: str) -> _Host | None:
        with self._lock:
            if self._stopping:
                return None
            h = _Host(self._host_ids(), name, max(1, seats), pid, device)
            self._hosts[h.id] = h
            self._registrations += 1
            if name in self._seen_names:
                self._reregistrations += 1
            self._seen_names.add(name)
            self._assign_locked()
        self.log("host_registered", host=name, host_id=h.id, seats=h.seats,
                 pid=pid, device=device)
        return h

    def _downlink(self, h: _Host, write: Callable[[bytes], None]) -> str:
        """Runs on the /register handler thread for the session's lifetime;
        write failures propagate to the handler (-> host lost).  Idle
        ticks send ``ping`` so a dead host surfaces as a write error."""
        while True:
            try:
                item = h.outbox.get(timeout=self.heartbeat_s)
            except queue.Empty:
                item = ("event", dict(type="ping"))
            if item[0] == "shutdown":
                write(dump_event(dict(type="shutdown")))
                return "shutdown"
            if item[0] == "disconnect":
                return "disconnect"  # injected fault: sever, no goodbye
            event = dict(item[1])
            delay = event.pop("_delay_s", None)
            if delay:
                time.sleep(delay)
            write(dump_event(event))

    def _host_lost(self, h: _Host, reason: str, detail: str) -> None:
        """Fail every in-flight chunk of a gone host with the structured
        loss the scheduler's re-dispatch path expects.  Idempotent."""
        completions: list = []
        with self._lock:
            if not h.connected:
                return
            h.connected = False
            self._hosts.pop(h.id, None)
            if not self._closed:
                self._workers_lost += 1
            for t in h.tasks.values():
                completions.append(
                    (t.future,
                     WorkerLost(reason, h.id, f"host {h.name}: {detail}"),
                     False))
            h.tasks.clear()
        if completions or not self._closed:
            self.log("host_lost", host=h.name, host_id=h.id, reason=reason,
                     detail=detail, chunks=len(completions))
        self._fire(completions)

    def _host_gone(self, h: _Host) -> None:
        """The downlink ended (write error, disconnect fault, EOF)."""
        with self._lock:
            over = self._stopping or self._closed
        if over:
            with self._lock:
                h.connected = False
                self._hosts.pop(h.id, None)
            return
        self._host_lost(h, "crash", "control stream closed")

    # ---- uplink (handler threads) ------------------------------------------

    def _on_result(self, body: dict) -> bool:
        completions: list = []
        with self._lock:
            h = self._hosts.get(body.get("host_id"))
            if h is None:
                return False  # stale registration: result no longer wanted
            h.last_hb = time.monotonic()
            task = h.tasks.pop(body.get("chunk"), None)
            if task is None:
                return False  # already reclaimed by the liveness deadline
            h.done += 1
            if body.get("ok"):
                records = body.get("records")
                launches = body.get("launches") or {}
                if not isinstance(records, list) or not isinstance(launches,
                                                                   dict):
                    completions.append(
                        (task.future,
                         WorkerLost("crash", h.id,
                                    f"host {h.name}: malformed result "
                                    "payload"), False))
                    self._workers_lost += 1
                else:
                    completions.append(
                        (task.future,
                         dict(records=records,
                              hostcache=body.get("hostcache") or {},
                              launches=launches), False))
            elif isinstance(body.get("lost"), dict):
                # the host's *local* pool lost a worker: forward the loss
                # structure so scheduler recovery is host-transparent
                lost = body["lost"]
                self._workers_lost += 1
                completions.append(
                    (task.future,
                     WorkerLost(str(lost.get("reason") or "crash"), h.id,
                                f"host {h.name}: {lost.get('detail', '')}"),
                     False))
            else:
                completions.append(
                    (task.future,
                     RuntimeError(f"remote chunk failed on host {h.name}:\n"
                                  f"{body.get('error', 'unknown error')}"),
                     False))
            self._assign_locked()
        self._fire(completions)
        return True

    def _on_heartbeat(self, body: dict) -> bool:
        with self._lock:
            h = self._hosts.get(body.get("host_id"))
            if h is None:
                return False
            h.last_hb = time.monotonic()
            h.running = [int(c) for c in body.get("running") or ()]
        return True

    # ---- supervision -------------------------------------------------------

    def _monitor_loop(self) -> None:
        tick = max(0.02, min(0.2, self.heartbeat_s / 5))
        while True:
            time.sleep(tick)
            with self._lock:
                if self._closed:
                    return
                now = time.monotonic()
                stale = [h for h in self._hosts.values()
                         if now - h.last_hb > self.stall_deadline_s]
                hung: list[tuple[_Host, _RemoteTask]] = []
                if self.task_deadline_s:
                    for h in self._hosts.values():
                        if h in stale:
                            continue
                        for t in h.tasks.values():
                            if now - t.t_assign > self.task_deadline_s:
                                hung.append((h, t))
            for h in stale:
                self._host_lost(
                    h, "stall",
                    f"no heartbeat for {self.stall_deadline_s}s")
            completions: list = []
            with self._lock:
                if self._closed:
                    return
                for h, t in hung:
                    if h.tasks.pop(t.id, None) is None:
                        continue  # finished in the meantime
                    self._workers_lost += 1
                    completions.append(
                        (t.future,
                         WorkerLost("hang", h.id,
                                    f"host {h.name}: no result within "
                                    f"{self.task_deadline_s}s liveness "
                                    "deadline"), False))
                    # best-effort: tell the host to forget the chunk so a
                    # late result is not mistaken for the re-dispatch's
                    h.outbox.put(("event", dict(type="cancel", chunk=t.id)))
                if completions:
                    self._assign_locked()
            self._fire(completions)


class _PoolHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    @property
    def pool(self) -> RemoteWorkerPool:
        return self.server.pool  # type: ignore[attr-defined]

    def log_message(self, fmt, *args):
        self.pool.log("pool_http", request=fmt % args)

    def _json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload, separators=(",", ":")).encode() + b"\n"
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self) -> dict:
        length = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(length) if length else b"{}"
        body = json.loads(raw or b"{}")
        if not isinstance(body, dict):
            raise ValueError("body must be a JSON object")
        return body

    def _chunk(self, data: bytes) -> None:
        self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()

    def do_POST(self) -> None:
        try:
            body = self._read_body()
        except (ValueError, OSError) as e:
            self._json(400, dict(error=f"bad request body: {e}"))
            return
        if self.path == "/register":
            self._register(body)
        elif self.path == "/result":
            try:
                ok = self.pool._on_result(body)
            except ProtocolError as e:
                self._json(400, dict(error=str(e)))
                return
            self._json(200 if ok else 410, dict(ok=ok))
        elif self.path == "/heartbeat":
            ok = self.pool._on_heartbeat(body)
            self._json(200 if ok else 410, dict(ok=ok))
        else:
            self._json(404, dict(error=f"no such endpoint {self.path!r}"))

    def do_GET(self) -> None:
        if self.path == "/health":
            self._json(200, dict(status="ok", **self.pool.stats()))
        else:
            self._json(404, dict(error=f"no such endpoint {self.path!r}"))

    def _register(self, body: dict) -> None:
        name = str(body.get("name") or "host")
        if body.get("backend") != BACKEND:
            self._json(400, dict(error=f"host backend {body.get('backend')!r}"
                                       f" is not {BACKEND!r}"))
            return
        try:
            seats = int(body.get("seats") or 1)
            pid = int(body.get("pid") or 0)
        except (TypeError, ValueError):
            self._json(400, dict(error="seats/pid must be integers"))
            return
        h = self.pool._register(name, seats, pid, str(body.get("device")))
        if h is None:
            self._json(503, dict(error="pool is shutting down"))
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        outcome = "error"
        try:
            self._chunk(dump_event(dict(
                type="registered", host_id=h.id,
                heartbeat_s=self.pool.heartbeat_s)))
            outcome = self.pool._downlink(h, self._chunk)
            if outcome == "shutdown":
                self._chunk(b"")  # clean terminating chunk
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            self.pool._host_gone(h)
            self.close_connection = True


# ---- the worker-host side ---------------------------------------------------


def default_host_name() -> str:
    return f"{socket.gethostname()}:{os.getpid()}"


class WorkerHostAgent:
    """One worker host: a warm local :class:`WorkerPool` fronted by a
    connect-out control loop.  ``run()`` blocks until the scheduler says
    ``shutdown`` (or :meth:`stop` is called), re-registering with bounded
    backoff across disconnects; the local pool — and everything warm
    inside its processes — survives scheduler restarts.

    ``device`` is this host's (``None``: its CUDA card, raising without
    one), resolved here without opening a CUDA context and handed on as a
    string to every seat's initializer and every chunk.

    ``pool`` can be injected (tests use in-process stand-ins); by default
    a spawn pool of ``seats`` workers with the serve worker initializer
    is built on first use."""

    def __init__(self, address: str, seats: int = 2, name: str | None = None,
                 heartbeat_s: float = 1.0, reconnect_backoff_s: float = 0.5,
                 max_backoff_s: float = 10.0,
                 worker_deadline_s: float | None = 300.0,
                 pool=None, log: Callable[..., None] | None = None,
                 device=None):
        self.host, self.port = parse_address(address)
        self.device = str(resolve_device(device))
        self.seats = max(1, seats)
        self.name = name or default_host_name()
        self.heartbeat_s = heartbeat_s
        self.reconnect_backoff_s = reconnect_backoff_s
        self.max_backoff_s = max_backoff_s
        self.worker_deadline_s = worker_deadline_s
        self.pool = pool
        self.log = log or (lambda event, **kw: None)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._host_id: int | None = None
        self._running: dict[int, Future] = {}
        self.sessions = 0  # observability: how many times we registered

    # ---- lifecycle ---------------------------------------------------------

    def stop(self) -> None:
        self._stop.set()

    def _ensure_pool(self):
        if self.pool is None:
            from repro_torch.serve import worker as worker_mod
            self.pool = WorkerPool(self.seats,
                                   initializer=worker_mod.init_worker,
                                   initargs=(self.device,),
                                   task_deadline_s=self.worker_deadline_s)
        return self.pool

    def run(self) -> str:
        """Register-execute-reconnect until told to stop.  Returns
        ``"shutdown"`` (scheduler drained us) or ``"stopped"``."""
        self._ensure_pool()
        backoff = self.reconnect_backoff_s
        outcome = "stopped"
        while not self._stop.is_set():
            try:
                outcome = self._session()
                backoff = self.reconnect_backoff_s  # session was accepted
            except (OSError, ProtocolError) as e:
                outcome = "error"
                self.log("agent_session_error", host=self.name,
                         error=repr(e))
            if outcome == "shutdown" or self._stop.is_set():
                break
            # scheduler gone or stream severed: keep the pool warm, back
            # off, re-register
            self.log("agent_reconnecting", host=self.name,
                     backoff_s=round(backoff, 3), last=outcome)
            self._stop.wait(backoff)
            backoff = min(backoff * 2, self.max_backoff_s)
        try:
            self.pool.shutdown(wait=False, cancel_pending=True)
        except Exception:
            pass
        return "shutdown" if outcome == "shutdown" else "stopped"

    # ---- one registration session ------------------------------------------

    def _session(self) -> str:
        conn = HTTPConnection(self.host, self.port,
                              timeout=max(10 * self.heartbeat_s, 30.0))
        conn.request("POST", "/register",
                     body=json.dumps(dict(name=self.name, seats=self.seats,
                                          pid=os.getpid(), device=self.device,
                                          backend=BACKEND)).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            resp.read()
            conn.close()
            raise OSError(f"register rejected: HTTP {resp.status}")
        hb_stop = threading.Event()
        try:
            while True:
                line = resp.readline()
                if not line:
                    return "disconnected"
                line = line.strip()
                if not line:
                    continue
                ev = parse_event(line)
                kind = ev["type"]
                if kind == "registered":
                    with self._lock:
                        self._host_id = ev["host_id"]
                    self.sessions += 1
                    self.heartbeat_s = float(ev.get("heartbeat_s",
                                                    self.heartbeat_s))
                    threading.Thread(target=self._heartbeat_loop,
                                     args=(hb_stop,),
                                     name="agent-heartbeat",
                                     daemon=True).start()
                    self.log("agent_registered", host=self.name,
                             host_id=ev["host_id"], seats=self.seats,
                             device=self.device)
                elif kind == "chunk":
                    self._start_chunk(ev)
                elif kind == "cancel":
                    with self._lock:
                        self._running.pop(ev.get("chunk"), None)
                elif kind == "shutdown":
                    return "shutdown"
                # "ping" and unknown event kinds: liveness only
                if self._stop.is_set():
                    return "stopped"
        finally:
            hb_stop.set()
            try:
                conn.close()
            except Exception:
                pass

    def _start_chunk(self, ev: dict) -> None:
        chunk_id, scenarios, mode, policy, trace_hashes, inject = \
            chunk_from_wire(ev)
        from repro_torch.serve import worker as worker_mod
        try:
            fut = self.pool.submit(worker_mod.run_chunk, scenarios, mode,
                                   policy, trace_hashes, inject, self.device)
        except Exception:
            # local pool broken/draining: report the chunk as lost so the
            # scheduler re-dispatches it to another host
            self._post("/result", dict(
                host_id=self._host_id, chunk=chunk_id, ok=False,
                lost=dict(reason="broken",
                          detail=f"host {self.name}: local pool rejected "
                                 "the chunk")))
            return
        with self._lock:
            self._running[chunk_id] = fut
        fut.add_done_callback(
            lambda f, cid=chunk_id: self._chunk_done(cid, f))

    def _chunk_done(self, chunk_id: int, fut: Future) -> None:
        with self._lock:
            if self._running.pop(chunk_id, None) is None:
                return  # cancelled by the pool: nobody wants this result
            host_id = self._host_id
        try:
            out = fut.result()
            body = dict(host_id=host_id, chunk=chunk_id, ok=True,
                        records=out["records"],
                        hostcache=out.get("hostcache") or {},
                        launches=out.get("launches") or {})
        except CancelledError:
            return
        except WorkerLost as e:
            # a *local* worker died under the chunk: forward the structured
            # loss — the scheduler re-dispatches exactly as for local pools
            body = dict(host_id=host_id, chunk=chunk_id, ok=False,
                        lost=dict(reason=e.reason, detail=str(e)))
        except Exception:
            body = dict(host_id=host_id, chunk=chunk_id, ok=False,
                        error=traceback.format_exc())
        self._post("/result", body)

    def _heartbeat_loop(self, stop: threading.Event) -> None:
        while not stop.is_set() and not self._stop.is_set():
            with self._lock:
                body = dict(host_id=self._host_id,
                            running=sorted(self._running))
            if not self._post("/heartbeat", body):
                return  # scheduler unreachable; the session loop recovers
            stop.wait(self.heartbeat_s)

    def _post(self, path: str, body: dict) -> bool:
        try:
            conn = HTTPConnection(self.host, self.port, timeout=10.0)
            conn.request("POST", path, body=json.dumps(body).encode(),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            resp.read()
            conn.close()
            return resp.status == 200
        except (OSError, ValueError):
            return False


def run_worker_host(address: str, seats: int = 2, name: str | None = None,
                    worker_deadline_s: float | None = 300.0,
                    log: Callable[..., None] | None = None,
                    device=None) -> str:
    """CLI entry body for ``python -m repro_torch.serve worker``: build the
    agent on ``device`` (``None``: the host's card, raising without one),
    wire SIGTERM/SIGINT to a clean stop, run until shutdown."""
    import signal as _signal

    agent = WorkerHostAgent(address, seats=seats, name=name,
                            worker_deadline_s=worker_deadline_s, log=log,
                            device=device)

    def _on_signal(signum, frame):
        agent.stop()

    for sig in (_signal.SIGTERM, _signal.SIGINT):
        try:
            _signal.signal(sig, _on_signal)
        except ValueError:
            pass  # not the main thread (tests drive run() directly)
    return agent.run()
