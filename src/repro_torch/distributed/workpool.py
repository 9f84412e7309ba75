"""Supervised spawn-context worker pool for scenario-chunk execution.

The sweep server shards miss-chunks across a pool of long-lived worker
processes.  Spawn context is mandatory (a forked child of a process that
holds a CUDA context cannot use the card), and the processes deliberately
outlive individual jobs: per-process state — the CUDA context,
``repro_torch.core.hostcache`` artifacts, the graph memo, the loaded
kernel libraries — stays warm between jobs, which is most of the point of
a persistent service over a one-shot CLI.

Unlike a plain ``ProcessPoolExecutor``, :class:`WorkerPool` *supervises*
its workers — one crashed, hung, or OOM-killed process must cost exactly
the chunk it was running, never the pool:

- each worker sends **heartbeats** from a daemon thread; a worker whose
  heartbeat goes stale (SIGSTOP, deep freeze) is declared lost,
- each in-flight chunk has a **liveness deadline** (``task_deadline_s``);
  a worker that sits on a chunk past it is killed as hung,
- a worker whose process dies (crash, OOM kill) is detected via its pipe
  EOF / exit code,
- in every case the chunk's future fails fast with a structured
  :class:`WorkerLost` (reason ``crash`` | ``hang`` | ``stall`` |
  ``shutdown``) so the scheduler can re-dispatch the chunk elsewhere,
- the lost worker slot **respawns with exponential backoff**, bounded by
  ``max_respawns``; a slot that keeps dying is retired, and when every
  slot is retired the pool reports itself broken instead of hanging.

Every supervision deadline — heartbeat staleness, chunk liveness, respawn
backoff, shutdown grace — is measured on ``time.monotonic()``: an NTP
step or a suspend/resume moves the wall clock, not the deadlines, so it
can neither fake a mass ``WorkerLost`` nor stretch a drain.

Supervision starts at ``ready``: a worker's initializer (imports, the
CUDA context, a first build of the kernels with ``nvcc``) counts against
neither the stall nor the task deadline.

Anything with the same ``submit``/``shutdown``/``size``/``busy`` surface
can stand in for it — the scheduler tests inject in-process pools to make
in-flight-join and fault timing deterministic.  The supervision is the
reference's (``repro/distributed/workpool.py``) line for line.
"""
from __future__ import annotations

import multiprocessing
import os
import threading
import time
import traceback
from concurrent.futures import Future
from multiprocessing import connection
from typing import Callable


class WorkerLost(RuntimeError):
    """A chunk failed because its worker died, not because the scenarios
    did.  ``reason``: ``crash`` (process exited), ``hang`` (liveness
    deadline), ``stall`` (heartbeat went silent), ``shutdown`` (killed
    during pool teardown), ``broken`` (no workers left)."""

    def __init__(self, reason: str, worker_id: int, detail: str = ""):
        self.reason = reason
        self.worker_id = worker_id
        self.detail = detail
        msg = f"worker {worker_id} lost ({reason})"
        super().__init__(f"{msg}: {detail}" if detail else msg)


class _Task:
    __slots__ = ("id", "fn", "args", "future")

    def __init__(self, task_id: int, fn: Callable, args: tuple):
        self.id = task_id
        self.fn = fn
        self.args = args
        self.future: Future = Future()


class _Slot:
    """One worker seat: a (re)spawnable process plus its supervision state."""

    __slots__ = ("id", "proc", "conn", "ready", "last_hb", "task", "t_task",
                 "respawns", "retired", "spawn_after")

    def __init__(self, slot_id: int):
        self.id = slot_id
        self.proc = None
        self.conn = None
        self.ready = False
        self.last_hb = 0.0
        self.task: _Task | None = None
        self.t_task = 0.0
        self.respawns = 0
        self.retired = False
        self.spawn_after = 0.0


def _worker_main(conn, initializer, initargs, heartbeat_s: float) -> None:
    """Worker process body: init, then heartbeat + execute loop.  All sends
    share one lock so heartbeats never interleave mid-pickle with results."""
    send_lock = threading.Lock()

    def send(msg) -> None:
        with send_lock:
            try:
                conn.send(msg)
            except (OSError, ValueError):
                os._exit(3)  # parent is gone; nothing left to serve

    if initializer is not None:
        try:
            initializer(*initargs)
        except BaseException:
            traceback.print_exc()
            os._exit(4)
    send(("ready",))

    def beat() -> None:
        while True:
            time.sleep(heartbeat_s)
            send(("hb", time.monotonic()))

    threading.Thread(target=beat, name="workpool-heartbeat",
                     daemon=True).start()
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            os._exit(0)
        if msg[0] == "stop":
            os._exit(0)
        _, task_id, fn, args = msg
        try:
            send(("ok", task_id, fn(*args)))
        except BaseException:
            send(("err", task_id, traceback.format_exc()))


class WorkerPool:
    def __init__(self, workers: int, initializer: Callable | None = None,
                 initargs: tuple = (), heartbeat_s: float = 1.0,
                 task_deadline_s: float | None = 300.0,
                 stall_deadline_s: float = 60.0,
                 max_respawns: int = 3, respawn_backoff_s: float = 0.5):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self.size = workers
        self.heartbeat_s = heartbeat_s
        self.task_deadline_s = task_deadline_s
        self.stall_deadline_s = max(stall_deadline_s, 5 * heartbeat_s)
        self.max_respawns = max_respawns
        self.respawn_backoff_s = respawn_backoff_s
        self._ctx = multiprocessing.get_context("spawn")
        self._initializer = initializer
        self._initargs = initargs

        self._lock = threading.Lock()
        self._tasks: list[_Task] = []  # FIFO queue of unassigned tasks
        self._slots = [_Slot(i) for i in range(workers)]
        self._task_ids = iter(range(1, 1 << 62)).__next__
        self._busy = 0
        self._submitted = 0
        self._workers_lost = 0
        self._respawns = 0
        self._stopping = False
        self._closed = False

        self._monitor = threading.Thread(target=self._monitor_loop,
                                         name="workpool-monitor", daemon=True)
        self._monitor.start()

    # ---- public surface ----------------------------------------------------

    def submit(self, fn: Callable, *args) -> Future:
        with self._lock:
            if self._stopping:
                raise RuntimeError("worker pool is shut down")
            if all(s.retired for s in self._slots):
                raise WorkerLost("broken", -1,
                                 "all worker slots exhausted their respawns")
            task = _Task(self._task_ids(), fn, args)
            self._tasks.append(task)
            self._busy += 1
            self._submitted += 1
        return task.future

    @property
    def busy(self) -> int:
        """Chunks submitted and not yet finished (running or queued; the
        scheduler bounds its in-flight submissions to ~the pool size, so
        this tracks busy workers closely)."""
        with self._lock:
            return self._busy

    def utilization(self) -> float:
        return min(1.0, self.busy / self.size)

    def stats(self) -> dict:
        with self._lock:
            alive = sum(s.proc is not None and s.proc.is_alive()
                        for s in self._slots)
            return dict(size=self.size, busy=min(self._busy, self.size),
                        chunks_submitted=self._submitted,
                        utilization=min(1.0, self._busy / self.size),
                        alive=alive,
                        retired=sum(s.retired for s in self._slots),
                        workers_lost=self._workers_lost,
                        respawns=self._respawns)

    def shutdown(self, wait: bool = True, cancel_pending: bool = False,
                 grace_s: float | None = None) -> None:
        """Stop the pool.  ``cancel_pending`` cancels queued chunks; running
        chunks get ``grace_s`` (default: the task deadline) to finish, then
        their workers are killed and their futures fail with
        :class:`WorkerLost`(``shutdown``) — a drain can never hang on a
        wedged worker."""
        completions: list[tuple[Future, object, bool]] = []
        with self._lock:
            if self._closed:
                return
            self._stopping = True
            if cancel_pending:
                queued, self._tasks = self._tasks, []
                for t in queued:
                    completions.append((t.future, None, True))
        self._fire(completions)
        if wait:
            grace = grace_s if grace_s is not None else self.task_deadline_s
            deadline = None if grace is None else time.monotonic() + grace
            while True:
                with self._lock:
                    running = any(s.task is not None for s in self._slots)
                    pending = bool(self._tasks)
                if not running and not pending:
                    break
                if deadline is not None and time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        completions = []
        with self._lock:
            self._closed = True
            for s in self._slots:
                if s.task is not None:
                    completions.append(
                        (s.task.future,
                         WorkerLost("shutdown", s.id,
                                    "pool shut down before the chunk "
                                    "finished"), False))
                    s.task = None
                self._stop_slot(s)
            for t in self._tasks:
                completions.append((t.future, None, True))
            self._tasks = []
        self._fire(completions)
        self._monitor.join(timeout=5.0)

    # ---- supervision internals ---------------------------------------------

    def _fire(self, completions) -> None:
        """Resolve futures OUTSIDE the pool lock: done-callbacks re-enter
        the scheduler (its lock), and the scheduler's stats path holds its
        lock while reading pool stats — resolving under our lock would be
        a lock-order inversion."""
        for fut, outcome, cancel in completions:
            with self._lock:
                self._busy -= 1
            if cancel:
                fut.cancel()
                # a future already running cannot be cancelled; ours never
                # are (we only cancel unassigned tasks)
            elif isinstance(outcome, BaseException):
                if not fut.cancelled():
                    fut.set_exception(outcome)
            else:
                if not fut.cancelled():
                    fut.set_result(outcome)

    def _spawn(self, s: _Slot) -> None:
        parent, child = self._ctx.Pipe(duplex=True)
        proc = self._ctx.Process(
            target=_worker_main,
            args=(child, self._initializer, self._initargs, self.heartbeat_s),
            name=f"workpool-{s.id}", daemon=True)
        proc.start()
        child.close()
        s.proc, s.conn = proc, parent
        s.ready = False
        s.last_hb = time.monotonic()  # stall checks start at ready

    def _stop_slot(self, s: _Slot) -> None:
        if s.conn is not None:
            try:
                s.conn.send(("stop",))
            except (OSError, ValueError):
                pass
            try:
                s.conn.close()
            except OSError:
                pass
            s.conn = None
        if s.proc is not None:
            s.proc.join(timeout=2.0)
            if s.proc.is_alive():
                s.proc.kill()
                s.proc.join(timeout=5.0)
            s.proc = None
        s.ready = False

    def _kill_slot(self, s: _Slot) -> None:
        if s.proc is not None:
            s.proc.kill()  # SIGKILL: works on SIGSTOPped processes too
            s.proc.join(timeout=5.0)

    def _lose(self, s: _Slot, reason: str, detail: str, completions) -> None:
        """Lock held.  Fail the slot's in-flight task, schedule a bounded
        backoff respawn (or retire the slot)."""
        self._workers_lost += 1
        if s.task is not None:
            completions.append(
                (s.task.future, WorkerLost(reason, s.id, detail), False))
            s.task = None
        if s.conn is not None:
            try:
                s.conn.close()
            except OSError:
                pass
        s.conn = None
        s.proc = None
        s.ready = False
        s.respawns += 1
        if s.respawns > self.max_respawns:
            s.retired = True
            if all(sl.retired for sl in self._slots):
                # no seats left: everything still queued fails fast
                for t in self._tasks:
                    completions.append(
                        (t.future,
                         WorkerLost("broken", -1,
                                    "all worker slots exhausted their "
                                    "respawns"), False))
                self._tasks = []
        else:
            self._respawns += 1
            s.spawn_after = (time.monotonic()
                             + self.respawn_backoff_s * 2 ** (s.respawns - 1))

    def _handle_msg(self, s: _Slot, msg, completions) -> None:
        kind = msg[0]
        if kind == "ready":
            s.ready = True
            s.last_hb = time.monotonic()
        elif kind == "hb":
            s.last_hb = time.monotonic()
        elif kind in ("ok", "err"):
            _, task_id, payload = msg
            if s.task is not None and s.task.id == task_id:
                task, s.task = s.task, None
                if kind == "ok":
                    completions.append((task.future, payload, False))
                else:
                    completions.append(
                        (task.future,
                         RuntimeError(f"worker task raised:\n{payload}"),
                         False))

    def _monitor_loop(self) -> None:
        while True:
            completions: list = []
            with self._lock:
                if self._closed:
                    return
                now = time.monotonic()
                for s in self._slots:
                    # (re)spawn due seats
                    if (s.proc is None and not s.retired
                            and not self._stopping and now >= s.spawn_after):
                        self._spawn(s)
                    # hand queued tasks to ready idle workers
                    if (s.proc is not None and s.ready and s.task is None
                            and self._tasks):
                        task = self._tasks.pop(0)
                        if task.future.set_running_or_notify_cancel():
                            s.task, s.t_task = task, now
                            try:
                                s.conn.send(("task", task.id, task.fn,
                                             task.args))
                            except (OSError, ValueError):
                                s.task = None
                                self._tasks.insert(0, task)
                                self._lose(s, "crash",
                                           "pipe closed on dispatch",
                                           completions)
                conns = {s.conn: s for s in self._slots if s.conn is not None}
            self._fire(completions)
            if conns:
                try:
                    readable = connection.wait(list(conns), timeout=0.05)
                except OSError:
                    readable = []
            else:
                time.sleep(0.05)
                readable = []
            completions = []
            with self._lock:
                if self._closed:
                    return
                for c in readable:
                    s = conns[c]
                    if s.conn is not c:
                        continue  # slot already respawned
                    try:
                        while s.conn.poll():
                            self._handle_msg(s, s.conn.recv(), completions)
                    except (EOFError, OSError):
                        pass  # the liveness pass below records the loss
                now = time.monotonic()
                for s in self._slots:
                    if s.proc is None:
                        continue
                    if not s.proc.is_alive():
                        code = s.proc.exitcode
                        self._lose(s, "crash", f"process exited {code}",
                                   completions)
                    elif (s.task is not None and self.task_deadline_s
                          and now - s.t_task > self.task_deadline_s):
                        self._kill_slot(s)
                        self._lose(
                            s, "hang",
                            f"no result within {self.task_deadline_s}s "
                            f"liveness deadline", completions)
                    elif s.ready and now - s.last_hb > self.stall_deadline_s:
                        self._kill_slot(s)
                        self._lose(
                            s, "stall",
                            f"no heartbeat for {self.stall_deadline_s}s",
                            completions)
            self._fire(completions)
