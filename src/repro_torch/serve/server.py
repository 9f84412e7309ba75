"""HTTP front of the sweep server: JSONL streaming, /stats, SIGTERM drain.

Endpoints (all local-loopback by default):

- ``POST /submit`` — body ``{"spec": <wire spec>}``; responds with a
  chunked ``application/x-ndjson`` stream of job events (see
  :mod:`repro_torch.serve.protocol`).  The connection IS the subscription: a
  client that disconnects mid-stream cancels its job (results computed so
  far stay cached for everyone else).
- ``POST /search`` — body ``{"search": <wire search>}``; same streaming
  contract, but the job is an adaptive search
  (:mod:`repro_torch.sweep.search`): the stream carries ``proposal`` /
  ``progress`` / ``row`` events as the loop explores, then a
  ``search_result`` event with the answer before ``done``.
- ``GET /stats`` — scheduler metrics snapshot (queue depth, cache-hit /
  in-flight-join / dedup counters, per-stage latency, worker utilization),
  the engine version, the device the workers run on, and the kernel
  launches the workers made, summed (``launches``).
- ``GET /jobs/<id>`` — one job's progress snapshot.
- ``POST /jobs/<id>/cancel`` — cancel a job.
- ``GET /health`` — liveness + engine version (cache compatibility).
- ``POST /shutdown`` — programmatic drain (same path as SIGTERM).

Robustness is the scheduler's (timeout/retry/backoff via
:class:`repro_torch.sweep.ExecutionPolicy`); this layer only adds transport:
each connection gets its own thread, streams never buffer more than one
event, and a SIGTERM drains gracefully — running work finishes and is
persisted, streams receive an ``interrupted`` event, then the process
exits.  Structured single-line JSON logs go to stderr.
"""
from __future__ import annotations

import json
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch.core.engine import ENGINE_VERSION
from repro_torch.serve.protocol import (
    ProtocolError,
    dump_event,
    search_from_wire,
    spec_from_wire,
)
from repro_torch.serve.scheduler import TERMINAL_EVENTS, SweepScheduler
from repro_torch.sweep.runner import ExecutionPolicy


def jlog(event: str, quiet: bool = False, **fields) -> None:
    """Structured log line: one JSON object per event, stderr."""
    if quiet:
        return
    rec = dict(ts=round(time.time(), 3), event=event, **fields)
    print(json.dumps(rec, separators=(",", ":")), file=sys.stderr, flush=True)


class SweepServer:
    """Owns a :class:`SweepScheduler` and its HTTP front."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        cache_dir: str | None = None,
        workers: int = 2,
        mode: str = "batch",
        policy: ExecutionPolicy | None = None,
        chunk_size: int = 4,
        trace_hashes: bool = False,
        quiet: bool = False,
        pool_factory=None,
        poison_threshold: int = 3,
        fault_plan=None,
        worker_deadline_s: float | None = 300.0,
        resume: bool = True,
        device=None,
    ):
        self.quiet = quiet
        self.scheduler = SweepScheduler(
            cache_dir=cache_dir, workers=workers, mode=mode, policy=policy,
            chunk_size=chunk_size, trace_hashes=trace_hashes,
            log=self._log, pool_factory=pool_factory,
            poison_threshold=poison_threshold, fault_plan=fault_plan,
            worker_deadline_s=worker_deadline_s, resume=resume,
            device=device,
        )
        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.daemon_threads = True
        self.httpd.app = self  # type: ignore[attr-defined]
        self.host, self.port = self.httpd.server_address[:2]
        self._serve_thread: threading.Thread | None = None
        self._stopped = threading.Event()
        self._streams = 0
        self._streams_cv = threading.Condition()

    def _log(self, event: str, **fields) -> None:
        jlog(event, quiet=self.quiet, **fields)

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> "SweepServer":
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, name="sweep-http", daemon=True)
        self._serve_thread.start()
        self._log("ready", host=self.host, port=self.port,
                  engine_version=ENGINE_VERSION, device=self.scheduler.device)
        return self

    def install_signal_handlers(self) -> None:
        """SIGTERM/SIGINT -> graceful drain (call from the main thread)."""
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, self._on_signal)

    def _on_signal(self, signum, frame) -> None:
        self._log("signal", signum=int(signum))
        threading.Thread(target=self.shutdown, name="sweep-drain",
                         daemon=True).start()

    def shutdown(self) -> None:
        """Drain and stop: reject new jobs, finish running chunks (rows
        persisted + streamed), end open streams, close the listener."""
        if self._stopped.is_set():
            return
        self.scheduler.drain()
        # open streams end on their interrupted/done events; give them a
        # moment to flush their final chunk before the listener dies
        with self._streams_cv:
            self._streams_cv.wait_for(lambda: self._streams == 0,
                                      timeout=5.0)
        self.httpd.shutdown()
        self.httpd.server_close()
        self._stopped.set()
        self._log("stopped")

    def wait(self) -> None:
        """Block until the server has fully stopped (after a drain)."""
        while not self._stopped.wait(timeout=0.5):
            pass

    def close(self) -> None:
        """Hard stop for tests (no drain semantics)."""
        if self._stopped.is_set():
            return
        self.scheduler.close()
        self.httpd.shutdown()
        self.httpd.server_close()
        self._stopped.set()

    def _stream_opened(self) -> None:
        with self._streams_cv:
            self._streams += 1

    def _stream_closed(self) -> None:
        with self._streams_cv:
            self._streams -= 1
            self._streams_cv.notify_all()


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    @property
    def app(self) -> SweepServer:
        return self.server.app  # type: ignore[attr-defined]

    def log_message(self, fmt, *args):  # route through structured logs
        self.app._log("http", request=fmt % args)

    # ---- helpers -----------------------------------------------------------

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
        try:
            body = json.loads(raw or b"{}")
        except json.JSONDecodeError as e:
            raise ProtocolError(f"request body is not JSON: {e}")
        if not isinstance(body, dict):
            raise ProtocolError("request body must be a JSON object")
        return body

    def _chunk(self, data: bytes) -> None:
        self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()

    # ---- routes ------------------------------------------------------------

    def do_GET(self) -> None:
        if self.path == "/health":
            self._json(200, dict(status="ok", engine_version=ENGINE_VERSION,
                                 draining=self.app.scheduler.stats()["draining"]))
        elif self.path == "/stats":
            self._json(200, dict(self.app.scheduler.stats(),
                                 engine_version=ENGINE_VERSION))
        elif self.path.startswith("/jobs/"):
            job = self.app.scheduler.get_job(self.path[len("/jobs/"):])
            if job is None:
                self._json(404, dict(error="no such job"))
            else:
                self._json(200, job.status())
        else:
            self._json(404, dict(error=f"no such endpoint {self.path!r}"))

    def do_POST(self) -> None:
        try:
            if self.path == "/submit":
                self._submit()
            elif self.path == "/search":
                self._search()
            elif self.path.startswith("/jobs/") and self.path.endswith("/cancel"):
                job_id = self.path[len("/jobs/"):-len("/cancel")]
                ok = self.app.scheduler.cancel(job_id)
                self._json(200 if ok else 409,
                           dict(cancelled=ok, job_id=job_id))
            elif self.path == "/shutdown":
                self._json(200, dict(ok=True, draining=True))
                threading.Thread(target=self.app.shutdown,
                                 name="sweep-drain", daemon=True).start()
            else:
                self._json(404, dict(error=f"no such endpoint {self.path!r}"))
        except ProtocolError as e:
            self._json(400, dict(error=str(e)))

    def _submit(self) -> None:
        body = self._read_body()
        if "spec" not in body:
            raise ProtocolError("submit body needs a 'spec' field")
        spec = spec_from_wire(body["spec"])
        try:
            job = self.app.scheduler.submit(spec)
        except ValueError as e:  # bad axis values -> client error
            self._json(400, dict(error=str(e)))
            return
        except RuntimeError as e:  # draining
            self._json(503, dict(error=str(e)))
            return
        self._stream_job(job)

    def _search(self) -> None:
        body = self._read_body()
        if "search" not in body:
            raise ProtocolError("search body needs a 'search' field")
        sspec = search_from_wire(body["search"])
        try:
            job = self.app.scheduler.submit_search(sspec)
        except ValueError as e:
            self._json(400, dict(error=str(e)))
            return
        except RuntimeError as e:  # draining
            self._json(503, dict(error=str(e)))
            return
        self._stream_job(job)

    def _stream_job(self, job) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        self.app._stream_opened()
        try:
            while True:
                event = job.events.get()
                self._chunk(dump_event(event))
                if event["type"] in TERMINAL_EVENTS:
                    break
            self._chunk(b"")  # terminating chunk
        except (BrokenPipeError, ConnectionResetError):
            # the stream is the subscription: a vanished client cancels
            # its job (completed scenarios stay cached)
            self.app.scheduler.cancel(job.id)
            self.close_connection = True
        finally:
            self.app._stream_closed()
