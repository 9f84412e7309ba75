"""Thin client for the sweep server.

:class:`ServeClient` talks plain HTTP/JSONL (stdlib only) to a local
:class:`repro_torch.serve.server.SweepServer`::

    client = ServeClient("127.0.0.1:8731")
    result = client.run(spec)            # submit, stream, reassemble
    rows = result.rows                   # CLI-identical, expansion order

``submit()`` exposes the raw event stream for callers that want
incremental rows (events arrive in completion order, each tagged with its
expansion-order ``index``); ``run()`` collects a stream into a
:class:`JobResult` whose ``rows`` are reassembled into expansion order —
byte-identical to what ``python -m repro_torch.sweep`` exports for the same
spec and cache state.
"""
from __future__ import annotations

import http.client
import json
import time

from repro_torch.serve.protocol import (
    ProtocolError,
    parse_event,
    search_to_wire,
    spec_to_wire,
)
from repro_torch.serve.scheduler import TERMINAL_EVENTS
from repro_torch.sweep.search.loop import SearchSpec
from repro_torch.sweep.spec import SweepSpec


class ServeError(RuntimeError):
    """Server-side rejection (bad spec, draining, unknown job...)."""


class JobResult:
    """A collected job stream."""

    def __init__(self, job_id: str, total: int, skipped: list,
                 events: list[dict], outcome: str):
        self.job_id = job_id
        self.total = total
        self.skipped = skipped
        self.events = events
        self.outcome = outcome  # done | cancelled | interrupted
        row_events = sorted((e for e in events if e["type"] == "row"),
                            key=lambda e: e["index"])
        self.row_events = row_events
        self.rows = [e["row"] for e in row_events]
        self.statuses = [e["status"] for e in row_events]

    def rows_with_status(self) -> list[dict]:
        """Rows with the status column in the CLI's ``--out`` position
        (right after ``label``), matching ``result_rows(with_status=True)``."""
        out = []
        for ev in self.row_events:
            row: dict = {}
            for k, v in ev["row"].items():
                row[k] = v
                if k == "label":
                    row["status"] = ev["status"]
            out.append(row)
        return out

    @property
    def n_cached(self) -> int:
        return sum(s == "cached" for s in self.statuses)

    @property
    def n_errors(self) -> int:
        return sum(s == "error" for s in self.statuses)

    @property
    def n_poisoned(self) -> int:
        """Error rows from the scheduler's poison circuit breaker (the
        scenario repeatedly killed its workers and was quarantined)."""
        return sum(bool(e.get("poison")) for e in self.row_events)


class SearchJobResult(JobResult):
    """A collected search-job stream: sweep-shaped rows for every probe,
    plus the search's answer (``result``, the
    :meth:`repro_torch.sweep.search.SearchResult.to_dict` payload) and the
    per-round ``proposals`` (lists of scenario hashes)."""

    def __init__(self, job_id: str, total: int, skipped: list,
                 events: list[dict], outcome: str):
        super().__init__(job_id, total, skipped, events, outcome)
        self.result: dict | None = None
        self.proposals: list[list[str]] = []
        self.error: str | None = None
        for ev in events:
            if ev["type"] == "search_result":
                self.result = ev["result"]
            elif ev["type"] == "proposal":
                self.proposals.append(ev["hashes"])
            elif ev["type"] == "search_error":
                self.error = ev["error"]


class ServeClient:
    def __init__(self, address: str, timeout: float = 600.0):
        host, _, port = address.rpartition(":")
        self.host, self.port = host or "127.0.0.1", int(port)
        self.timeout = timeout

    def _connect(self) -> http.client.HTTPConnection:
        return http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)

    def _call(self, method: str, path: str, body: dict | None = None) -> dict:
        conn = self._connect()
        try:
            payload = json.dumps(body).encode() if body is not None else None
            conn.request(method, path, body=payload,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = json.loads(resp.read() or b"{}")
            if resp.status >= 400:
                raise ServeError(data.get("error", f"HTTP {resp.status}"))
            return data
        finally:
            conn.close()

    # ---- control-plane calls ----------------------------------------------

    def health(self) -> dict:
        return self._call("GET", "/health")

    def wait_ready(self, deadline_s: float = 30.0) -> dict:
        t0 = time.time()
        while True:
            try:
                return self.health()
            except (OSError, ServeError):
                if time.time() - t0 > deadline_s:
                    raise
                time.sleep(0.1)

    def stats(self) -> dict:
        return self._call("GET", "/stats")

    def job_status(self, job_id: str) -> dict:
        return self._call("GET", f"/jobs/{job_id}")

    def cancel(self, job_id: str) -> bool:
        try:
            return bool(self._call("POST", f"/jobs/{job_id}/cancel")["cancelled"])
        except ServeError:
            return False

    def shutdown(self) -> dict:
        return self._call("POST", "/shutdown")

    # ---- submission --------------------------------------------------------

    def submit(self, spec: SweepSpec):
        """Submit and yield events as they stream.  The generator's first
        event is the ``job`` header; it ends after a terminal event."""
        return self._post_stream("/submit", dict(spec=spec_to_wire(spec)))

    def submit_search(self, sspec: SearchSpec):
        """Submit an adaptive search and yield its events as they stream
        (``proposal`` / ``progress`` / ``row`` / ``search_result`` /
        terminal; see :mod:`repro_torch.serve.protocol`)."""
        return self._post_stream("/search", dict(search=search_to_wire(sspec)))

    def _post_stream(self, path: str, body: dict):
        conn = self._connect()
        conn.request("POST", path, body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status >= 400:
            err = json.loads(resp.read() or b"{}")
            conn.close()
            raise ServeError(err.get("error", f"HTTP {resp.status}"))

        def events():
            try:
                while True:
                    line = resp.readline()
                    if not line:
                        break
                    line = line.strip()
                    if not line:
                        continue
                    ev = parse_event(line)
                    yield ev
                    if ev["type"] in TERMINAL_EVENTS:
                        break
            finally:
                conn.close()

        return events()

    def run(self, spec: SweepSpec) -> JobResult:
        """Submit, stream to completion, reassemble rows in expansion
        order.  ``interrupted`` streams (server drained mid-job) return
        what completed — resubmitting resumes from the cache."""
        return self._collect(self.submit(spec), JobResult)

    def run_search(self, sspec: SearchSpec) -> SearchJobResult:
        """Submit an adaptive search, stream to completion.  The returned
        :class:`SearchJobResult` carries the probes' sweep-shaped rows
        and the search's answer dict; an ``interrupted`` stream (server
        drained) returns what ran — resubmitting warm-starts from the
        cache and continues the exploration."""
        return self._collect(self.submit_search(sspec), SearchJobResult)

    def _collect(self, stream, result_cls):
        events = []
        job_id, total, skipped = "", 0, []
        outcome = "disconnected"
        for ev in stream:
            events.append(ev)
            if ev["type"] == "job":
                job_id, total = ev["job_id"], ev["total"]
                skipped = ev.get("skipped", [])
            elif ev["type"] in TERMINAL_EVENTS:
                outcome = ev["type"]
                if ev["type"] == "done":
                    total = ev.get("total", total)  # searches grow total
        if not job_id:
            raise ProtocolError("stream ended before the job header")
        return result_cls(job_id, total, skipped, events, outcome)
