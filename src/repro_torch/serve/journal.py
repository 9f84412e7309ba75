"""Crash-safe append-only job journal.

The scheduler's durable state is really the content-addressed result
cache — every finished scenario is already on disk before its row is
delivered.  What a crashed or SIGKILLed server *loses* is the list of
jobs it had accepted but not finished.  The journal records exactly
that, as an append-only JSONL file under the cache dir:

    {"op": "job", "id": "job-3", "name": "…", "kind": "sweep|search",
     "spec": {…wire spec…}, "ts": …}
    {"op": "end", "id": "job-3", "outcome": "done"}

A ``job`` op is fsynced before the submission is acknowledged; an
``end`` op is appended when the job reaches ``done`` or ``cancelled``.
Jobs interrupted by a drain or crash get **no** end op — that is what
makes them resumable: a restarted scheduler replays the journal, and
every job with no terminal op is resubmitted under its original id.
Scenarios that finished before the crash are cache hits, so recovery
re-executes only the genuinely unfinished tail, and clients reconnect
via ``GET /jobs/<id>``.

Crash safety is append-only + line-framed: a torn final line (killed
mid-append) is ignored on load.  The file is compacted on startup so it
holds only open jobs plus this run's appends.  Appended ops are fsynced,
and so is the containing *directory* after the file first comes into
existence (and after the compaction rename) — without the dirfd fsync a
crash right after server start could lose the journal file itself, ops
and all, even though every op inside it was "durable".
"""
from __future__ import annotations

import json
import os
import threading
import time

from repro_torch.sweep.cache import fsync_dir


class JobJournal:
    FILENAME = "journal.jsonl"

    def __init__(self, cache_dir: str | os.PathLike):
        self.path = os.path.join(os.fspath(cache_dir), self.FILENAME)
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._lock = threading.Lock()
        self._dir_synced = False

    # ---- append side -------------------------------------------------------

    def record_job(self, job_id: str, name: str, spec_wire: dict,
                   kind: str = "sweep") -> None:
        """Durably record an accepted job (fsync before returning).
        ``kind`` distinguishes grid sweeps from adaptive searches so
        recovery resubmits each through the right path; journals written
        before the field existed replay as sweeps."""
        self._append(dict(op="job", id=job_id, name=name, kind=kind,
                          spec=spec_wire, ts=time.time()))

    def record_end(self, job_id: str, outcome: str) -> None:
        """Record a terminal outcome.  Only ``done`` and ``cancelled`` close
        a job; interruptions deliberately leave it open so a restarted
        server resumes it."""
        self._append(dict(op="end", id=job_id, outcome=outcome))

    def _append(self, op: dict) -> None:
        line = json.dumps(op, separators=(",", ":"), sort_keys=True) + "\n"
        with self._lock:
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(line)
                f.flush()
                os.fsync(f.fileno())
            if not self._dir_synced:
                # the first append may have *created* the file: its
                # directory entry must reach disk too, or a crash loses
                # the whole journal despite the data fsync above
                fsync_dir(os.path.dirname(self.path))
                self._dir_synced = True

    # ---- replay side -------------------------------------------------------

    def load(self) -> list[dict]:
        """All well-formed ops, in append order.  A torn final line (the
        process died mid-append) is skipped; a torn line anywhere else is
        skipped too — each line is independently framed."""
        try:
            with open(self.path, encoding="utf-8") as f:
                text = f.read()
        except FileNotFoundError:
            return []
        ops = []
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                op = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(op, dict) and "op" in op and "id" in op:
                ops.append(op)
        return ops

    def load_open(self) -> list[dict]:
        """Replay: accepted jobs with no terminal op, in accept order."""
        jobs: dict[str, dict] = {}
        for op in self.load():
            if op["op"] == "job":
                jobs[op["id"]] = op
            elif op["op"] == "end":
                jobs.pop(op["id"], None)
        return list(jobs.values())

    def compact(self) -> int:
        """Rewrite the file to hold only open jobs (atomic tmp+replace).
        Returns the number of ops dropped."""
        with self._lock:
            before = self.load()
            keep = self.load_open()
            if len(keep) == len(before):
                return 0
            tmp = self.path + f".tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                for op in keep:
                    f.write(json.dumps(op, separators=(",", ":"),
                                       sort_keys=True) + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            fsync_dir(os.path.dirname(self.path))  # make the rename durable
            self._dir_synced = True
            return len(before) - len(keep)
