"""Content-addressed on-disk result store for sweep scenarios.

The cache key is a SHA-256 over the *canonical* JSON of everything that
determines a scenario's simulation result: the graph recipe
(``GraphSpec.canonical()`` — generators are seeded, so the recipe pins the
edge list), the resolved accelerator config, the resolved DRAM config, the
problem and root, ``ENGINE_VERSION``, and the backend tag :data:`BACKEND`.
Changing any of these — including bumping the engine version after a
semantics change — moves the scenario to a new address, so stale results
are never served.  The tag keeps the port's records apart from the
reference's (``repro.sweep.cache``), which shares ``ENGINE_VERSION`` and
would otherwise hash the same scenario to the same address: acc values
of the two agree only to tolerance.  The device is not part of the key:
a record is the same on every device, and one that is not is a fault.

Records are one JSON file per hash, written atomically (private tmp file,
fsync, then ``os.replace``) so parallel workers, concurrent serve jobs and
interrupted sweeps cannot leave torn records: a reader sees either no file,
the old complete record or the new complete record, never a mix.  Two
writers racing on the same key are both writing the same deterministic
content (the key pins the simulation), so last-rename-wins is safe.  A
re-run of an interrupted sweep simply re-executes the missing hashes.

Each record is stored inside a checksum envelope —
``{"sha256": <digest of the canonical record JSON>, "record": {...}}`` —
verified on every read.  A record that fails verification (bit rot, a torn
write from a crashed kernel, manual tampering) is *quarantined*: renamed to
``<hash>.json.bad`` for post-mortem and treated as a miss, so the scenario
silently re-executes instead of serving a corrupted result or crashing the
reader.  Pre-envelope records (a bare dict with a ``status``) stay
readable.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile

from repro_torch.core.engine import ENGINE_VERSION
from repro_torch.sweep.spec import Scenario

BACKEND = "repro_torch"


def canonical_json(obj) -> str:
    """Deterministic JSON: sorted keys, no whitespace."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def fsync_dir(path: str) -> None:
    """fsync a directory so a just-created or just-renamed entry in it
    survives a crash: POSIX only guarantees the rename/creation itself is
    durable once the *directory* has reached disk.  Best effort — platforms
    that cannot open a directory read-only simply skip it."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def scenario_key(s: Scenario) -> dict:
    """The full identity dict hashed into the cache address."""
    return dict(
        backend=BACKEND,
        engine_version=ENGINE_VERSION,
        graph=s.graph.canonical(),
        accelerator=s.accelerator,
        problem=s.problem,
        root=s.root,
        dram=dataclasses.asdict(s.dram),
        config=dict(
            interval_size=s.config.interval_size,
            n_pes=s.config.n_pes,
            optimizations=sorted(s.config.optimizations),
            engine=s.config.engine,
            max_iters=s.config.max_iters,
            scan_cutoff=s.config.scan_cutoff,
            reorder=s.config.reorder,
            interval_scale=s.config.interval_scale,
            semexec=s.config.semexec,
        ),
    )


def scenario_hash(s: Scenario) -> str:
    return hashlib.sha256(canonical_json(scenario_key(s)).encode()).hexdigest()


def record_digest(record: dict) -> str:
    """Payload checksum stored in (and verified against) the on-disk
    envelope."""
    return hashlib.sha256(canonical_json(record).encode()).hexdigest()


class ResultCache:
    """Filesystem-backed content-addressed store; ``root=None`` disables it
    (every scenario executes).

    ``memo_capacity > 0`` adds a bounded in-memory index of verified
    records: content addresses are immutable (the hash pins the record's
    content), so a record read once never needs re-reading for the
    process's lifetime.  Long-lived readers — a search loop probing the
    same candidate pool round after round, a serve scheduler — enable
    it; the default (0) keeps every read on-disk, so tests that delete
    cache files behind the object's back see exactly the old behaviour.
    """

    def __init__(self, root: str | None, memo_capacity: int = 0):
        self.root = root
        self.memo_capacity = memo_capacity
        self._memo: dict[str, dict] = {}

    @property
    def enabled(self) -> bool:
        return self.root is not None

    def path(self, h: str) -> str:
        return os.path.join(self.root, h[:2], h + ".json")

    def _memoize(self, h: str, record: dict) -> None:
        if not self.memo_capacity:
            return
        while len(self._memo) >= self.memo_capacity:
            self._memo.pop(next(iter(self._memo)))  # FIFO eviction
        self._memo[h] = record

    def get(self, h: str) -> dict | None:
        if not self.enabled:
            return None
        hit = self._memo.get(h)
        if hit is not None:
            return hit
        rec = self._read(h)
        if rec is not None:
            self._memoize(h, rec)
        return rec

    def _read(self, h: str) -> dict | None:
        """One on-disk lookup with full verification semantics: checksum
        quarantine, unreadable-is-a-miss."""
        path = self.path(h)
        try:
            with open(path) as f:
                payload = json.load(f)
        except FileNotFoundError:
            return None
        except (json.JSONDecodeError, UnicodeDecodeError):
            # unparseable on-disk bytes (truncation, bit rot): keep the
            # evidence aside and re-execute the scenario
            self._quarantine(path)
            return None
        except OSError:
            # transient read failure (permissions, EIO): a miss, but the
            # file may be fine — do not destroy it
            return None
        if (isinstance(payload, dict) and "record" in payload
                and "sha256" in payload):
            if record_digest(payload["record"]) != payload["sha256"]:
                self._quarantine(path)
                return None
            return payload["record"]
        if isinstance(payload, dict) and "status" in payload:
            return payload  # pre-envelope record: readable, unverified
        self._quarantine(path)
        return None

    def _quarantine(self, path: str) -> None:
        try:
            os.replace(path, path + ".bad")
        except OSError:
            pass  # a concurrent reader may have quarantined it already

    def lookup_many(self, hashes) -> dict[str, dict]:
        """Bulk probe: the records present for ``hashes``, keyed by hash.

        One ``scandir`` pass per touched prefix directory replaces the
        per-hash open-and-fail syscall storm — a search round (or a large
        grid resume) probing N mostly-missing addresses pays O(populated
        prefixes) directory reads instead of O(N) stat/opens.  Hashes whose
        file exists go through :meth:`get`, so single-lookup semantics
        (checksum quarantine, unreadable-is-a-miss, memoization) are
        byte-identical; a record landing between the directory pass and
        this call is simply next round's hit.
        """
        out: dict[str, dict] = {}
        if not self.enabled:
            return out
        todo: dict[str, list[str]] = {}
        for h in hashes:
            if h in out:
                continue
            hit = self._memo.get(h)
            if hit is not None:
                out[h] = hit
            else:
                todo.setdefault(h[:2], []).append(h)
        for prefix, hs in todo.items():
            try:
                with os.scandir(os.path.join(self.root, prefix)) as it:
                    present = {e.name for e in it}
            except OSError:
                continue  # unpopulated (or unreadable) prefix: all misses
            for h in hs:
                if h + ".json" in present:
                    rec = self.get(h)
                    if rec is not None:
                        out[h] = rec
        return out

    def put(self, h: str, record: dict) -> None:
        if not self.enabled:
            return
        path = self.path(h)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(dict(sha256=record_digest(record), record=record), f)
                f.flush()
                # the rename must never expose a partially-flushed record,
                # even across a crash: data reaches disk before the name
                os.fsync(f.fileno())
            os.replace(tmp, path)
            # ... and the rename itself reaches disk before callers treat
            # the record as durable
            fsync_dir(os.path.dirname(path))
            self._memoize(h, record)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def __contains__(self, h: str) -> bool:
        return self.enabled and os.path.exists(self.path(h))
