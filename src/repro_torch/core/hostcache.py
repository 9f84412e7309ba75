"""Bounded in-process caches for host-side preprocessing artifacts.

The paper's "offline preprocessing" — graph generation, partition indices,
per-partition edge routing, and the accelerators' semantic executions — is
pure and keyed by content, so scenarios of a sweep that differ only in the
accelerator or DRAM axes can reuse it instead of recomputing it per
scenario.  Two caches with LRU eviction:

- :data:`ARTIFACTS` — partition indices, prepared (symmetrised/weighted)
  graphs, per-partition routing structures.  Keys embed
  ``Graph.fingerprint`` (a content hash), so any two structurally-identical
  graphs share entries regardless of how they were built.
- :data:`SEMANTICS` — whole semantic executions (values, iterations,
  PhasedTrace, stats) keyed on everything that determines them *except* the
  DRAM configuration: a DDR3/DDR4/HBM sweep of one scenario runs trace
  assembly once.

Both caches are per-process (each sweep worker holds its own) and bounded,
so long sweeps cannot grow host memory without limit.  ``disabled()``
switches them off — the benchmark baseline re-runs every artifact per
scenario like the pre-cache pipeline did.
"""
from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Callable


class HostCache:
    """A small LRU memo: ``get_or_build(key, build)`` returns the cached
    value or builds, stores and returns it (evicting the least recently
    used entry past ``capacity``)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._store: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.enabled = True

    def set_capacity(self, capacity: int) -> None:
        """Resize the cache, evicting LRU entries past the new bound."""
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        while len(self._store) > self.capacity:
            self._store.popitem(last=False)

    def get_or_build(self, key, build: Callable):
        if not self.enabled:
            return build()
        try:
            value = self._store[key]
            self._store.move_to_end(key)
            self.hits += 1
            return value
        except KeyError:
            pass
        value = build()
        self.misses += 1
        self._store[key] = value
        while len(self._store) > self.capacity:
            self._store.popitem(last=False)
        return value

    def clear(self) -> None:
        self._store.clear()

    def reset_stats(self) -> None:
        self.hits = 0
        self.misses = 0

    def stats(self) -> dict:
        return dict(hits=self.hits, misses=self.misses,
                    entries=len(self._store))

    def __len__(self) -> int:
        return len(self._store)


# Partition indices / prepared graphs / routing structures: O(m) each, so a
# few dozen entries bound memory at a few hundred MB for the paper suite.
ARTIFACTS = HostCache(capacity=32)

# Semantic executions (values + PhasedTrace + stats): lazy traces keep these
# small, but cap tighter — one entry per in-flight accelerator/problem pair.
SEMANTICS = HostCache(capacity=8)

_ALL = (ARTIFACTS, SEMANTICS)


def configure(artifacts_capacity: int | None = None,
              semantics_capacity: int | None = None) -> None:
    """Resize the host caches.  Long-lived serve workers (which see many
    jobs over many graphs) raise these above the single-sweep defaults so
    warm artifacts survive between jobs."""
    if artifacts_capacity is not None:
        ARTIFACTS.set_capacity(artifacts_capacity)
    if semantics_capacity is not None:
        SEMANTICS.set_capacity(semantics_capacity)


def clear_all() -> None:
    for c in _ALL:
        c.clear()
        c.reset_stats()


def stats_all() -> dict:
    return dict(artifacts=ARTIFACTS.stats(), semantics=SEMANTICS.stats())


@contextlib.contextmanager
def disabled():
    """Temporarily bypass all host caches (benchmark baseline: the
    per-scenario recompute behaviour of the pre-cache pipeline)."""
    prev = [c.enabled for c in _ALL]
    for c in _ALL:
        c.enabled = False
    try:
        yield
    finally:
        for c, p in zip(_ALL, prev):
            c.enabled = p
