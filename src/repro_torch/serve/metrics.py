"""Thread-safe counters and latency histograms for the sweep server.

Everything the ``/stats`` endpoint exports lives here: monotonic counters
(cache hits, in-flight joins, dedup collapses, executed ok/error, retries,
timeouts, and the fault-tolerance ledger — chunks_lost,
scenarios_redispatched, scenarios_poisoned, corrupt_records,
faults_injected, jobs_recovered...), and per-stage latency histograms
(spec expansion, queue wait, chunk execution, submit-to-row latency).  Histograms keep exact
count/sum/max plus a bounded reservoir of recent samples for the p50/p95
quantiles — at serve scale the recent window is what an operator watches
anyway.
"""
from __future__ import annotations

import threading
from collections import Counter, deque


class Histogram:
    """Latency recorder: exact count/sum/max + quantiles over a bounded
    window of the most recent samples."""

    def __init__(self, window: int = 4096):
        self._recent: deque[float] = deque(maxlen=window)
        self.count = 0
        self.total = 0.0
        self.max = 0.0

    def observe(self, value: float) -> None:
        self.count += 1
        self.total += value
        if value > self.max:
            self.max = value
        self._recent.append(value)

    def quantile(self, q: float) -> float:
        if not self._recent:
            return 0.0
        xs = sorted(self._recent)
        idx = min(len(xs) - 1, max(0, round(q * (len(xs) - 1))))
        return xs[idx]

    def snapshot(self) -> dict:
        return dict(
            count=self.count,
            mean=round(self.total / self.count, 6) if self.count else 0.0,
            p50=round(self.quantile(0.50), 6),
            p95=round(self.quantile(0.95), 6),
            max=round(self.max, 6),
        )


class Metrics:
    """One lock, one counter table, one histogram table."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Counter = Counter()
        self._histograms: dict[str, Histogram] = {}

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] += n

    def get(self, name: str) -> int:
        with self._lock:
            return self._counters[name]

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram()
            h.observe(value)

    def snapshot(self) -> dict:
        with self._lock:
            return dict(
                counters=dict(sorted(self._counters.items())),
                latency={k: h.snapshot()
                         for k, h in sorted(self._histograms.items())},
            )
