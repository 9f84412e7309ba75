"""What the program recorded in the traced window, for the readers of
``perfbench/metrics/``: ``repro_torch.obs``'s snapshot (its spans' device
seconds and its counters), and its spans among the trace's host events,
where ``torch.profiler`` files them by name.  A cell's run profiles exactly
its traced window, and the program records only while a profiler runs, so
the snapshot holds that window alone.  A program without
``repro_torch.obs`` records nothing: every function here then gives None,
never a number, as it does for a device time from a CPU run."""
from __future__ import annotations

LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch")  # the host's kernel launches


def snapshot() -> dict | None:
    try:
        from repro_torch import obs
    except ImportError:
        return None
    return obs.snapshot()


def device_seconds(snap: dict | None, name: str) -> list | None:
    """The device seconds of every span ``name``; None without one, or
    where a span has no device time (a CPU run)."""
    if snap is None:
        return None
    values = [r["device_s"] for r in snap["records"] if r["name"] == name]
    if not values or any(v is None for v in values):
        return None
    return values


def per_step(name: str) -> float | None:
    """Mean device seconds of span ``name`` a profiled ``train_step``."""
    snap = snapshot()
    steps = device_seconds(snap, "train_step")
    values = device_seconds(snap, name)
    if steps is None or values is None:
        return None
    return sum(values) / len(steps)


def counter(name: str, phase: str | None) -> int | None:
    snap = snapshot()
    if snap is None:
        return None
    return snap["counters"].get(name, {}).get(phase)


def ratio_pct(num: int | None, den: int | None) -> float | None:
    if num is None or not den:
        return None
    return 100.0 * num / den


def host_spans(trace: dict | None, name: str) -> list:
    """(start_us, end_us) of each host event ``name`` of the trace."""
    if not trace:
        return []
    return [(s, e) for n, s, e in trace["host_ops"] if n == name]


def launches(trace: dict | None) -> list:
    """Start times (us) of the host's kernel launches in the trace."""
    if not trace:
        return []
    return sorted(s for n, s, _ in trace["host_ops"] if n.startswith(LAUNCH_PREFIXES))
