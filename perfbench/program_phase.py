"""Device seconds of the program's spans by the phase they ran in, for the
readers of ``perfbench/metrics/``: a span is inside a phase when a span of
that name encloses it (``repro_torch.obs``'s ``parent`` chain)."""
from __future__ import annotations


def device_seconds_within(snap: dict | None, name: str, phase: str) -> list | None:
    """The device seconds of every span ``name`` opened inside a span
    ``phase``; None without a snapshot or such a span, or where one has no
    device time (a CPU run)."""
    if snap is None:
        return None
    records = snap["records"]

    def inside(i: int) -> bool:
        while records[i]["parent"] is not None:
            i = records[i]["parent"]
            if records[i]["name"] == phase:
                return True
        return False

    values = [r["device_s"] for i, r in enumerate(records) if r["name"] == name and inside(i)]
    if not values or any(v is None for v in values):
        return None
    return values
