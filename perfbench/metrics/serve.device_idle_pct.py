"""``serve.device_idle_pct``: one less the union of the device operations'
intervals over the profiled window, in percent."""
from perfbench import harness


def read(rec, peak):
    if rec.get("kind") != "serve" or not rec.get("trace"):
        return None
    bw = harness.busy_and_window(rec["trace"])
    if bw is None:
        return None
    busy, window = bw
    return 100.0 * (1.0 - busy / window)
