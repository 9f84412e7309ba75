"""``serve.decode_busy_pct``: the union of the device's operations clipped
to the host intervals of the program's ``engine.decode`` spans (one decode
iteration each, ending when ``engine.sample`` has waited for the device),
over those intervals' length, in percent."""
from perfbench import harness, program_obs


def read(rec, peak):
    if rec.get("kind") != "serve" or not rec.get("trace"):
        return None
    steps = program_obs.host_spans(rec["trace"], "engine.decode")
    ops = rec["trace"]["device_ops"]
    total = sum(e - s for s, e in steps)
    if not steps or not ops or total <= 0:
        return None
    busy = sum(harness.union_length([(max(s, a), min(e, b)) for _, s, e in ops if e > a and s < b])
               for a, b in steps)
    return 100.0 * busy / total
