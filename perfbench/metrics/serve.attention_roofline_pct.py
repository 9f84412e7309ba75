"""``serve.attention_roofline_pct``: the attention kernel's least time from
shapes (``flops.attention_call``, ``flops.least_time``) over the device
time of its kernels in the profiled wave, found by ``KERNEL`` in their
names.  None when the trace holds none."""
from perfbench import flops

KERNEL = "attention_fwd_bf16"


def read(rec, peak):
    if rec.get("kind") != "serve" or peak is None or not rec.get("trace"):
        return None
    busy = sum(e - s for name, s, e in rec["trace"]["device_ops"] if KERNEL in name) / 1e6
    if busy <= 0:
        return None
    least = sum(c["count"] * flops.least_time(c["flops"], c["bytes"], peak)
                for c in rec["attention_calls"])
    return 100.0 * least / busy
