"""``train.matmul_roofline_pct``: the profiled steps' needed product
operations (weights and attention, ``flops.train_flops``) over the device
time of the matmul-class kernels (``kinds.kind``), as a share of the bf16
peak.  None when the trace holds no product kernel."""
from perfbench import kinds


def read(rec, peak):
    if rec.get("kind") != "train" or peak is None or not rec.get("trace"):
        return None
    busy = kinds.seconds_by_kind(rec["trace"]["device_ops"])["matmul"]
    if busy <= 0:
        return None
    work = rec["step_flops"] * rec["profiled_steps"]  # every needed operation is a product
    return 100.0 * work / (busy * peak["bf16_flops_per_s"])
