"""``train.attention_roofline_pct``: the training attention kernels' least
time over their device time in the profiled steps, in percent.

Each forward kernel (``FORWARD``: the forward and remat's recompute) is
held to its call's two products (QKᵀ and PV) and bytes (q, k, v read, the
output written); each backward (one ``attention_bwd_dq`` launch a call,
beside ``attention_bwd_dsum`` and ``attention_bwd_dkdv``) to the five
products the gradients need, 2.5x the forward's, and twice the forward's
bytes (q, k, v, the output and dO read, dq, dk and dv written; the
log-sum-exp left out), each at ``flops.least_time``.  A call's operations
and bytes are the program's counters ``attention.train_kernel_flops`` and
``attention.train_kernel_bytes`` over ``attention.train_kernel`` (phase
``train_step``; a cell trains at one shape).  None from a program without
those counters, or where the trace holds no such kernel."""
from perfbench import flops, program_obs

FORWARD = "attention_fwd_lse_bf16"
BACKWARD = "attention_bwd_"
BACKWARD_CALL = "attention_bwd_dq"


def read(rec, peak):
    if rec.get("kind") != "train" or peak is None or not rec.get("trace"):
        return None
    calls = program_obs.counter("attention.train_kernel", "train_step")
    call_flops = program_obs.counter("attention.train_kernel_flops", "train_step")
    call_bytes = program_obs.counter("attention.train_kernel_bytes", "train_step")
    if not calls or call_flops is None or call_bytes is None:
        return None
    ops = [(name, e - s) for name, s, e in rec["trace"]["device_ops"]
           if FORWARD in name or BACKWARD in name]
    busy = sum(d for _, d in ops) / 1e6
    if busy <= 0:
        return None
    n_fwd = sum(FORWARD in name for name, _ in ops)
    n_bwd = sum(BACKWARD_CALL in name for name, _ in ops)
    f, b = call_flops / calls, call_bytes / calls
    least = (n_fwd * flops.least_time(f, b, peak)
             + n_bwd * flops.least_time(2.5 * f, 2 * b, peak))
    return 100.0 * least / busy
