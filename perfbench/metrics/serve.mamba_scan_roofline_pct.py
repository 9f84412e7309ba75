"""``serve.mamba_scan_roofline_pct``: the selective scan's least time in
the profiled wave's prefill over the device seconds of the program's
``mamba.scan`` spans there, in percent.  The least time is the scan's
least bytes (``flops_hybrid.scan_bytes`` of the counter
``mamba.scan_tokens`` of phase ``model.prefill`` and the record's widths)
over the card's memory bandwidth (``peaks.json``); its arithmetic is not
counted.  None from a program without the span or the counter,
from a record without the widths, and from a CPU run."""
from perfbench import flops_hybrid, program_obs, program_phase


def read(rec, peak):
    if rec.get("kind") != "serve" or peak is None or not rec.get("mamba"):
        return None
    snap = program_obs.snapshot()
    if snap is None:
        return None
    tokens = snap["counters"].get("mamba.scan_tokens", {}).get("model.prefill")
    seconds = program_phase.device_seconds_within(snap, "mamba.scan", "model.prefill")
    if not tokens or seconds is None or sum(seconds) <= 0:
        return None
    m = rec["mamba"]
    least = flops_hybrid.scan_bytes(tokens, m["d_inner"], m["d_state"]) / peak["hbm_bytes_per_s"]
    return 100.0 * least / sum(seconds)
