"""``serve.prefill_mfu_pct``: a wave's prefill operations
(``flops.prefill_flops``) over the mean prefill time of the traced run's
waves (CUDA events around ``Model.prefill``), as a share of the bf16 peak."""


def read(rec, peak):
    if rec.get("kind") != "serve" or peak is None or not rec.get("prefill_s"):
        return None
    return 100.0 * rec["prefill_flops"] / (rec["prefill_s"] * peak["bf16_flops_per_s"])
