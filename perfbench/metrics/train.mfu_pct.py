"""``train.mfu_pct``: the train step's needed operations (``flops.train_flops``)
over the mean time of the traced run's unprofiled steps, as a share of the
card's bf16 peak."""


def read(rec, peak):
    if rec.get("kind") != "train" or peak is None or not rec.get("step_s"):
        return None
    return 100.0 * rec["step_flops"] / (rec["step_s"] * peak["bf16_flops_per_s"])
