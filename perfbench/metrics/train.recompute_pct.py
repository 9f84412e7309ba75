"""``train.recompute_pct``: the device seconds of remat's recompute (the
program's ``model.recompute`` spans, opened inside the backward) over
those of its ``train_step`` spans, in percent; 0 where nothing is
recomputed."""
from perfbench import program_obs


def read(rec, peak):
    if rec.get("kind") != "train":
        return None
    snap = program_obs.snapshot()
    steps = program_obs.device_seconds(snap, "train_step")
    if steps is None:
        return None
    recompute = program_obs.device_seconds(snap, "model.recompute") or [0.0]
    return 100.0 * sum(recompute) / sum(steps)
