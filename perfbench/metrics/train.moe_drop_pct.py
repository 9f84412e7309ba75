"""``train.moe_drop_pct``: the share of routed (token, expert) pairs that
capacity drops in the profiled train steps' forwards, 1 - ``moe.kept`` /
``moe.pairs`` of phase ``train_step``, in percent."""
from perfbench import program_obs


def read(rec, peak):
    if rec.get("kind") != "train":
        return None
    kept = program_obs.ratio_pct(program_obs.counter("moe.kept", "train_step"),
                                 program_obs.counter("moe.pairs", "train_step"))
    return None if kept is None else 100.0 - kept
