"""``serve.moe_drop_pct``: the share of routed (token, expert) pairs of the
profiled wave's prefill that capacity drops, 1 - ``moe.kept`` /
``moe.pairs`` of phase ``model.prefill``, in percent."""
from perfbench import program_obs


def read(rec, peak):
    if rec.get("kind") != "serve":
        return None
    kept = program_obs.ratio_pct(program_obs.counter("moe.kept", "model.prefill"),
                                 program_obs.counter("moe.pairs", "model.prefill"))
    return None if kept is None else 100.0 - kept
