"""``serve.moe_prefill_fill_pct``: the expert slots of the profiled wave's
prefill that hold a kept pair, ``moe.kept`` / ``moe.slots`` of phase
``model.prefill``, in percent (the rest compute a zero row)."""
from perfbench import program_obs


def read(rec, peak):
    if rec.get("kind") != "serve":
        return None
    return program_obs.ratio_pct(program_obs.counter("moe.kept", "model.prefill"),
                                 program_obs.counter("moe.slots", "model.prefill"))
