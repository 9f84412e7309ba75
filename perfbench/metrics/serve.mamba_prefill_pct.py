"""``serve.mamba_prefill_pct``: device seconds of the program's ``mamba``
spans (the whole Mamba mixer) inside ``model.prefill``, over
``model.prefill``'s own, in the profiled wave, in percent.  None from a
program without those spans, and from a CPU run."""
from perfbench import program_obs, program_phase


def read(rec, peak):
    if rec.get("kind") != "serve":
        return None
    snap = program_obs.snapshot()
    prefill = program_obs.device_seconds(snap, "model.prefill")
    mamba = program_phase.device_seconds_within(snap, "mamba", "model.prefill")
    if not prefill or mamba is None or sum(prefill) <= 0:
        return None
    return 100.0 * sum(mamba) / sum(prefill)
