"""``serve.decode_step_ms``: mean milliseconds of a decode step in the traced
run's waves (CUDA events around ``Model.decode_step``)."""


def read(rec, peak):
    if rec.get("kind") != "serve" or not rec.get("decode_step_s"):
        return None
    return 1000.0 * rec["decode_step_s"]
