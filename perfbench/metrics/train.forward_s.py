"""``train.forward_s``: mean device seconds of the program's
``model.forward`` span (``Model.loss``) a profiled train step."""
from perfbench import program_obs


def read(rec, peak):
    return program_obs.per_step("model.forward") if rec.get("kind") == "train" else None
