"""``train.backward_s``: mean device seconds of the program's
``model.backward`` span (``torch.autograd.grad``, remat's recompute
included) a profiled train step."""
from perfbench import program_obs


def read(rec, peak):
    return program_obs.per_step("model.backward") if rec.get("kind") == "train" else None
