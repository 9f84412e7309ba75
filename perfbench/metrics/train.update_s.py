"""``train.update_s``: mean device seconds of the program's
``optimizer.update`` span a profiled train step."""
from perfbench import program_obs


def read(rec, peak):
    return program_obs.per_step("optimizer.update") if rec.get("kind") == "train" else None
