"""``train.optimizer_s``: synchronised host seconds of ``optimizer.update``
on the steps after the profiled ones."""


def read(rec, peak):
    return rec.get("optimizer_s") if rec.get("kind") == "train" else None
