"""``train.fwd_bwd_s``: synchronised host seconds of ``Model.loss`` and
``torch.autograd.grad`` on the steps after the profiled ones."""


def read(rec, peak):
    return rec.get("fwd_bwd_s") if rec.get("kind") == "train" else None
