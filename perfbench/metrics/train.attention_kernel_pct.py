"""``train.attention_kernel_pct``: the share of the profiled train steps'
self-attention calls that attended through the port's training kernels,
``attention.train_kernel`` over ``attention.train_calls`` of phase
``train_step``, in percent (0 where no call took them).  None from a
program that counts no call."""
from perfbench import program_obs


def read(rec, peak):
    if rec.get("kind") != "train":
        return None
    calls = program_obs.counter("attention.train_calls", "train_step")
    kernel = program_obs.counter("attention.train_kernel", "train_step")
    return program_obs.ratio_pct(kernel or 0, calls) if calls is not None else None
