"""``serve.mamba_kernel_pct``: the share of the profiled wave's Mamba
scans in prefill that ran the port's selective-scan kernel,
``mamba.scan_kernel`` over ``mamba.scan_calls`` of phase
``model.prefill``, in percent.  None from a program that does not count
``mamba.scan_kernel`` (one without the kernel), and where no scan ran."""
from perfbench import program_obs


def read(rec, peak):
    if rec.get("kind") != "serve":
        return None
    calls = program_obs.counter("mamba.scan_calls", "model.prefill")
    kernel = program_obs.counter("mamba.scan_kernel", "model.prefill")
    return program_obs.ratio_pct(kernel, calls)
