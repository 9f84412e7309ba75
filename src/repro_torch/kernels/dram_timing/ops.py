"""Public op: DRAM timing of whole traces through the DRAM timing kernel.

``simulate_trace`` times one trace; ``simulate_trace_batch`` times many in
one call of ``dram_timing_batch`` (one row of the padded ``[B, L]`` batch a
trace), the counterparts of ``repro/kernels/dram_timing/ops.py``.  On a
CUDA device the call launches the kernels of ``csrc/dram_timing.cu``; on
the CPU it takes their plain version.  The engine does not route through
these functions (it batches by length bucket itself); the kernel benches
do.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dram import DRAMConfig
from repro_torch.core.engine import TraceBatch
from repro_torch.core.trace import Trace
from repro_torch.kernels._platform import resolve_device
from repro_torch.kernels.dram_timing.dram_timing import dram_timing_batch

_ZERO = dict(cycles=0, hits=0, misses=0, conflicts=0)


def _timing_kwargs(cfg: DRAMConfig) -> dict:
    """The kernel's timing arguments for ``cfg``."""
    t = cfg.timing_cycles()
    return dict(nbanks=cfg.nbanks, tCL=t["tCL"], tRCD=t["tRCD"], tRP=t["tRP"],
                tRC=t["tRC"], tBL=t["tBL"], lookahead=16 * t["tBL"],
                page_open=cfg.page_open)


def simulate_trace(trace: Trace, cfg: DRAMConfig, *, device=None) -> dict:
    """Time a single-channel trace on ``device`` (``None``: the CUDA card);
    returns cycles + row-buffer stats."""
    return simulate_trace_batch([trace], cfg, device=device)[0]


def simulate_trace_batch(traces: list[Trace], cfg: DRAMConfig, *,
                         device=None) -> list[dict]:
    """Time many single-channel traces with one call of the kernel's
    wrapper on ``device`` (``None``: the CUDA card).

    Traces are packed into a ``[B, L]`` batch padded with bank == -1, each
    row timed from a cold device up to its own length.  Returns one stats
    dict per trace, in order; an empty trace reports zeros, as in the
    reference, and a batch of empty traces launches nothing."""
    dev = resolve_device(device)
    if not any(t.n for t in traces):
        return [dict(_ZERO) for _ in traces]
    batch = TraceBatch.from_traces(traces, cfg, pad_batch=False)
    out = dram_timing_batch(
        torch.from_numpy(batch.bank).to(dev), torch.from_numpy(batch.row).to(dev),
        torch.from_numpy(batch.lengths.astype(np.int32)).to(dev),
        **_timing_kwargs(cfg)).cpu().numpy()
    return [dict(_ZERO) if t.n == 0 else
            dict(cycles=int(o[0]), hits=int(o[1]), misses=int(o[2]),
                 conflicts=int(o[3]))
            for t, o in zip(traces, out)]
