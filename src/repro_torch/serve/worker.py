"""What runs inside a sweep-server worker process.

Workers are long-lived (see :class:`repro_torch.distributed.WorkerPool`):
``init_worker`` runs once per process, before the worker reports
``ready``.  It resolves the device the scheduler named, opens the
process's CUDA context on it and loads the simulator's three kernel
libraries (``dram_timing``, ``edge_update``, ``spmv``; built by ``nvcc``
first where they are not on disk yet), so a worker is only ready with
its kernels loaded.  A worker that cannot get the card or build a kernel
dies in its initializer, and the pool's respawn / retire / broken path
reports it; it never runs a chunk without its kernels.

Every later chunk reuses the process's warm state — the CUDA context and
loaded libraries, the ``hostcache`` artifact/semantics caches and the
runner's graph memo.  ``run_chunk`` executes one scenario chunk and
reports the host-cache hit/miss delta and the kernel-launch delta it
produced, so the server can aggregate worker warmth and show in
``/stats`` that served scenarios went through the kernels (the server's
own process launches none).
"""
from __future__ import annotations

import json
import sys
import time

from repro_torch.sweep.runner import ExecutionPolicy, execute_chunk
from repro_torch.sweep.spec import Scenario

# Long-lived workers see many jobs over many graphs; hold more offline
# artifacts than a one-shot sweep worker would.
ARTIFACTS_CAPACITY = 64
SEMANTICS_CAPACITY = 16
# the kernels of the simulator's path (attention belongs to the LM path)
KERNELS = ("dram_timing", "edge_update", "spmv")


def init_worker(device: str,
                artifacts_capacity: int = ARTIFACTS_CAPACITY,
                semantics_capacity: int = SEMANTICS_CAPACITY) -> None:
    """Per-process warm-up on ``device`` (a string, as the scheduler hands
    it on): resize host caches, pre-import the hot path, and on a CUDA
    device open the context and load the kernels.  Raises when the device
    cannot be had or a kernel cannot be built.  Ends with one
    ``worker_ready`` log line on stderr: the seconds of each step."""
    t0 = time.perf_counter()
    import torch

    from repro_torch.core import hostcache
    from repro_torch.kernels import _build
    from repro_torch.kernels._platform import resolve_device

    dev = resolve_device(device)
    hostcache.configure(artifacts_capacity=artifacts_capacity,
                        semantics_capacity=semantics_capacity)
    import repro_torch.core.accelerators  # noqa: F401  (registers the models)
    import repro_torch.core.engine  # noqa: F401
    import repro_torch.core.semexec  # noqa: F401  (device semantic-execution path)

    steps = dict(imports_s=time.perf_counter() - t0)
    if dev.type == "cuda":
        t0 = time.perf_counter()
        if dev.index is not None:
            torch.cuda.set_device(dev)
        torch.empty(1, device=dev)  # opens this process's CUDA context
        steps["context_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        # nvcc runs here for a library not on disk yet; the pool's
        # deadlines start at ready
        steps["built"] = [name for name in KERNELS
                          if not _build.library_path(name).exists()]
        for name in KERNELS:
            _build.load(name)
        steps["kernels_s"] = time.perf_counter() - t0
    print(json.dumps(dict(ts=time.time(), event="worker_ready", device=str(dev),
                          **steps), separators=(",", ":")), file=sys.stderr, flush=True)


def run_chunk(
    scenarios: list[Scenario],
    mode: str,
    policy: ExecutionPolicy | None,
    with_trace_hash: bool,
    inject=None,
    device=None,
) -> dict:
    """Execute one chunk on ``device``; returns ``{"records": [...],
    "hostcache": delta, "launches": delta}`` where the deltas are this
    chunk's host-cache hit/miss and kernel-launch contributions
    (cumulative worker counters would double-count across chunks).

    ``inject`` is an optional :class:`repro_torch.distributed.faults.FaultAction`
    resolved by the scheduler at dispatch time: pre-work faults (crash /
    hang / stall / delay) fire before the chunk executes, ``corrupt``
    mangles the finished records — so the scheduler's recovery paths are
    exercised against the real worker protocol."""
    from repro_torch.core.hostcache import stats_all
    from repro_torch.kernels._platform import launch_counts

    if inject is not None:
        from repro_torch.distributed import faults

        faults.apply_pre(inject)
    before, launched = stats_all(), launch_counts()
    records = execute_chunk(scenarios, mode=mode, policy=policy,
                            with_trace_hash=with_trace_hash, device=device)
    if inject is not None and inject.kind == "corrupt":
        from repro_torch.distributed import faults

        records = faults.corrupt_records(records)
    after = stats_all()
    delta = {
        cache: {k: after[cache][k] - before[cache][k]
                for k in ("hits", "misses")}
        for cache in after
    }
    launches = {k: v - launched[k] for k, v in launch_counts().items()}
    return dict(records=records, hostcache=delta, launches=launches)
