"""Distribution in the port: the supervised spawn-context worker pool the
sweep server shards scenario chunks across
(:mod:`repro_torch.distributed.workpool`), its multi-host counterpart —
a :class:`RemoteWorkerPool` the server dispatches to over the wire and the
:class:`WorkerHostAgent` each worker host runs on its own card
(:mod:`repro_torch.distributed.remote`) — and the deterministic
fault-injection harness that exercises their recovery paths and that the
sweep runner consults when an
:class:`~repro_torch.sweep.runner.ExecutionPolicy` carries a fault plan
(:mod:`repro_torch.distributed.faults`); and the sharding rules of the LM
scaffolding on DTensor (:mod:`repro_torch.distributed.sharding`, with the
activation policy in :mod:`repro_torch.distributed.context`).

Exports resolve lazily, as the reference's do: spawn-context worker
children import this package on their way to ``workpool`` and should pay
for nothing else.
"""
from __future__ import annotations

__all__ = ["FaultPlan", "FaultRule", "RemoteWorkerPool", "WorkerHostAgent",
           "WorkerLost", "WorkerPool", "parse_address", "run_worker_host",
           "batch_axes", "batch_specs", "cache_specs", "param_specs", "shardings"]

_LAZY = {
    "WorkerPool": ("repro_torch.distributed.workpool", "WorkerPool"),
    "WorkerLost": ("repro_torch.distributed.workpool", "WorkerLost"),
    "FaultPlan": ("repro_torch.distributed.faults", "FaultPlan"),
    "FaultRule": ("repro_torch.distributed.faults", "FaultRule"),
    "RemoteWorkerPool": ("repro_torch.distributed.remote", "RemoteWorkerPool"),
    "WorkerHostAgent": ("repro_torch.distributed.remote", "WorkerHostAgent"),
    "parse_address": ("repro_torch.distributed.remote", "parse_address"),
    "run_worker_host": ("repro_torch.distributed.remote", "run_worker_host"),
    "batch_axes": ("repro_torch.distributed.sharding", "batch_axes"),
    "batch_specs": ("repro_torch.distributed.sharding", "batch_specs"),
    "cache_specs": ("repro_torch.distributed.sharding", "cache_specs"),
    "param_specs": ("repro_torch.distributed.sharding", "param_specs"),
    "shardings": ("repro_torch.distributed.sharding", "shardings"),
}


def __getattr__(name: str):
    try:
        module, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    value = getattr(importlib.import_module(module), attr)
    globals()[name] = value  # cache: resolve each name once
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
