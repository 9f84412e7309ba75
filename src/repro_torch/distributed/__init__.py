"""Distribution in the port: so far the deterministic fault-injection
harness (:mod:`repro_torch.distributed.faults`) that the sweep runner
consults when an :class:`~repro_torch.sweep.runner.ExecutionPolicy`
carries a fault plan.

The reference's worker pools (``workpool``, ``remote``) and its sharding
rules are not ported yet, so their names are not listed here.  Exports
resolve lazily, as the reference's do: spawn-context worker children
import this package on their way to a submodule and should pay for
nothing else.
"""
from __future__ import annotations

__all__ = ["FaultPlan", "FaultRule"]

_LAZY = {
    "FaultPlan": ("repro_torch.distributed.faults", "FaultPlan"),
    "FaultRule": ("repro_torch.distributed.faults", "FaultRule"),
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
