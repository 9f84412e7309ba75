"""Carry state into the port from plain numpy arrays and dicts.

The simulator has no weights; its state is graphs, DRAM/controller
configurations, accelerator configurations and request traces.  These
functions build the port's objects from the reference's objects flattened
to numpy arrays and plain dicts (``dataclasses.asdict``), so a caller can
hand both packages the same inputs without the port importing the
reference.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.accelerators.base import AccelConfig
from repro_torch.core.dram import AddressMapping, DRAMConfig
from repro_torch.core.trace import Trace
from repro_torch.graph.structure import Graph


def graph_from_numpy(n: int, src: np.ndarray, dst: np.ndarray,
                     weights: np.ndarray | None = None, name: str = "graph",
                     directed: bool = True) -> Graph:
    """A :class:`Graph` over copies of the given COO arrays."""
    return Graph(
        n=int(n),
        src=np.array(src, dtype=np.int32),
        dst=np.array(dst, dtype=np.int32),
        weights=None if weights is None else np.array(weights, dtype=np.float32),
        name=name,
        directed=bool(directed),
    )


def dram_config_from_dict(d: dict) -> DRAMConfig:
    """A :class:`DRAMConfig` from ``dataclasses.asdict`` of one, including
    the nested address mapping."""
    d = dict(d)
    if isinstance(d.get("mapping"), dict):
        d["mapping"] = AddressMapping(**d["mapping"])
    return DRAMConfig(**d)


def accel_config_from_dict(d: dict) -> AccelConfig:
    """An :class:`AccelConfig` from ``dataclasses.asdict`` of one
    (``optimizations`` may come as any iterable of names)."""
    d = dict(d)
    if "optimizations" in d:
        d["optimizations"] = frozenset(d["optimizations"])
    return AccelConfig(**d)


def traces_from_numpy(items) -> list[Trace]:
    """Eager traces from ``[(lines, is_write), ...]`` numpy pairs."""
    return [Trace(np.array(lines, dtype=np.int64), np.array(wr, dtype=bool))
            for lines, wr in items]
