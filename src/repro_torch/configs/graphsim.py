"""Presets for the paper's own experiments: accelerator model configs and
scaled interval sizes (see EXPERIMENTS.md for the scaling rationale).

The paper's BRAM-capacity-derived interval sizes are scaled by the same
~1/64 factor as the graph suite:
- AccuGraph: 1,024,000-vertex on-chip capacity -> 16,384
- ForeGraph: 65,536-vertex intervals          -> 4,096 (keeps q ~= paper)
- HitGraph / ThunderGP: partition size         -> 16,384
"""
from __future__ import annotations

from repro_torch.core.accelerators.base import AccelConfig

ALL = frozenset({"all"})
NONE: frozenset = frozenset()


def accugraph_config(opts: frozenset = ALL, engine: str = "auto") -> AccelConfig:
    return AccelConfig(interval_size=16384, n_pes=1, optimizations=opts, engine=engine)


def foregraph_config(opts: frozenset = ALL, n_pes: int = 4, engine: str = "auto") -> AccelConfig:
    return AccelConfig(interval_size=4096, n_pes=n_pes, optimizations=opts, engine=engine)


def hitgraph_config(opts: frozenset = ALL, channels: int = 1, engine: str = "auto") -> AccelConfig:
    return AccelConfig(interval_size=16384, n_pes=channels, optimizations=opts, engine=engine)


def thundergp_config(opts: frozenset = ALL, channels: int = 1, engine: str = "auto") -> AccelConfig:
    return AccelConfig(interval_size=16384, n_pes=channels, optimizations=opts, engine=engine)


CONFIG_FACTORIES = {
    "accugraph": accugraph_config,
    "foregraph": foregraph_config,
    "hitgraph": hitgraph_config,
    "thundergp": thundergp_config,
}


def default_config(accel: str, **kw) -> AccelConfig:
    return CONFIG_FACTORIES[accel](**kw)


# Memory-controller scenario axes (SweepSpec fields of the same names).
# The defaults — row-interleaved mapping, open page, no pseudo-channels —
# reproduce the paper's implicit controller; the full cross product is the
# memory-sensitivity study (benchmarks/bench_memory.py).
MEMORY_AXES: dict[str, tuple] = dict(
    mappings=("row", "bank", "bank_xor"),
    page_policies=("open", "closed"),
    pseudo_channels=(False, True),
)

# The subset the memory-sensitivity study sweeps by default: the extremes
# of each axis on the HBM preset.
MEMORY_SENSITIVITY_AXES: dict[str, tuple] = dict(
    mappings=("row", "bank_xor"),
    page_policies=("open", "closed"),
    pseudo_channels=(False, True),
)

# Graph-layout scenario axes (SweepSpec fields of the same names).  The
# defaults — identity vertex order, scale-1 intervals — reproduce the
# generator's layout exactly; the cross product is the partitioning
# sensitivity study (benchmarks/bench_partition.py).
LAYOUT_AXES: dict[str, tuple] = dict(
    reorders=("identity", "degree", "bfs", "random"),
    interval_scales=(1, 2),
)
