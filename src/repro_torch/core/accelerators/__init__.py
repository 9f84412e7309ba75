"""The four graph processing accelerator models (paper Sect. 3.2).

Each model executes a graph problem under the accelerator's own iteration /
partitioning / update-propagation scheme (so convergence behaviour is
faithful — e.g. immediate propagation converges in fewer iterations) while
emitting the off-chip memory request trace that the DRAM engine times.
"""
from repro_torch.core.accelerators.base import AccelConfig, Accelerator, run_accelerator
from repro_torch.core.accelerators.accugraph import AccuGraph
from repro_torch.core.accelerators.foregraph import ForeGraph
from repro_torch.core.accelerators.hitgraph import HitGraph
from repro_torch.core.accelerators.thundergp import ThunderGP

ACCELERATORS: dict[str, type[Accelerator]] = {
    "accugraph": AccuGraph,
    "foregraph": ForeGraph,
    "hitgraph": HitGraph,
    "thundergp": ThunderGP,
}

__all__ = [
    "AccelConfig",
    "Accelerator",
    "AccuGraph",
    "ForeGraph",
    "HitGraph",
    "ThunderGP",
    "ACCELERATORS",
    "run_accelerator",
]
