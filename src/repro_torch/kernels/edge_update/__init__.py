"""Edge-update (scatter-min) kernel (CUDA, ``csrc/edge_update.cu``) and its
plain version."""
from repro_torch.kernels.edge_update.edge_update import (
    edge_update,
    edge_update_plain,
    sentinel_max,
)
from repro_torch.kernels.edge_update.ops import relax_step, scatter_min

__all__ = ["edge_update", "edge_update_plain", "relax_step", "scatter_min",
           "sentinel_max"]
