"""DRAM timing kernel (CUDA, ``csrc/dram_timing.cu``) and its plain version."""
from repro_torch.kernels.dram_timing.dram_timing import (
    MAX_BANKS,
    dram_timing_batch,
    dram_timing_batch_plain,
)

__all__ = ["MAX_BANKS", "dram_timing_batch", "dram_timing_batch_plain"]
