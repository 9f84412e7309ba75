"""DRAM timing kernel (CUDA, ``csrc/dram_timing.cu``) and its plain version."""
from repro_torch.kernels.dram_timing.dram_timing import (
    MATRIX_BANKS,
    MAX_BANKS,
    dram_timing_batch,
    dram_timing_batch_plain,
    matrix_path_holds,
    plan_segments,
    target_warps,
)

__all__ = ["MATRIX_BANKS", "MAX_BANKS", "dram_timing_batch", "dram_timing_batch_plain",
           "matrix_path_holds", "plan_segments", "target_warps"]
