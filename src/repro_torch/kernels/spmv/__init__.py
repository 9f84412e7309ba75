"""ELL SpMV kernel (CUDA, ``csrc/spmv.cu``) and its plain versions."""
from repro_torch.kernels.spmv.ops import spmv, spmv_edges
from repro_torch.kernels.spmv.spmv import (
    spmv_coo_plain,
    spmv_ell,
    spmv_ell_plain,
    to_ell,
)

__all__ = ["spmv", "spmv_coo_plain", "spmv_edges", "spmv_ell", "spmv_ell_plain",
           "to_ell"]
