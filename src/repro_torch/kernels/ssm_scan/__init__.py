"""The fused selective-scan forward (CUDA, ``csrc/ssm_scan.cu``): Mamba's
scan on the serving route; its plain version is
``models/ssm.py::selective_scan_plain``."""
from repro_torch.kernels.ssm_scan.ssm_scan import ssm_scan_fwd

__all__ = ["ssm_scan_fwd"]
