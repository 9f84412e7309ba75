"""Roofline analysis of the port: compute / memory / collective terms on
the H100 (``analysis``), from per-device op counts of an eager step
(``counter``), as the dry run reads them (``launch/dryrun.py``)."""
from repro_torch.roofline.analysis import HW, HardwareSpec, model_flops, roofline_terms

__all__ = ["HW", "HardwareSpec", "model_flops", "roofline_terms"]
