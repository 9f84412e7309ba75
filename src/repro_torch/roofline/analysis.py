"""Roofline terms of a step on the H100 (port of
``repro/roofline/analysis.py``).

    compute term    = FLOPs / peak FLOP/s              (per device)
    memory term     = bytes / HBM bandwidth            (per device)
    collective term = collective bytes / link bandwidth (per device)

The inputs are per-device counts of one step, from ``roofline/counter.py``
(the dry run's ``op_analysis``).  The reference also parses collective
bytes out of XLA's HLO text (``collective_bytes``); the port has no HLO,
so that function has no twin here: the counter reads them from the
collectives DTensor issues.

Hardware constants: one NVIDIA H100 SXM (NVIDIA's H100 Tensor Core GPU
datasheet: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, 900 GB/s NVLink, 450
GB/s each way).  The reference's constants are a TPU v5e's; none carries
over.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str = "h100-sxm"
    peak_flops: float = 989e12  # dense bf16 FLOP/s per device
    hbm_bw: float = 3.35e12  # B/s per device
    link_bw: float = 450e9  # NVLink B/s per device, each way


HW = HardwareSpec()


def roofline_terms(
    flops_per_device: float,
    bytes_per_device: float,
    coll_bytes_per_device: float,
    hw: HardwareSpec = HW,
) -> dict[str, float]:
    ct = flops_per_device / hw.peak_flops
    mt = bytes_per_device / hw.hbm_bw
    lt = coll_bytes_per_device / hw.link_bw
    dominant = max(("compute", ct), ("memory", mt), ("collective", lt), key=lambda t: t[1])
    bound = max(ct, mt, lt)
    return {
        "compute_s": ct,
        "memory_s": mt,
        "collective_s": lt,
        "dominant": dominant[0],
        "roofline_bound_s": bound,
        # fraction of the bound attributable to useful compute
        "compute_fraction_of_bound": ct / bound if bound > 0 else 0.0,
    }


def model_flops(cfg, tokens: int, kind: str = "train") -> float:
    """MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE); 2 N D for inference."""
    n = cfg.active_param_count() if cfg.n_experts else cfg.param_count()
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * tokens
