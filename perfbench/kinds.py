"""The kind of a device kernel, by its name: the classifier the port's
training profile uses (a copy of ``chip_smoke.py``'s, so the yardstick
stays with the benchmark)."""
from __future__ import annotations

MATMUL_PATTERNS = ("gemm", "xmma", "cutlass", "nvjet")
SOFTMAX_PATTERNS = ("softmax",)


def kind(name: str) -> str:
    """``matmul`` (cuBLAS and CUTLASS products: gemm, xmma, cutlass,
    nvjet), ``softmax``, or ``other``."""
    low = name.lower()
    if any(w in low for w in MATMUL_PATTERNS):
        return "matmul"
    if any(w in low for w in SOFTMAX_PATTERNS):
        return "softmax"
    return "other"


def seconds_by_kind(device_ops) -> dict:
    out = {"matmul": 0.0, "softmax": 0.0, "other": 0.0}
    for name, start, end in device_ops:
        out[kind(name)] += (end - start) / 1e6
    return out
