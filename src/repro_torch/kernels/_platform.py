"""Device policy and launch counters shared by the port's kernels.

Counterpart of ``repro/kernels/_platform.py::resolve_pallas``.  Every entry
point of the port takes ``device=None``:

- ``None`` means the CUDA card (``torch.device("cuda")``); without one the
  call raises ``RuntimeError`` — there is no silent CPU fallback.
- ``"cpu"`` (or any explicit device) is honoured as given.  On the CPU the
  kernels' wrappers take their plain PyTorch versions; on a CUDA tensor they
  launch the hand-written kernel or raise.

``LAUNCHES`` holds one plain integer per kernel, bumped by its wrapper where
it launches the kernel and nowhere else, so a run can show that the main
path went through the kernels.
"""
from __future__ import annotations

import torch

LAUNCHES: dict[str, int] = {"dram_timing": 0, "edge_update": 0, "spmv": 0,
                             "attention": 0}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card for ``None``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)
