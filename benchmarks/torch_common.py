"""What the port's simulator bench twins share: the device they run on,
the card's name and power limit, and a synchronised clock."""
from __future__ import annotations

import subprocess
import sys
import time


def device_or_exit(device):
    """The resolved ``--device`` (``None``: the CUDA card).  Without a card
    and without ``--device``: ``error: ...`` on stderr and exit 2."""
    from repro_torch.kernels._platform import resolve_device

    try:
        return resolve_device(device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        raise SystemExit(2)


def card(dev) -> str | None:
    """``nvidia-smi``'s name and power limit of the card, or None on the CPU."""
    if dev.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def clock(dev) -> float:
    """``time.perf_counter()`` after the card has finished its queued work."""
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)
    return time.perf_counter()
