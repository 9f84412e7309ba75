"""Mesh construction (port of ``repro/launch/mesh.py``) on
``torch.distributed``'s ``DeviceMesh``.

Both functions take the process group that is already initialised: a mesh
spans its whole world.  ``make_production_mesh`` needs a world of 256 or
512, which only the dry run's fake process group has
(``launch/dryrun.py``); ``make_dev_mesh`` takes the live group, on the
card's device type unless the caller asks for the CPU (the ``gloo`` tests).
"""
from __future__ import annotations

import torch.distributed as dist


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """Single pod: 256 ranks as ("data", "model") = (16, 16).
    Multi-pod: 512 ranks as ("pod", "data", "model") = (2, 16, 16)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for s in shape:
        need *= s
    world = dist.get_world_size()
    if world != need:
        raise RuntimeError(f"the production mesh {shape} needs a world of {need}, "
                           f"the process group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_dev_mesh(n_devices: int | None = None, model: int | None = None,
                  device: str | None = None):
    """A ("data", "model") mesh over the live process group's ``n_devices``
    ranks (default: its whole world), ``model`` of them on the model axis
    (default 2 where the count is even and above 1).  ``device`` is the
    mesh's device type: the card (``"cuda"``) unless the caller asks for
    the CPU."""
    from torch.distributed.device_mesh import init_device_mesh

    n = n_devices or dist.get_world_size()
    model = model or (2 if n % 2 == 0 and n > 1 else 1)
    return init_device_mesh(device or "cuda", (n // model, model),
                            mesh_dim_names=("data", "model"))
