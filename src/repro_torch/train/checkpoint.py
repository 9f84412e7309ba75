"""Checkpointing: atomic, async save and in-place restore (port of
``repro/train/checkpoint.py``).

Layout, as the reference's:  <dir>/step_<N>/
            manifest.json     step, flat key list, dtypes/shapes, time
            shard_p<i>.npz    this process's arrays (flat key -> array)

A tree is a nested dict, list or tuple whose leaves are tensors; an
``nn.Module`` in it stands for its parameters.  Flat keys join the path
with ``/`` and take a module's (dotted) parameter names, e.g.
``0/blocks.3.attn.wq`` and ``1/m/blocks.3.attn.wq`` for ``(model,
opt_state)``.

- *atomic*: written to step_<N>.tmp and renamed only after the manifest's
  fsync, so a job killed mid-save never corrupts the latest checkpoint;
- *async*: ``save_async`` copies every tensor to the host first (a copy
  also for CPU tensors, which the next step updates in place), then writes
  on a background thread;
- *restartable*: ``latest_step``/``restore`` pick the newest complete
  checkpoint; partial ``.tmp`` saves are ignored and garbage-collected;
- *bounded*: keeps the newest ``keep`` checkpoints.

bf16 is stored as a ``uint16`` view with its dtype in the manifest, and is
restored from those bits without ``ml_dtypes``.  ``restore`` copies into
the given tree's tensors in place, on whatever device they live.

Checkpoints hold whole (global) arrays.  A DTensor is gathered whole to be
saved (a collective: every rank of its mesh saves), and
``restore_sharded`` places each restored array onto a mesh by the given
specs, as the reference's ``device_put`` does: the elastic restart onto
another mesh.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.distributed.context import whole


def _flat_tensors(tree: Any, prefix: str = "") -> dict[str, torch.Tensor]:
    """flat key -> tensor of every leaf of ``tree``."""
    if isinstance(tree, torch.Tensor):
        return {prefix.rstrip("/"): tree}
    if isinstance(tree, nn.Module):
        items = tree.named_parameters()
    elif isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        raise TypeError(f"{prefix or 'tree'}: cannot checkpoint a {type(tree).__name__}")
    flat = {}
    for key, value in items:
        flat.update(_flat_tensors(value, f"{prefix}{key}/"))
    return flat


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (bf16 as its uint16 bits); a DTensor whole."""
    t = whole(t.detach()).to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    arr = np.require(arr, requirements=["C", "W"])  # keeps 0-d arrays 0-d
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, process_index: int = 0):
        self.dir = directory
        self.keep = keep
        self.process_index = process_index
        self._thread: Optional[threading.Thread] = None
        # the last save: step, seconds of the host copy and of the write, bytes
        self.last_save: dict = {}
        os.makedirs(directory, exist_ok=True)

    # ---- write ----

    def _snapshot(self, tree: Any) -> tuple[dict, dict]:
        t0 = time.perf_counter()
        flat = _flat_tensors(tree)
        dtypes = {k: _dtype_name(t) for k, t in flat.items()}
        arrays = {k: _to_numpy(t) for k, t in flat.items()}
        self.last_save = {"snapshot_s": time.perf_counter() - t0}
        return arrays, dtypes

    def _write(self, step: int, arrays: dict[str, np.ndarray], dtypes: dict[str, str],
               meta: dict):
        t0 = time.perf_counter()
        tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
        final = os.path.join(self.dir, f"step_{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "keys": {}, "time": time.time()}
        for k, v in arrays.items():
            manifest["keys"][k] = {"dtype": dtypes[k], "shape": list(v.shape)}
        shard = os.path.join(tmp, f"shard_p{self.process_index}.npz")
        np.savez(shard, **{k.replace("/", "__"): v for k, v in arrays.items()})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        self.last_save.update(step=step, write_s=time.perf_counter() - t0,
                              bytes=sum(v.nbytes for v in arrays.values()))

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)
        # drop stale tmp dirs (crashed saves)
        for name in os.listdir(self.dir):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)

    def save(self, step: int, tree: Any, meta: dict | None = None):
        self._write(step, *self._snapshot(tree), meta or {})

    def save_async(self, step: int, tree: Any, meta: dict | None = None):
        self.wait()
        arrays, dtypes = self._snapshot(tree)  # host copies: a consistent view
        self._thread = threading.Thread(
            target=self._write, args=(step, arrays, dtypes, meta or {}), daemon=True
        )
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ---- read ----

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                    steps.append(int(name[5:]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree: Any, step: Optional[int] = None) -> tuple[Any, int]:
        """Copy a checkpoint (the latest by default) into ``tree``'s tensors
        in place.  Raises on a missing key or a shape that differs; a dtype
        that differs is cast.  Returns (tree, step)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, f"shard_p{self.process_index}.npz")) as z, \
                torch.no_grad():
            for key, t in _flat_tensors(tree).items():
                if key not in manifest["keys"]:
                    raise KeyError(f"checkpoint missing {key}")
                src = _from_numpy(z[key.replace("/", "__")], manifest["keys"][key]["dtype"])
                if tuple(src.shape) != tuple(t.shape):
                    raise ValueError(f"{key}: shape {tuple(src.shape)} != {tuple(t.shape)}")
                t.copy_(src.to(t.dtype))
        return tree, step

    def restore_sharded(self, tree: Any, mesh, specs: Any, step: Optional[int] = None):
        """Restore a checkpoint (the latest by default) whole and place each
        array onto ``mesh`` by ``specs`` (a ``P`` tree in ``tree``'s
        structure): the elastic restart path, on a mesh that may differ from
        the one that saved.  ``tree`` (a dict/list tree of tensors or
        DTensors) gives the keys, shapes and dtypes; it is not changed.
        Returns (placed tree, step)."""
        from repro_torch.distributed.sharding import place, shardings

        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        pls = shardings(mesh, specs)
        with np.load(os.path.join(d, f"shard_p{self.process_index}.npz")) as z:

            def build(node, pl, prefix):
                if isinstance(node, dict):
                    return {k: build(v, pl[k], f"{prefix}{k}/") for k, v in node.items()}
                if isinstance(node, (list, tuple)):
                    return type(node)(build(v, p, f"{prefix}{i}/")
                                      for i, (v, p) in enumerate(zip(node, pl)))
                key = prefix.rstrip("/")
                if key not in manifest["keys"]:
                    raise KeyError(f"checkpoint missing {key}")
                src = _from_numpy(z[key.replace("/", "__")], manifest["keys"][key]["dtype"])
                if tuple(src.shape) != tuple(node.shape):
                    raise ValueError(f"{key}: shape {tuple(src.shape)} != {tuple(node.shape)}")
                return place(src.to(mesh.device_type).to(node.dtype), mesh, pl)

            return build(tree, pls, ""), step
