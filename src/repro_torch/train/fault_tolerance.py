"""Fault tolerance: supervised training with checkpoint/restart, straggler
surveillance and elastic re-meshing (port of
``repro/train/fault_tolerance.py``).

- ``run_supervised`` drives the train loop; a step raising
  ``WorkerFailure`` triggers a restore from the latest checkpoint into the
  live model and optimizer state, and the loop resumes there.  The data of
  a step is a function of the step, so the resumed run is bit-equal to an
  uninterrupted one.
- ``remesh`` places live (DTensor) state onto another mesh, e.g. after
  losing a pod.
- ``StragglerMonitor`` tracks a robust step-time estimate (median + MAD)
  and flags steps beyond ``threshold`` MADs, feeding the supervisor's
  ``on_straggler`` callback.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.train.checkpoint import Checkpointer


class WorkerFailure(RuntimeError):
    """Injected/observed worker failure (preemption, hardware fault)."""


@dataclasses.dataclass
class StragglerMonitor:
    """Robust step-time outlier detection (median + MAD)."""

    window: int = 32
    threshold: float = 6.0  # MADs above median
    _times: list = dataclasses.field(default_factory=list)
    flagged: list = dataclasses.field(default_factory=list)

    def record(self, step: int, seconds: float) -> bool:
        """Returns True if this step is a straggler outlier."""
        times = self._times[-self.window :]
        is_outlier = False
        if len(times) >= 8:
            med = float(np.median(times))
            mad = float(np.median(np.abs(np.asarray(times) - med))) or 1e-9
            if seconds > med + self.threshold * mad and seconds > 1.5 * med:
                is_outlier = True
                self.flagged.append((step, seconds, med))
        self._times.append(seconds)
        return is_outlier


@dataclasses.dataclass
class SupervisorConfig:
    checkpoint_every: int = 50
    max_restarts: int = 10
    async_checkpoint: bool = True


def run_supervised(
    *,
    train_step: Callable,
    params: Any,
    opt_state: Any,
    data_source: Any,
    n_steps: int,
    ckpt: Checkpointer,
    cfg: SupervisorConfig = SupervisorConfig(),
    fail_at: Optional[Callable[[int], bool]] = None,
    on_straggler: Optional[Callable[[int], None]] = None,
    log_every: int = 10,
    log: Callable[[str], None] = print,
):
    """Train with checkpoint/restart under (injected) failures.

    ``train_step(opt_state, batch) -> (opt_state, metrics)`` updates
    ``params`` (the model) in place; checkpoints hold ``(params,
    opt_state)``.  Returns (params, opt_state, history: list of (step, loss))."""
    monitor = StragglerMonitor()
    history: list = []
    restarts = 0
    step = 0

    # resume if a checkpoint exists
    latest = ckpt.latest_step()
    if latest is not None:
        _, step = ckpt.restore((params, opt_state))
        log(f"[ft] resumed from checkpoint step {step}")

    while step < n_steps:
        try:
            t0 = time.time()
            batch = data_source.batch(step)
            if fail_at is not None and fail_at(step):
                raise WorkerFailure(f"injected failure at step {step}")
            opt_state, metrics = train_step(opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            if monitor.record(step, dt) and on_straggler is not None:
                on_straggler(step)
            step += 1
            history.append((step, loss))
            if log_every and step % log_every == 0:
                log(f"[train] step {step} loss {loss:.4f} ({dt:.2f}s)")
            if step % cfg.checkpoint_every == 0 or step == n_steps:
                if cfg.async_checkpoint:
                    ckpt.save_async(step, (params, opt_state))
                else:
                    ckpt.save(step, (params, opt_state))
        except WorkerFailure as e:
            restarts += 1
            log(f"[ft] {e} -> restart {restarts}/{cfg.max_restarts}")
            if restarts > cfg.max_restarts:
                raise
            ckpt.wait()
            latest = ckpt.latest_step()
            if latest is None:
                step = 0  # restart from scratch
                continue
            _, step = ckpt.restore((params, opt_state))
            log(f"[ft] restored step {step}")
    ckpt.wait()
    return params, opt_state, history


def remesh(tree: Any, new_mesh, specs: Any) -> Any:
    """Elastic re-mesh of live state onto a different mesh: every tensor of
    ``tree`` (a dict/list tree of tensors or DTensors) is gathered whole and
    placed onto ``new_mesh`` by ``specs`` (a ``P`` tree in its structure),
    the reference's ``device_put`` against the new mesh's shardings."""
    from repro_torch.distributed.context import whole
    from repro_torch.distributed.sharding import place, shardings

    pls = shardings(new_mesh, specs)

    def move(node, pl):
        if isinstance(node, dict):
            return {k: move(v, pl[k]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(move(v, p) for v, p in zip(node, pl))
        return place(whole(node).detach().to(new_mesh.device_type), new_mesh, pl)

    return move(tree, pls)
