"""The train step: loss -> gradients -> AdamW update (port of
``repro/train/train_step.py``, without the mesh).

``make_train_step(model, tcfg)`` returns ``step(opt_state, batch) ->
(opt_state, metrics)``.  It differentiates ``Model.loss`` with autograd and
updates the model's parameters and the optimizer state in place; the batch
(host numpy or tensors) is moved to the model's device.  The metrics are
0-d tensors, named as the reference's: ``loss``, ``ce``, ``grad_norm`` and
``lr``, without ``ce`` under accumulation.

With ``micro_steps > 1`` the batch is split into that many microbatches
along its first axis, and each microbatch's gradient is divided by
``micro_steps`` and added to f32 buffers, as the reference's scan does.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.model import Model
from repro_torch.train import optimizer as opt


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: opt.OptimizerConfig = dataclasses.field(default_factory=opt.OptimizerConfig)
    micro_steps: int = 1  # gradient accumulation factor


def make_train_step(model: Model, tcfg: TrainConfig | None = None):
    """Returns train_step(opt_state, batch) -> (opt_state, metrics)."""
    tcfg = tcfg or TrainConfig()
    params = dict(model.named_parameters())

    def to_device(batch: dict) -> dict:
        return {k: torch.as_tensor(v, device=model.device) for k, v in batch.items()}

    def value_and_grad(batch):
        loss, metrics = model.loss(batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), metrics, dict(zip(params, grads))

    def single(opt_state, batch):
        loss, metrics, grads = value_and_grad(to_device(batch))
        opt_state, opt_metrics = opt.update(tcfg.optimizer, grads, opt_state, params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return opt_state, {"loss": loss, **metrics, **opt_metrics}

    def accumulated(opt_state, batch):
        ms = tcfg.micro_steps
        micro = {k: v.reshape((ms, v.shape[0] // ms) + tuple(v.shape[1:]))
                 for k, v in to_device(batch).items()}
        acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for n, p in params.items()}
        loss_acc = torch.zeros((), dtype=torch.float32, device=model.device)
        for i in range(ms):
            loss, _, grads = value_and_grad({k: v[i] for k, v in micro.items()})
            for n, g in grads.items():
                acc[n] += g.float() / ms
            loss_acc = loss_acc + loss / ms
            del grads
        opt_state, opt_metrics = opt.update(tcfg.optimizer, acc, opt_state, params)
        return opt_state, {"loss": loss_acc, **opt_metrics}

    return single if tcfg.micro_steps == 1 else accumulated
