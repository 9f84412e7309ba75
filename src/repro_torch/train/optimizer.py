"""AdamW with configurable moment dtypes, global-norm clipping and a
warmup+cosine schedule (port of ``repro/train/optimizer.py``).

The state is ``{"step": 0-d int32 tensor, "m": {name: tensor}, "v": {name:
tensor}}``, keyed by the model's parameter names.  ``update`` changes the
parameters and the state in place under ``torch.no_grad()``; it computes in
f32 as the reference does, with the schedule and the bias corrections as
f32 tensors (Python floats would round them otherwise).

``moment_dtype="bfloat16"`` keeps m in bf16 (v too with ``aggressive``),
rounded from f32 on every update.

The update takes a leaf ``UPDATE_CHUNK`` elements at a time.  Its f32
temporaries (the gradient, both moments, their corrections, the step and
the weight widened: about nine times a slice's elements at once) would
otherwise reach 34 GB on jamba's (16, 4,096, 14,336) expert stack and 38 GB
on llama-vision's 1.05 B-entry embedding, more than the card holds beside
the weights and moments.  Every op is elementwise, so the numbers are the
same.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.layers import dtype_of

UPDATE_CHUNK = 1 << 26  # elements of a leaf updated at once (f32 temporaries ~2.4 GB)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    moment_dtype: str = "float32"  # "bfloat16" halves optimizer memory
    aggressive: bool = False  # also compress v (second moment)


def schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), as an f32 tensor."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(cfg: OptimizerConfig, params: dict) -> dict:
    """Zero moments for ``params`` (name -> tensor), on their devices."""
    mdt = dtype_of(cfg.moment_dtype)
    vdt = mdt if cfg.aggressive else torch.float32
    device = next(iter(params.values())).device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": {n: torch.zeros(p.shape, dtype=mdt, device=p.device) for n, p in params.items()},
        "v": {n: torch.zeros(p.shape, dtype=vdt, device=p.device) for n, p in params.items()},
    }


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


def _decay_mask(name: str) -> bool:
    """Weight decay on matrices only (no norms / biases / scalar mixes),
    keyed on the parameter's last name as in the reference."""
    last = name.rsplit(".", 1)[-1]
    return last not in ("scale", "bias", "dt_bias", "conv_b") and not last.startswith(
        ("mu_", "b", "w0", "u", "D", "A_log")
    )


@torch.no_grad()
def update(cfg: OptimizerConfig, grads: dict, state: dict, params: dict):
    """One AdamW step on ``params`` (name -> tensor) with ``grads`` (name ->
    tensor), in place.  Returns (state, {"grad_norm", "lr"})."""
    step = state["step"] + 1
    lr = schedule(cfg, step)

    gnorm = global_norm(grads[n] for n in params)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)

    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=stepf.device), stepf)

    for name, p in params.items():
        decay = cfg.weight_decay and _decay_mask(name)
        flat = (p.view(-1), state["m"][name].view(-1), state["v"][name].view(-1),
                grads[name].reshape(-1))
        for w, m, v, g in zip(*(t.split(UPDATE_CHUNK) for t in flat)):
            g = g.float() * scale
            m32 = b1 * m.float() + (1 - b1) * g
            v32 = b2 * v.float() + (1 - b2) * g * g
            mhat = m32 / bc1
            vhat = v32 / bc2
            delta = mhat / (torch.sqrt(vhat) + cfg.eps)
            if decay:
                delta = delta + cfg.weight_decay * w.float()
            w.copy_(w.float() - lr * delta)
            m.copy_(m32)
            v.copy_(v32)
    state["step"] = step
    return state, {"grad_norm": gnorm, "lr": lr}
