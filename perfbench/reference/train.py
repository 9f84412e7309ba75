"""Three AdamW steps of the plain model: what the check compares the
port's first three train steps with.

The weights start from the benchmark's tensors (held in float32, with
the values of their stored dtype) and, after each update, are rounded to
the dtype the configuration stores them in, as the configuration trains
with no float32 master copy.  Each layer runs under activation
checkpointing and the loss a block of rows at a time, so a full-width
step fits beside the float32 optimizer state.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from .model import RefLM, contiguous_groups, drop_share

LB_WEIGHT = 0.01
Z_WEIGHT = 1e-3
LOSS_ROWS = 2048


def schedule(hp: dict, step: int) -> float:
    """Linear warm-up, then a cosine from ``lr`` to ``min_lr_frac x lr``."""
    warm = step / max(hp["warmup_steps"], 1)
    prog = (step - hp["warmup_steps"]) / max(hp["total_steps"] - hp["warmup_steps"], 1)
    prog = min(max(prog, 0.0), 1.0)
    cos = hp["min_lr_frac"] + (1 - hp["min_lr_frac"]) * 0.5 * (1 + math.cos(math.pi * prog))
    return hp["lr"] * (warm if step < hp["warmup_steps"] else cos)


def _nll_sum(lm: RefLM, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = lm.logits(x)
    return (torch.logsumexp(logits, -1) - logits.gather(-1, labels[:, None])[:, 0]).sum()


def loss(lm: RefLM, tokens: torch.Tensor, labels: torch.Tensor, capacity_factor: float):
    """Mean next-token cross-entropy, plus the weighted MoE aux losses
    averaged over the MoE layers."""
    b, s = tokens.shape
    x = lm.embed(tokens)
    groups = contiguous_groups(b * s, capacity_factor, tokens.device)
    lb = z = x.new_zeros(())
    n_moe = 0
    for i in range(lm.a["n_layers"]):
        x, lb_i, z_i = checkpoint(lm.block, i, x, groups, use_reentrant=False)
        lb, z = lb + lb_i, z + z_i
        n_moe += lm.is_moe(i)
    flat, lab = x.reshape(b * s, -1), labels.reshape(-1).long()
    total = x.new_zeros(())
    for i in range(0, b * s, LOSS_ROWS):
        total = total + checkpoint(_nll_sum, lm, flat[i:i + LOSS_ROWS], lab[i:i + LOSS_ROWS],
                                   use_reentrant=False)
    out = total / (b * s)
    if n_moe:
        out = out + LB_WEIGHT * lb / n_moe + Z_WEIGHT * z / n_moe
    return out


@torch.no_grad()
def adamw(params: dict, grads: dict, state: dict, step: int, hp: dict, stored: dict) -> None:
    """One AdamW step in float32 with global-norm clipping, weight decay on
    matrices only; each new weight is rounded to its stored dtype."""
    lr = schedule(hp, step)
    gnorm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    scale = torch.clamp(hp["clip_norm"] / torch.clamp(gnorm, min=1e-9), max=1.0)
    b1, b2 = hp["beta1"], hp["beta2"]
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    for n, w in params.items():
        g = grads[n] * scale
        m = state["m"][n].mul_(b1).add_((1 - b1) * g)
        v = state["v"][n].mul_(b2).add_((1 - b2) * g * g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + hp["eps"])
        if w.dim() >= 2:
            delta = delta + hp["weight_decay"] * w
        w.copy_((w - lr * delta).to(stored[n]).float())


def run(arch: dict, weights: dict, batches: list, hp: dict, precision: str = "f32") -> dict:
    """Train from ``weights`` ({name: tensor}) on ``batches`` ([(tokens,
    labels)], one a step).  Returns each step's loss, each leaf's norm of
    the first clipped gradient and of its change over all the steps, and
    the MoE's share of dropped pairs; ``weights`` are left untouched."""
    stored = {n: t.dtype for n, t in weights.items()}
    params = {n: t.detach().float().clone().requires_grad_(True) for n, t in weights.items()}
    start = {n: t for n, t in weights.items()}
    lm = RefLM(arch, params, precision)
    state = {"m": {n: torch.zeros_like(p) for n, p in params.items()},
             "v": {n: torch.zeros_like(p) for n, p in params.items()}}
    losses, grad_norms = [], {}
    cf = arch.get("moe_capacity_factor", 1.25)
    for step, (tokens, labels) in enumerate(batches, start=1):
        value = loss(lm, tokens, labels, cf)
        grads = dict(zip(params, torch.autograd.grad(value, list(params.values()))))
        losses.append(float(value.detach()))
        if step == 1:
            gnorm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
            scale = min(hp["clip_norm"] / max(float(gnorm), 1e-9), 1.0)
            grad_norms = {n: float(g.norm()) * scale for n, g in grads.items()}
        adamw(params, grads, state, step, hp, stored)
        del grads, value
    change = {n: float((params[n].detach() - start[n].float()).norm()) for n in params}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change,
            "drop_share": drop_share(lm.pairs)}

