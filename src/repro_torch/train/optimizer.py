"""AdamW with configurable moment dtypes, global-norm clipping and a
warmup+cosine schedule (port of ``repro/train/optimizer.py``).

The state is ``{"step": 0-d int32 tensor, "m": {name: tensor}, "v": {name:
tensor}}``, keyed by the model's parameter names.  ``update`` changes the
parameters and the state in place under ``torch.no_grad()``; it computes in
f32 as the reference does, with the schedule and the bias corrections as
f32 tensors (Python floats would round them otherwise).

``moment_dtype="bfloat16"`` keeps m in bf16 (v too with ``aggressive``),
rounded from f32 on every update.

The update takes the leaves' flat slices ``UPDATE_CHUNK`` elements at a
time.  Its f32 temporaries (the gradient, both moments, their corrections,
the step and the weight widened: about seven times a group's elements at
once) would otherwise reach 34 GB on jamba's (16, 4,096, 14,336) expert
stack and 38 GB on llama-vision's 1.05 B-entry embedding, more than the
card holds beside the weights and moments.  A leaf larger than that is cut
into slices; slices smaller than that are packed into groups of at most
``UPDATE_CHUNK`` elements, each group's slices sharing a decay and a
parameter dtype, and each elementwise op of the update is one ``_foreach``
call over the group.  On a model of many small leaves (qwen3-0.6B's 310)
that takes the host's launches from about 25 a leaf to 2 (the casts of the
gradient and the weight), so the card no longer waits on them.  A slice of
``FOREACH_MIN_ALONE`` elements or more is updated alone by plain ops: its
device time (about 180 bytes an element, 0.25 ms at 4 M) outweighs its
launches, and a ``_foreach`` kernel, at most a few hundred blocks a
launch, moves those bytes slower than the plain elementwise kernels (a
model of large leaves, qwen2-moe's expert stacks, would lose on them what
the launches save).  Every op is elementwise and in the same order on
every slice, so the numbers are the same however the leaves are cut,
grouped and routed.

On DTensor parameters (``train_step.jit_train_step``) the state mirrors
their placements (``state_specs``; the step stays a plain 0-d tensor,
the same on every rank).  ``update`` brings each gradient to its
parameter's placements, takes the global norm as one full reduction, and
runs the elementwise AdamW on each leaf's local shard, still in
``UPDATE_CHUNK`` slices (``view(-1)`` of a sharded DTensor is no flat
view of its shard).  The update is fully local: no optimizer collectives.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import obs
from repro_torch.distributed.context import is_dtensor
from repro_torch.distributed.sharding import P
from repro_torch.models.layers import dtype_of

UPDATE_CHUNK = 1 << 26  # elements of a leaf updated at once (f32 temporaries ~2.4 GB)
FOREACH_MIN_ALONE = 1 << 22  # a slice this large is updated alone, by plain ops


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
        "m": {n: _zeros_like(p, mdt) for n, p in params.items()},
        "v": {n: _zeros_like(p, vdt) for n, p in params.items()},
    }


def _zeros_like(p: torch.Tensor, dtype) -> torch.Tensor:
    """Zeros of p's shape: on p's device, or a DTensor placed as p is."""
    if is_dtensor(p):
        return torch.zeros_like(p.detach(), dtype=dtype)
    return torch.zeros(p.shape, dtype=dtype, device=p.device)


def state_specs(params_specs: dict) -> dict:
    """Optimizer-state specs mirror the parameter specs; the step is
    replicated."""
    return {"step": P(), "m": params_specs, "v": params_specs}


def _partial(t):
    """A DTensor scalar as a ``Partial`` sum over every mesh dim: along a
    dim where it is replicated, the rank at coordinate 0 keeps the value and
    the others hold zero, so the sum is exact.  A plain tensor as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Partial, Replicate

    local = t.to_local()
    coord = t.device_mesh.get_coordinate()
    if any(isinstance(pl, Replicate) and c != 0 for pl, c in zip(t.placements, coord)):
        local = torch.zeros_like(local)
    return DTensor.from_local(local, t.device_mesh, (Partial(),) * t.device_mesh.ndim,
                              run_check=False)


def _local(t):
    return t.to_local() if is_dtensor(t) else t


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in f32.  On DTensors the
    per-leaf sums are made partial sums and reduced once; the result is a
    plain tensor, the same on every rank."""
    total = sum(_partial(torch.sum(torch.square(t.float()))) for t in tensors)
    if is_dtensor(total):
        total = total.full_tensor()
    return torch.sqrt(total)


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
    with obs.span("optimizer.update", device=state["step"].device):
        step = state["step"] + 1
        lr = schedule(cfg, step)

        grads = {n: _placed_as(grads[n], p) for n, p in params.items()}
        gnorm = global_norm(grads[n] for n in params)
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)

        stepf = step.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(cfg.beta1, dtype=torch.float32, device=stepf.device), stepf)
        bc2 = 1 - torch.pow(torch.tensor(cfg.beta2, dtype=torch.float32, device=stepf.device), stepf)

        groups: dict = {}  # (decay, dtype) -> [slices, elements]
        for name, p in params.items():
            key = (bool(cfg.weight_decay and _decay_mask(name)), p.dtype)
            flat = (_local(p).view(-1), _local(state["m"][name]).view(-1),
                    _local(state["v"][name]).view(-1), _local(grads[name]).reshape(-1))
            for sl in zip(*(t.split(UPDATE_CHUNK) for t in flat)):
                if sl[0].numel() >= FOREACH_MIN_ALONE:
                    _adamw_alone(cfg, *sl, key[0], scale, lr, bc1, bc2)
                    continue
                group = groups.setdefault(key, [[], 0])
                if group[0] and group[1] + sl[0].numel() > UPDATE_CHUNK:
                    _adamw(cfg, group[0], key[0], scale, lr, bc1, bc2)
                    group[:] = [[], 0]
                group[0].append(sl)
                group[1] += sl[0].numel()
        for (decay, _), (slices, _) in groups.items():
            _adamw(cfg, slices, decay, scale, lr, bc1, bc2)
        state["step"] = step
        return state, {"grad_norm": gnorm, "lr": lr}


def _adamw(cfg: OptimizerConfig, slices: list, decay: bool, scale, lr, bc1, bc2):
    """AdamW on ``slices``, flat ``(w, m, v, g)`` views of one dtype each,
    in place: per element, in f32, ``g = g * scale``, ``m = b1 m + (1 - b1)
    g``, ``v = b2 v + (1 - b2) g g``, ``w = w - lr (m / bc1 / (sqrt(v /
    bc2) + eps) [+ wd w])``, each op one ``_foreach`` call over the slices."""
    ws, ms, vs, gs = zip(*slices)
    b1, b2 = cfg.beta1, cfg.beta2
    g = torch._foreach_mul([x.float() for x in gs], scale)
    m32 = torch._foreach_mul([x.float() for x in ms], b1)
    t = torch._foreach_mul(g, 1 - b1)
    torch._foreach_add_(m32, t)
    v32 = torch._foreach_mul([x.float() for x in vs], b2)
    t = torch._foreach_mul(g, 1 - b2)
    torch._foreach_mul_(t, g)
    torch._foreach_add_(v32, t)
    del g, t
    delta = torch._foreach_div(m32, bc1)
    denom = torch._foreach_div(v32, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, cfg.eps)
    torch._foreach_div_(delta, denom)
    del denom
    w32 = [x.float() for x in ws]
    if decay:
        torch._foreach_add_(delta, torch._foreach_mul(w32, cfg.weight_decay))
    torch._foreach_mul_(delta, lr)
    torch._foreach_sub_(w32, delta)
    del delta
    torch._foreach_copy_(ws, w32)
    torch._foreach_copy_(ms, m32)
    torch._foreach_copy_(vs, v32)


def _adamw_alone(cfg: OptimizerConfig, w, m, v, g, decay: bool, scale, lr, bc1, bc2):
    """``_adamw`` on one large flat slice, by plain ops in the same order."""
    b1, b2 = cfg.beta1, cfg.beta2
    g = g.float() * scale
    m32 = b1 * m.float() + (1 - b1) * g
    v32 = b2 * v.float() + (1 - b2) * g * g
    delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
    w32 = w.float()
    if decay:
        delta = delta + cfg.weight_decay * w32
    w.copy_(w32 - lr * delta)
    m.copy_(m32)
    v.copy_(v32)


def _placed_as(g, p):
    """The gradient ``g`` with the placements of its parameter ``p``."""
    if not is_dtensor(p) or tuple(g.placements) == tuple(p.placements):
        return g
    return g.redistribute(p.device_mesh, p.placements)
