"""Mixture-of-experts FFN (port of ``repro/models/moe.py``).

GShard/Switch routing, as in the reference: the tokens are split into
groups of ``_group_size(t)``; in each group every token picks its top-k
experts by an f32 router softmax, the k gates are renormalised, and each
expert takes at most ``_capacity(...)`` (token, slot) pairs, in slot-major
order (every token's first choice before any token's second); the rest are
dropped.  The expert products are the reference's einsums as
``torch.bmm`` over the expert axis.

Dispatch and combine differ in form, not in result.  The reference
multiplies by one-hot (group, token, expert, capacity) tensors; the port
moves the same rows with index ops: each expert's capacity slots gather
their token (or a zero row), and each token gathers its kept slots' outputs
back, weighted by its gates in the compute dtype.  Routing (``route``:
expert indices, queue positions, the kept mask) equals the reference's;
the output is allclose (sums in another order).

Three variants: qwen2-moe (60 routed top-4 + a fused shared MLP of 4
experts' width), arctic (128 routed top-2 + a dense residual MLP) and
jamba (16 routed top-2 on alternate layers).  The load-balance and router
z aux losses are returned for the train loss.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import MLP, dense_init_, weight

# tokens per routing group at most (the reference's §Perf choice)
GROUP_TARGET = 512


def _group_size(t: int, target: int = GROUP_TARGET) -> int:
    g = min(t, target)
    while t % g:
        g -= 1
    return g


def _capacity(group: int, k: int, e: int, factor: float) -> int:
    c = int(group * k * factor / e) + 1
    return max(4, -(-c // 4) * 4) if group >= 4 else max(1, c)


class MoE(nn.Module):
    """``router`` (d, E), always f32; ``wg wi`` (E, d, eff), ``wo`` (E, eff,
    d); ``shared`` (an MLP of ``n_shared_experts * eff``) and ``dense`` (an
    MLP of ``d_ff``) where the config has them."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, e = cfg.d_model, cfg.n_experts
        eff = cfg.expert_d_ff or cfg.d_ff
        self.router = weight(d, e, dtype=torch.float32, device=device)
        self.wg = weight(e, d, eff, dtype=dtype, device=device)
        self.wi = weight(e, d, eff, dtype=dtype, device=device)
        self.wo = weight(e, eff, d, dtype=dtype, device=device)
        self.shared = (MLP(d, cfg.n_shared_experts * eff, dtype, device)
                       if cfg.n_shared_experts else None)
        self.dense = MLP(d, cfg.d_ff, dtype, device) if cfg.dense_residual else None

    def init(self, generator: torch.Generator) -> None:
        dense_init_(self.router, generator)
        for w in (self.wg, self.wi, self.wo):
            for expert in w:  # one expert at a time: no f32 copy of the stack
                dense_init_(expert, generator)
        for m in (self.shared, self.dense):
            if m is not None:
                m.init(generator)


@dataclasses.dataclass
class Routing:
    """One routing of (G, T) grouped tokens over E experts, k slots each."""

    logits: torch.Tensor  # (G, T, E) f32
    probs: torch.Tensor  # (G, T, E) f32 softmax
    idx: torch.Tensor  # (G, T, k) int64 expert of each slot
    gate: torch.Tensor  # (G, T, k) f32 gates, renormalised over the k
    pos: torch.Tensor  # (G, T, k) int64 place in the expert's queue
    keep: torch.Tensor  # (G, T, k) bool: pos < capacity


def route(router: torch.Tensor, xg: torch.Tensor, k: int, cap: int) -> Routing:
    """Top-k routing of grouped tokens ``xg`` (G, T, D) with slot-major
    queue priority: a (token, slot) pair's place in its expert's queue is
    the number of pairs of earlier slots, and of earlier tokens in its
    slot, that chose the same expert."""
    g, t, _ = xg.shape
    e = router.shape[1]
    logits = xg.float() @ router
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    slot_major = idx.transpose(1, 2).reshape(g, k * t)  # (G, k*T): slot 0's tokens first
    chosen = F.one_hot(slot_major, e)  # (G, k*T, E)
    before = torch.cumsum(chosen, dim=1) - chosen
    pos = before.gather(-1, slot_major[..., None])[..., 0]
    pos = pos.reshape(g, k, t).transpose(1, 2)
    return Routing(logits, probs, idx, gate, pos, pos < cap)


def moe(p: MoE, cfg, x: torch.Tensor, capacity_factor: float | None = None):
    """x: (B, S, D) -> (out (B, S, D), {"moe_lb_loss", "moe_z_loss"}).

    ``capacity_factor`` overrides the config's (serving decodes with a
    larger one: a dropped token is a quality bug there)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    group = _group_size(t)
    n_groups = t // group
    cap = _capacity(group, k, e, capacity_factor or cfg.moe_capacity_factor)
    xf = x.reshape(t, d)
    r = route(p.router, xf.reshape(n_groups, group, d), k, cap)

    # expert e's slot (g, c) is row (e * G + g) * C + c of the expert batch
    grp = torch.arange(n_groups, device=x.device)[:, None, None]
    slot = (r.idx * n_groups + grp) * cap + r.pos
    token = torch.arange(t, device=x.device).reshape(n_groups, group, 1).expand_as(slot)
    n_slots = e * n_groups * cap
    # a dropped pair writes past the end; an empty slot reads the zero row t
    table = torch.full((n_slots + 1,), t, dtype=torch.long, device=x.device)
    table.scatter_(0, torch.where(r.keep, slot, n_slots).flatten(), token.flatten())
    xe = torch.cat([xf, xf.new_zeros(1, d)])[table[:n_slots]].reshape(e, n_groups * cap, d)
    g_act = torch.bmm(xe, p.wg)
    h_act = torch.bmm(xe, p.wi)
    act = F.silu(g_act.float()).to(x.dtype) * h_act
    ye = torch.bmm(act, p.wo).reshape(n_slots, d)
    # combine in the compute dtype, as the reference's combine tensor is
    gate_kept = (r.gate * r.keep).to(x.dtype)
    rows = ye[torch.where(r.keep, slot, 0)]  # (G, T, k, D)
    out = torch.einsum("gtk,gtkd->gtd", gate_kept, rows).reshape(b, s, d)

    if p.shared is not None:
        out = out + p.shared(x)
    if p.dense is not None:
        out = out + p.dense(x)

    # aux losses (Switch): load balance = E * mean(frac_tokens * frac_probs)
    frac_tokens = F.one_hot(r.idx, e).sum(2).float().mean(1)  # (G, E)
    frac_probs = r.probs.mean(1)
    lb_loss = e * torch.mean(torch.sum(frac_tokens * frac_probs, dim=-1))
    z_loss = torch.mean(torch.square(torch.logsumexp(r.logits, dim=-1)))
    return out, {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss}
