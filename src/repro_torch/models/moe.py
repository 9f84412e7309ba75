"""Mixture-of-experts FFN (port of ``repro/models/moe.py``).

GShard/Switch routing, as in the reference: the tokens are split into
groups of ``_group_size(t)``; in each group every token picks its top-k
experts by an f32 router softmax, the k gates are renormalised (unless the
config's ``norm_topk_prob`` is off, as Jamba publishes it; the reference
always renormalises), and each expert takes at most ``_capacity(...)``
(token, slot) pairs, in slot-major order (every token's first choice
before any token's second); the rest are dropped.  The expert products are
the reference's einsums as ``torch.bmm`` over the expert axis, over the
slot rows in blocks where the hidden would pass ``layers.HIDDEN_BUDGET``.

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
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import obs
from repro_torch.distributed.context import (
    contiguous_grad,
    get_policy,
    is_dtensor,
    mesh_placements,
    row_axes,
)
from repro_torch.models.layers import MLP, dense_init_, in_row_blocks, weight

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
    gate: torch.Tensor  # (G, T, k) f32 gates (renormalised over the k by default)
    pos: torch.Tensor  # (G, T, k) int64 place in the expert's queue
    keep: torch.Tensor  # (G, T, k) bool: pos < capacity


def route(router: torch.Tensor, xg: torch.Tensor, k: int, cap: int,
          renormalise: bool = True) -> Routing:
    """Top-k routing of grouped tokens ``xg`` (G, T, D) with slot-major
    queue priority: a (token, slot) pair's place in its expert's queue is
    the number of pairs of earlier slots, and of earlier tokens in its
    slot, that chose the same expert.  The gates are the top-k
    probabilities, renormalised to sum to one if ``renormalise``."""
    g, t, _ = xg.shape
    e = router.shape[1]
    logits = xg.float() @ router
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)
    if renormalise:
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    slot_major = idx.transpose(1, 2).reshape(g, k * t)  # (G, k*T): slot 0's tokens first
    chosen = F.one_hot(slot_major, e)  # (G, k*T, E)
    before = torch.cumsum(chosen, dim=1) - chosen
    pos = before.gather(-1, slot_major[..., None])[..., 0]
    pos = pos.reshape(g, k, t).transpose(1, 2)
    return Routing(logits, probs, idx, gate, pos, pos < cap)


def _routed(router: torch.Tensor, wg: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
            cfg, x: torch.Tensor, cap_factor: float, e_lo: int = 0):
    """The routed experts of ``moe`` on plain tensors: x (B, S, D) ->
    (out (B, S, D), lb_loss, z_loss).  Routing is over all the router's
    experts; ``wg wi wo`` hold experts ``e_lo .. e_lo + len(wg)`` and only
    (token, slot) pairs routed to those are dispatched and combined, so
    with every expert (``e_lo`` 0) this is the whole MoE's output, and over
    a split of the experts the parts sum to it."""
    b, s, d = x.shape
    t = b * s
    e, k = router.shape[1], cfg.top_k
    e_local = wg.shape[0]
    group = _group_size(t)
    n_groups = t // group
    cap = _capacity(group, k, e, cap_factor)
    xf = x.reshape(t, d)
    with obs.span("moe.route"):
        r = route(router, xf.reshape(n_groups, group, d), k, cap, cfg.norm_topk_prob)

    with obs.span("moe.dispatch"):
        # local expert e's slot (g, c) is row (e * G + g) * C + c of the expert batch
        mine = r.keep if e_local == e else r.keep & (r.idx >= e_lo) & (r.idx < e_lo + e_local)
        grp = torch.arange(n_groups, device=x.device)[:, None, None]
        slot = ((r.idx - e_lo) * n_groups + grp) * cap + r.pos
        token = torch.arange(t, device=x.device).reshape(n_groups, group, 1).expand_as(slot)
        n_slots = e_local * n_groups * cap
        # a dropped pair writes past the end; an empty slot reads the zero row t
        table = torch.full((n_slots + 1,), t, dtype=torch.long, device=x.device)
        table.scatter_(0, torch.where(mine, slot, n_slots).flatten(), token.flatten())
        xe = torch.cat([xf, xf.new_zeros(1, d)])[table[:n_slots]].reshape(
            e_local, n_groups * cap, d)
    if obs.recording():  # every pair, the slots computed, the pairs kept in them
        obs.count("moe.pairs", t * k)
        obs.count("moe.slots", n_slots)
        obs.count("moe.kept", mine.sum())
    with obs.span("moe.experts"):
        ye = experts(xe, wg, wi, wo).reshape(n_slots, d)
    with obs.span("moe.combine"):
        # combine in the compute dtype, as the reference's combine tensor is
        gate_kept = (r.gate * mine).to(x.dtype)
        rows = ye[torch.where(mine, slot, 0)]  # (G, T, k, D)
        out = torch.einsum("gtk,gtkd->gtd", gate_kept, rows).reshape(b, s, d)

    # aux losses (Switch): load balance = E * mean(frac_tokens * frac_probs)
    frac_tokens = F.one_hot(r.idx, e).sum(2).float().mean(1)  # (G, E)
    frac_probs = r.probs.mean(1)
    lb_loss = e * torch.mean(torch.sum(frac_tokens * frac_probs, dim=-1))
    z_loss = torch.mean(torch.square(torch.logsumexp(r.logits, dim=-1)))
    return out, lb_loss, z_loss


def _swiglu(xe: torch.Tensor, wg: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor):
    g_act = torch.bmm(xe, wg)
    h_act = torch.bmm(xe, wi)
    act = F.silu(g_act.float()).to(xe.dtype) * h_act
    return torch.bmm(act, wo)


def experts(xe: torch.Tensor, wg: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor):
    """Each expert's SwiGLU over its slot rows: xe (E, n, D) -> (E, n, D),
    silu in f32; in blocks of slot rows where the (E, n, eff) hidden would
    pass ``layers.HIDDEN_BUDGET`` bytes."""
    return in_row_blocks(lambda t: _swiglu(t, wg, wi, wo), xe, 1, wg.shape[-1])


def _routed_sharded(p: MoE, cfg, x, cap_factor: float, pol):
    """``_routed`` on DTensors under a policy, through ``local_map``.

    Tokens stay sharded over the batch axes (the ``btd`` layout) where
    every rank's rows hold whole routing groups, and are replicated over
    "model".  Each model rank routes its tokens over all experts, as the
    unsharded MoE does, and dispatches only to its own experts (the expert
    dim of ``wg wi wo`` over "model", their d_model dim gathered
    FSDP-style), so the output is a ``Partial`` sum over "model" and no
    all-to-all is needed.  Routing is equal index for index.  Where the
    expert count does not divide "model" (qwen2-moe's 60 on 16), or the
    groups would straddle ranks, that axis falls back to replication.  The
    aux losses are means over groups: each rank's share is its local mean
    over the ranks that hold other tokens or other experts, summed."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    b, s, _ = x.shape
    e = cfg.n_experts
    m_size = pol.axis_size(pol.model)
    ep = m_size > 1 and e % m_size == 0
    # rows over the batch axes where every rank keeps whole routing groups
    tok = row_axes(pol, mesh, b, tokens_per_row=s, group=_group_size(b * s))
    split = math.prod(pol.axis_size(ax) for ax in tok) * (m_size if ep else 1)

    def pl(tok_pl, model_pl):
        return mesh_placements(mesh, {pol.model: model_pl, **{ax: tok_pl for ax in tok}})

    x_in = pl(Shard(0), Replicate())
    w_in = pl(Replicate(), Shard(0) if ep else Replicate())
    rep = pl(Replicate(), Replicate())
    part_model = Partial() if ep else Replicate()
    e_lo = mesh.get_local_rank(pol.model) * (e // m_size) if ep else 0

    def body(*args):
        if mesh.size() > 1:
            args = [contiguous_grad(t) for t in args]
        x_, router, wg, wi, wo = args
        out, lb, z = _routed(router, wg, wi, wo, cfg, x_, cap_factor, e_lo)
        if split > 1:
            lb, z = lb / split, z / split
        return out, lb, z

    w_grad = pl(Partial(), Shard(0) if ep else Replicate())
    fn = local_map(
        body,
        out_placements=(pl(Shard(0), part_model), pl(Partial(), part_model),
                        pl(Partial(), part_model)),
        in_placements=(x_in, rep, w_in, w_in, w_in),
        in_grad_placements=(pl(Shard(0), part_model), pl(Partial(), part_model),
                            w_grad, w_grad, w_grad),
        device_mesh=mesh,
        redistribute_inputs=True,
    )
    return fn(x, p.router, p.wg, p.wi, p.wo)


def moe(p: MoE, cfg, x: torch.Tensor, capacity_factor: float | None = None):
    """x: (B, S, D) -> (out (B, S, D), {"moe_lb_loss", "moe_z_loss"}).

    ``capacity_factor`` overrides the config's (serving decodes with a
    larger one: a dropped token is a quality bug there).  Under an
    activation policy, on DTensors, the routed experts run sharded
    (``_routed_sharded``)."""
    cap_factor = capacity_factor or cfg.moe_capacity_factor
    pol = get_policy()
    if pol is not None and is_dtensor(x):
        out, lb_loss, z_loss = _routed_sharded(p, cfg, x, cap_factor, pol)
    else:
        out, lb_loss, z_loss = _routed(p.router, p.wg, p.wi, p.wo, cfg, x, cap_factor)
    if p.shared is not None:
        out = out + p.shared(x)
    if p.dense is not None:
        out = out + p.dense(x)
    return out, {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss}
