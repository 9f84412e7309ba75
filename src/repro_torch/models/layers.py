"""Shared layers of the LM zoo (port of ``repro/models/layers.py``).

Plain functions on tensors.  Compute runs in the config dtype (bf16 on the
card) with f32 where the reference takes it (norms, RoPE, the SwiGLU
activation).  Weights keep the reference's ``(in, out)`` layout and are
applied as ``x @ w``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch import obs
from repro_torch.distributed.context import (
    contiguous_grad,
    gather_fsdp,
    is_dtensor,
    local_range,
    mesh_placements,
    shard_axes,
)


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# initialisers: the reference's distributions, drawn from a torch.Generator
# (the numbers differ from jax.random's for the same seed)
# ---------------------------------------------------------------------------


def dense_init_(w: torch.Tensor, generator: torch.Generator,
                std: float | None = None) -> torch.Tensor:
    """Truncated normal on [-3, 3] times ``std`` (default ``1/sqrt(fan_in)``,
    fan_in = ``shape[-2]``); drawn in f32 on the generator's device, then
    copied."""
    if std is None:
        std = w.shape[-2] ** -0.5
    t = torch.empty(w.shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, a=-3.0, b=3.0, generator=generator)
    with torch.no_grad():
        return w.copy_(t.mul_(std))


def embed_init_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Normal times 0.01."""
    t = torch.randn(w.shape, dtype=torch.float32, device=generator.device,
                    generator=generator)
    with torch.no_grad():
        return w.copy_(t * 0.01)


# ---------------------------------------------------------------------------
# normalisation, rotary position embedding, MLP, embeddings
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale, eps)
    return _rmsnorm(x, scale, eps)[0]


def _rmsnorm(x, scale, eps):
    """``rmsnorm``'s ops: (out, the f32 reciprocal RMS (..., 1))."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return (xf * rstd * scale.float()).to(x.dtype), rstd


class _RMSNorm(torch.autograd.Function):
    """``rmsnorm`` for training: the same forward ops, saving x and the f32
    reciprocal RMS where autograd would keep two f32 copies of x; the
    backward recomputes the normalised rows:
    dx = r (dn - n mean(dn n)), n = x r, dn = dy scale."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        out, rstd = _rmsnorm(x, scale, eps)
        ctx.save_for_backward(x, scale, rstd)
        return out

    @staticmethod
    def backward(ctx, d_out):
        x, scale, rstd = ctx.saved_tensors
        normed = x.float() * rstd
        g = d_out.float()
        d_scale = (g * normed).sum(dim=tuple(range(g.dim() - 1)))
        dn = g * scale.float()
        dx = rstd * (dn - normed * (dn * normed).mean(dim=-1, keepdim=True))
        return dx.to(x.dtype), d_scale.to(scale.dtype), None


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Mean and variance in f32 (no config of the zoo uses it: the zoo
    normalises with RMS norms throughout)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    normed = (xf - mu) * torch.rsqrt(var + eps)
    return (normed * scale.float() + bias.float()).to(x.dtype)


def weight(*shape: int, dtype, device, fill: float = 0.0) -> nn.Parameter:
    """A trainable parameter filled with ``fill``.  Serving runs under
    ``torch.no_grad()``, so it builds no graph through it."""
    return nn.Parameter(torch.full(shape, fill, dtype=dtype, device=device))


class RMSNorm(nn.Module):
    """Holds the ``scale`` of one RMS norm (``{"scale": (d,)}`` in the
    reference)."""

    def __init__(self, d: int, dtype, device):
        super().__init__()
        self.scale = weight(d, dtype=dtype, device=device, fill=1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.scale)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions broadcastable to (..., seq).
    Split halves, not interleaved; f32 inside."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, device=x.device)  # (hd/2,)
    angles = positions[..., :, None].float() * freqs  # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]  # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp(x: torch.Tensor, wg: torch.Tensor, wi: torch.Tensor,
        wo: torch.Tensor) -> torch.Tensor:
    """SwiGLU: silu in f32, cast back to x's dtype."""
    with obs.span("mlp"):
        g = x @ gather_fsdp(wg)
        h = x @ gather_fsdp(wi)
        act = torch.nn.functional.silu(g.float()).to(x.dtype) * h
        return act @ gather_fsdp(wo)


class MLP(nn.Module):
    """SwiGLU weights ``wg wi`` (d, d_ff) and ``wo`` (d_ff, d)."""

    def __init__(self, d: int, d_ff: int, dtype, device):
        super().__init__()
        self.wg = weight(d, d_ff, dtype=dtype, device=device)
        self.wi = weight(d, d_ff, dtype=dtype, device=device)
        self.wo = weight(d_ff, d, dtype=dtype, device=device)

    def init(self, generator: torch.Generator) -> None:
        for w in (self.wg, self.wi, self.wo):
            dense_init_(w, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp(x, self.wg, self.wi, self.wo)


def embed(tok: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the embedding table ``tok`` (V, D) for ``tokens``; a DTensor
    table takes ``_embed_sharded``."""
    if is_dtensor(tok):
        return _embed_sharded(tok, tokens)
    return tok[tokens.long()]


def _embed_sharded(tok, tokens):
    """The vocab-parallel embedding, through ``local_map``: each rank looks
    up the tokens of its batch rows that fall in its vocab shard, zero rows
    for the rest, and the ranks of the vocab axis sum (a ``Partial``, which
    the caller's ``btd`` constraint reduces).  The gradient stays local: a
    scatter-add into the rank's own shard of the table, as the reference's
    vocab-sharded table has it."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.sharding import place

    mesh = tok.device_mesh
    vocab = shard_axes(tok, 0)
    rows = [ax for ax in (shard_axes(tokens, 0) if is_dtensor(tokens) else ())
            if ax not in vocab]
    tok_pl = mesh_placements(mesh, {ax: Shard(0) for ax in vocab})
    ids_pl = mesh_placements(mesh, {ax: Shard(0) for ax in rows})
    out_pl = mesh_placements(mesh, {**{ax: Shard(0) for ax in rows},
                                    **{ax: Partial() for ax in vocab}})
    grad_pl = mesh_placements(mesh, {**{ax: Partial() for ax in rows},
                                     **{ax: Shard(0) for ax in vocab}})
    if not is_dtensor(tokens):
        tokens = place(tokens, mesh, ids_pl)
    v_size = tok.shape[0]

    def lookup(tok_, ids):
        ids = ids.long()
        if not vocab:
            return tok_[ids]
        lo, n = local_range(v_size, mesh, tok_pl, 0)
        mine = (ids >= lo) & (ids < lo + n)
        return tok_[torch.where(mine, ids - lo, 0)] * mine[..., None].to(tok_.dtype)

    return local_map(lookup, out_placements=(out_pl,), in_placements=(tok_pl, ids_pl),
                     in_grad_placements=(grad_pl, ids_pl), device_mesh=mesh,
                     redistribute_inputs=True)(tok, tokens)


def unembed(x: torch.Tensor, tok: torch.Tensor,
            head: torch.Tensor | None = None) -> torch.Tensor:
    """Logits in the compute dtype: ``x @ head`` when untied, ``x @ tokᵀ``
    when tied."""
    if head is not None:
        return x @ head
    return x @ tok.t()


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token negative log-likelihood in f32: logsumexp of the upcast
    logits less the gold logit (a gather, no one-hot)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return lse - gold


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross-entropy in f32: logsumexp of the upcast logits less
    the gold logit.  With ``mask``, the masked mean, divided by
    ``max(sum(mask), 1)``.  DTensor logits take ``_softmax_xent_sharded``."""
    if is_dtensor(logits):
        return _softmax_xent_sharded(logits, labels, mask)
    nll = _nll(logits, labels)
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def _softmax_xent_sharded(logits, labels, mask):
    """``softmax_xent`` of DTensor logits, through ``local_map``: each rank
    takes its batch rows and returns its share of the sums as a ``Partial``
    over the batch-sharded mesh dims, so the gradient stays sharded as the
    rows are (left to DTensor, the mean's backward would make it
    whole-batch on every rank).  Logits sharded over the vocab on one mesh
    dim stay so: ``_VocabParallelNLL`` reduces the max, the sum of exps and
    the gold logit across that dim, as the reference's vocab-sharded logits
    have it (a rank's 16 sequences of 4,096 tokens over qwen3's 152,064
    entries are 37 GB of f32).  Otherwise the rows are taken with the whole
    vocab; on one rank that is ``softmax_xent`` itself, op for op."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.sharding import place

    mesh = logits.device_mesh
    vocab_dim = logits.ndim - 1
    rows = shard_axes(logits, 0)
    vocab = shard_axes(logits, vocab_dim)
    parallel = len(vocab) == 1
    data_pl = mesh_placements(mesh, {ax: Shard(0) for ax in rows})
    logit_pl = mesh_placements(mesh, {ax: Shard(0) for ax in rows}
                               | ({vocab[0]: Shard(vocab_dim)} if parallel else {}))
    sum_pl = mesh_placements(mesh, {ax: Partial() for ax in rows})
    n = labels.numel()
    args = [labels, mask] if mask is not None else [labels]
    args = [a if is_dtensor(a) else place(a, mesh, data_pl) for a in args]
    v_size = logits.shape[-1]

    def body(lg, lb, *m):
        lg = contiguous_grad(lg)
        if parallel:
            lo, width = local_range(v_size, mesh, logit_pl, vocab_dim)
            nll = _VocabParallelNLL.apply(lg, lb, lo, width,
                                          mesh.get_group(vocab[0]))
        else:
            nll = _nll(lg, lb)
        if m:
            mf = m[0].float()
            return torch.sum(nll * mf), torch.sum(mf)
        return (torch.mean(nll) * (nll.numel() / n),)

    outs = local_map(body, out_placements=(sum_pl,) * (2 if mask is not None else 1),
                     in_placements=(logit_pl,) + (data_pl,) * len(args),
                     in_grad_placements=(logit_pl,) + (data_pl,) * len(args),
                     device_mesh=mesh, redistribute_inputs=True)(logits, *args)
    if mask is not None:
        return outs[0] / torch.clamp(outs[1], min=1.0)
    return outs[0]


class _VocabParallelNLL(torch.autograd.Function):
    """Per-token NLL of logits sharded over the vocab (this rank's columns
    ``lo .. lo + width``): the max, the sum of exps and the gold logit are
    all-reduced over ``group``; the gradient, softmax less one-hot times
    the incoming gradient, is local to the shard."""

    @staticmethod
    def forward(ctx, logits, labels, lo: int, width: int, group):
        import torch.distributed._functional_collectives as funcol

        x = logits.float()
        m = funcol.wait_tensor(funcol.all_reduce(x.amax(-1), "max", group))
        e = torch.exp(x - m[..., None])
        total = funcol.wait_tensor(funcol.all_reduce(e.sum(-1), "sum", group))
        ids = labels.long()
        mine = (ids >= lo) & (ids < lo + width)
        col = torch.where(mine, ids - lo, 0)
        gold = torch.gather(x, -1, col[..., None])[..., 0] * mine
        gold = funcol.wait_tensor(funcol.all_reduce(gold, "sum", group))
        ctx.save_for_backward(e, total, col, mine)
        ctx.dtype = logits.dtype
        return m + torch.log(total) - gold

    @staticmethod
    def backward(ctx, grad):
        e, total, col, mine = ctx.saved_tensors
        g = e / total[..., None] * grad[..., None]
        g.scatter_add_(-1, col[..., None], -(grad * mine)[..., None])
        return g.to(ctx.dtype), None, None, None, None
