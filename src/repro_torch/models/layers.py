"""Shared layers of the LM zoo (port of ``repro/models/layers.py``).

Plain functions on tensors.  Compute runs in the config dtype (bf16 on the
card) with f32 where the reference takes it (norms, RoPE, the SwiGLU
activation).  Weights keep the reference's ``(in, out)`` layout and are
applied as ``x @ w``.
"""
from __future__ import annotations

import torch
from torch import nn


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
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * scale.float()).to(x.dtype)


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
    g = x @ wg
    h = x @ wi
    act = torch.nn.functional.silu(g.float()).to(x.dtype) * h
    return act @ wo


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
    return tok[tokens.long()]


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


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross-entropy in f32: logsumexp of the upcast logits less
    the gold logit (a gather, no one-hot).  With ``mask``, the masked mean,
    divided by ``max(sum(mask), 1)``."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
