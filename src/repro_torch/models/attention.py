"""Grouped-query attention for training, prefill and decode, and
cross-attention (port of ``repro/models/attention.py``).

Training takes the reference's own math: einsum ``_sdpa`` with the additive
``causal_mask`` (none for the encoder's non-causal layers), or the
query-chunked ``_blocked_sdpa`` above ``BLOCKED_ATTN_THRESHOLD``
(``train_self_attention``), so autograd differentiates plain torch ops.
Serving differs from the reference on purpose: full-sequence
self-attention, causal in prefill and non-causal in whisper's encoder,
goes through the port's attention kernel
(``kernels.attention.ops.flash_attention``, ``csrc/attention.cu`` on the
card), where the reference computes it with ``_sdpa`` to keep its dry-run's
XLA cost analysis readable.  The function is the same; the results are
allclose.  The kernel has no backward and refuses to be differentiated on
the card.  Decode keeps ``_sdpa`` over the whole cache with the ``<= pos``
mask, as the reference does.  ``cross_attention`` (queries from the text,
keys and values from the encoder's output or the image embeddings) is
``_sdpa`` everywhere, as in the reference: the kernel takes one S for q
and k/v.

The KV cache has the reference's layout, ``(B, max_seq, nkv, hd)`` per
layer.  Unlike the reference's functional update, prefill and decode write
it in place (the returned dict holds the same tensors).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.kernels.attention.ops import flash_attention
from repro_torch.models.layers import RMSNorm, apply_rope, dense_init_, weight

NEG_INF = -1e30


class Attention(nn.Module):
    """Parameters of one attention layer, named as in the reference:
    ``wq wk wv wo`` (``(in, out)``), ``bq bk bv`` with ``qkv_bias``,
    ``q_norm k_norm`` with ``qk_norm``."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        nq, nkv = cfg.n_heads, cfg.n_kv_heads
        kw = dict(dtype=dtype, device=device)
        self.wq = weight(d, nq * hd, **kw)
        self.wk = weight(d, nkv * hd, **kw)
        self.wv = weight(d, nkv * hd, **kw)
        self.wo = weight(nq * hd, d, **kw)
        if cfg.qkv_bias:
            self.bq = weight(nq * hd, **kw)
            self.bk = weight(nkv * hd, **kw)
            self.bv = weight(nkv * hd, **kw)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, dtype, device)
            self.k_norm = RMSNorm(hd, dtype, device)

    def init(self, generator: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            dense_init_(w, generator)


def _project_qkv(p: Attention, cfg, x: torch.Tensor, positions: torch.Tensor,
                 rope: bool = True):
    """x: (B, S, D) -> q (B, S, nq, hd), k/v (B, S, nkv, hd)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if cfg.qkv_bias:
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    q = q.reshape(b, s, cfg.n_heads, hd)
    k = k.reshape(b, s, cfg.n_kv_heads, hd)
    v = v.reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = p.q_norm(q)
        k = p.k_norm(k)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor | None) -> torch.Tensor:
    """Grouped scaled-dot-product attention in plain torch ops.

    q: (B, Sq, nq, hd); k, v: (B, Sk, nkv, hd); nq = nkv * group.
    mask: additive, broadcastable to (B, 1, Sq, Sk), or None."""
    b, sq, nq, hd = q.shape
    nkv = k.shape[2]
    qg = q.reshape(b, sq, nkv, nq // nkv, hd)
    # 1/sqrt(hd) rounded as the reference rounds it: sqrt in f32, then 1/x
    scale = float(1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32)))
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float() * scale
    if mask is not None:
        logits = logits + mask[:, :, None, :, :]
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(b, sq, nq * hd)


def causal_mask(sq: int, sk: int, q_offset: int = 0, device=None) -> torch.Tensor:
    """(1, 1, sq, sk) additive causal mask; query i attends to keys <= i+off."""
    qi = torch.arange(sq, device=device)[:, None] + q_offset
    ki = torch.arange(sk, device=device)[None, :]
    mask = torch.where(ki <= qi, 0.0, NEG_INF).to(torch.float32)
    return mask[None, None, :, :]


# Above this sequence length the S x S logits no longer fit and training
# attention switches to the query-chunked form, as in the reference.
BLOCKED_ATTN_THRESHOLD = 8192
Q_CHUNK = 512


def _blocked_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                  q_chunk: int = Q_CHUNK) -> torch.Tensor:
    """Query-chunked attention, K/V resident: ``_sdpa`` on each block of
    ``q_chunk`` queries, so the live logits are (B, heads, q_chunk, S)
    rather than (B, heads, S, S).  Raises unless S is a multiple of the
    chunk, as the reference asserts."""
    b, s, nq, hd = q.shape
    if s % q_chunk:
        raise ValueError(f"sequence {s} is not a multiple of the query chunk {q_chunk}")
    outs = []
    for i in range(s // q_chunk):
        mask = causal_mask(q_chunk, s, i * q_chunk, q.device) if causal else None
        outs.append(_sdpa(q[:, i * q_chunk:(i + 1) * q_chunk], k, v, mask))
    return torch.cat(outs, dim=1)


def sequence_positions(x: torch.Tensor) -> torch.Tensor:
    """0..S-1 for every row of x (B, S, ...)."""
    b, s = x.shape[:2]
    return torch.arange(s, device=x.device).expand(b, s)


def attend(p: Attention, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool = True) -> torch.Tensor:
    """Attention of projected q (B, S, nq, hd) over k, v (B, S, nkv, hd)
    through the kernel, then WO: (B, S, D)."""
    return flash_attention(q, k, v, causal=causal) @ p.wo


def self_attention(p: Attention, cfg, x: torch.Tensor,
                   positions: torch.Tensor | None = None,
                   causal: bool = True) -> torch.Tensor:
    """Full self-attention through the kernel (prefill and
    ``Model.forward``; not differentiable on the card). x: (B, S, D)."""
    if positions is None:
        positions = sequence_positions(x)
    return attend(p, *_project_qkv(p, cfg, x, positions), causal=causal)


def train_self_attention(p: Attention, cfg, x: torch.Tensor,
                         positions: torch.Tensor | None = None,
                         causal: bool = True) -> torch.Tensor:
    """Full self-attention for training, differentiable (the reference's
    ``self_attention``): ``_blocked_sdpa`` above ``BLOCKED_ATTN_THRESHOLD``
    when S is a multiple of ``Q_CHUNK``, else ``_sdpa``. x: (B, S, D)."""
    s = x.shape[1]
    if positions is None:
        positions = sequence_positions(x)
    q, k, v = _project_qkv(p, cfg, x, positions)
    if s > BLOCKED_ATTN_THRESHOLD and s % Q_CHUNK == 0:
        out = _blocked_sdpa(q, k, v, causal)
    else:
        out = _sdpa(q, k, v, causal_mask(s, s, device=x.device) if causal else None)
    return out @ p.wo


def cross_attention(p: Attention, cfg, x: torch.Tensor, kv_src: torch.Tensor) -> torch.Tensor:
    """Queries from x (B, S, D), keys and values from kv_src (B, T, D):
    whisper's decoder over the encoder's output, llama-vision's image
    layers over the patch embeddings.  As in the reference, no RoPE and no
    ``bq bk bv`` on this path (the biases of a ``qkv_bias`` config are
    ignored), ``qk_norm`` where the config has it, no mask.  Plain torch
    ops, for training and serving alike."""
    b, s, _ = x.shape
    t = kv_src.shape[1]
    hd = cfg.head_dim
    q = (x @ p.wq).reshape(b, s, cfg.n_heads, hd)
    k = (kv_src @ p.wk).reshape(b, t, cfg.n_kv_heads, hd)
    v = (kv_src @ p.wv).reshape(b, t, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = p.q_norm(q)
        k = p.k_norm(k)
    return _sdpa(q, k, v, None) @ p.wo


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KVCacheSpec:
    batch: int
    max_seq: int
    n_kv_heads: int
    head_dim: int
    dtype: object


def kv_cache_init(spec: KVCacheSpec, device=None) -> dict:
    shape = (spec.batch, spec.max_seq, spec.n_kv_heads, spec.head_dim)
    return {"k": torch.zeros(shape, dtype=spec.dtype, device=device),
            "v": torch.zeros(shape, dtype=spec.dtype, device=device)}


def decode_attention(p: Attention, cfg, x: torch.Tensor, cache: dict, pos: int):
    """One-token decode step.

    x: (B, 1, D); cache k/v: (B, max_seq, nkv, hd); pos: the position being
    written (one for the whole batch).  Writes the new K/V at ``pos`` in
    place and attends over the cache slots ``<= pos``.  Returns
    (out (B, 1, D), cache)."""
    b = x.shape[0]
    pos = int(pos)
    positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    cache["k"][:, pos] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, pos] = v_new[:, 0].to(cache["v"].dtype)
    sk = cache["k"].shape[1]
    valid = torch.arange(sk, device=x.device)[None, :] <= pos
    mask = torch.where(valid, 0.0, NEG_INF).to(torch.float32)[:, None, None, :]
    out = _sdpa(q, cache["k"].to(x.dtype), cache["v"].to(x.dtype), mask)
    return out @ p.wo, cache
