"""Grouped-query attention for training, prefill and decode, and
cross-attention (port of ``repro/models/attention.py``).

Training (``train_self_attention``) on the card, in bf16 at head_dim 64
or 128, attends through the port's training kernels and their backward
(``kernels.attention.ops.flash_attention_train``, ``csrc/attention.cu``).
Everywhere else it takes the reference's own math: einsum ``_sdpa`` with
the additive ``causal_mask`` (none for the encoder's non-causal layers), or
the query-chunked ``_blocked_sdpa`` above ``BLOCKED_ATTN_THRESHOLD``, so
autograd differentiates plain torch ops: CPU tensors, f32, fake tensors
(the dry run), DTensors under a policy and head_dim 32.
Serving differs from the reference on purpose: full-sequence
self-attention, causal in prefill and non-causal in whisper's encoder,
goes through the port's attention kernel
(``kernels.attention.ops.flash_attention``, ``csrc/attention.cu`` on the
card), where the reference computes it with ``_sdpa`` to keep its dry-run's
XLA cost analysis readable.  The function is the same; the results are
allclose.  The serving kernel itself is not differentiable on the card.
Decode keeps ``_sdpa`` over the whole cache with the ``<= pos``
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

import numpy as np
import torch
from torch import nn

from repro_torch import obs
from repro_torch.distributed.context import (
    contiguous_grad,
    gather_fsdp,
    get_policy,
    is_dtensor,
    local_range,
    mesh_placements,
    row_axes,
    split_dim,
    write_along,
)
from repro_torch.kernels.attention.attention import TRAIN_HEAD_DIMS, attention_flops
from repro_torch.kernels.attention.ops import flash_attention, flash_attention_train
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


def _project_qkv(p: Attention, cfg, x: torch.Tensor, positions: torch.Tensor):
    """x: (B, S, D) -> q (B, S, nq, hd), k/v (B, S, nkv, hd); rotated by
    ``positions`` unless the config's attention has none (``attn_rope``
    off: prefill, the cache and decode then hold unrotated q and k)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = x @ gather_fsdp(p.wq)
    k = x @ gather_fsdp(p.wk)
    v = x @ gather_fsdp(p.wv)
    if cfg.qkv_bias:
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    q = split_dim(q, 2, (cfg.n_heads, hd))
    k = split_dim(k, 2, (cfg.n_kv_heads, hd))
    v = split_dim(v, 2, (cfg.n_kv_heads, hd))
    if cfg.qk_norm:
        q = p.q_norm(q)
        k = p.k_norm(k)
    if cfg.attn_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor | None, constrain_heads: bool = False) -> torch.Tensor:
    """Grouped scaled-dot-product attention in plain torch ops.

    q: (B, Sq, nq, hd); k, v: (B, Sk, nkv, hd); nq = nkv * group.
    mask: additive, broadcastable to (B, 1, Sq, Sk), or None.
    constrain_heads: under a policy, on DTensors, attend head-parallel on
    each rank's shard (``_head_parallel``: training, prefill and
    cross-attention; decode caches are sequence-sharded instead)."""
    if constrain_heads and get_policy() is not None and is_dtensor(q):
        return _head_parallel(lambda q_, k_, v_: _sdpa(q_, k_, v_, mask), q, k, v,
                              get_policy())
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _SDPA.apply(q, k, v, mask)
    return _attend(q, k, v, mask)


def _attend(q, k, v, mask):
    """``_sdpa``'s forward ops."""
    b, sq, nq, hd = q.shape
    return _weigh(_probs(q, k, mask).to(v.dtype), v).reshape(b, sq, nq * hd)


def _probs(q, k, mask):
    """The f32 softmax of the masked scores, (B, nkv, group, Sq, Sk)."""
    logits = _scores(q, k)
    if mask is not None:
        logits = logits + mask[:, :, None, :, :]
    return torch.softmax(logits, dim=-1)


class _SDPA(torch.autograd.Function):
    """``_sdpa`` for training: the same forward ops, saving only q, k, v and
    the mask, so no (Sq, Sk) tensor of the layer is kept between the
    passes.  The backward recomputes the probabilities ``Q_CHUNK`` query
    rows at a time (whole rows, so the same softmax gives the forward's
    values bit for bit) and takes the softmax backward in f32 as autograd
    does, dS = P (dP - rowsum(P dP))."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        ctx.save_for_backward(q, k, v, mask)
        return _attend(q, k, v, mask)

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, mask = ctx.saved_tensors
        b, sq, nq, hd = q.shape
        nkv = k.shape[2]
        scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
        d_out = d_out.reshape(b, sq, nkv, nq // nkv, hd)
        dq = []
        dk = dv = None
        for i in range(0, sq, Q_CHUNK):
            j = min(i + Q_CHUNK, sq)
            rows = mask if mask is None or mask.shape[2] == 1 else mask[:, :, i:j]
            probs = _probs(q[:, i:j], k, rows)
            do = d_out[:, i:j]
            dp = torch.einsum("bqkgh,bskh->bkgqs", do, v).float()
            ds = (torch.ops.aten._softmax_backward_data(dp, probs, -1, torch.float32)
                  * scale).to(q.dtype)
            dq.append(torch.einsum("bkgqs,bskh->bqkgh", ds, k).reshape(b, j - i, nq, hd))
            dk_i = torch.einsum("bkgqs,bqkgh->bskh", ds,
                                q[:, i:j].reshape(b, j - i, nkv, nq // nkv, hd)).float()
            dv_i = torch.einsum("bkgqs,bqkgh->bskh", probs.to(v.dtype), do).float()
            dk, dv = (dk_i, dv_i) if dk is None else (dk + dk_i, dv + dv_i)
        return torch.cat(dq, dim=1), dk.to(k.dtype), dv.to(v.dtype), None


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Scaled grouped scores of q (B, Sq, nq, hd) against k (B, Sk, nkv,
    hd): (B, nkv, group, Sq, Sk) in f32."""
    b, sq, nq, hd = q.shape
    nkv = k.shape[2]
    qg = q.reshape(b, sq, nkv, nq // nkv, hd)
    # 1/sqrt(hd) rounded as the reference rounds it: sqrt in f32, then 1/x
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    return torch.einsum("bqkgh,bskh->bkgqs", qg, k).float() * scale


def _weigh(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Weights (B, nkv, group, Sq, Sk) times v (B, Sk, nkv, hd): (B, Sq,
    nkv, group, hd)."""
    return torch.einsum("bkgqs,bskh->bqkgh", probs, v)


def _head_parallel(attend_fn, q, k, v, pol) -> torch.Tensor:
    """``attend_fn(q, k, v)`` (a (B, Sq, nq * hd) result) head-parallel
    through ``local_map``: every rank attends with its rows of the batch
    (over the batch axes that divide it) and its heads (over "model"), so
    forward and backward stay local, as the reference pins them with its
    ``attn_q``/``attn_kv`` constraints.  Where
    the kv heads do not divide the model axis (qwen3's 8 on 16), K/V are
    repeated to the query heads, each query head with its own copy; where
    the query heads do not either (arctic's 56 on 16), the heads are padded
    with zeros to a multiple of it, as the reference's GSPMD pads them, and
    the padded heads' output is dropped."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map

    b, sq, nq, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    mesh = q.device_mesh
    tp = pol.axis_size(pol.model)
    if nkv % tp:
        k, v = (t[:, :, :, None].expand(b, sk, nkv, nq // nkv, hd).reshape(b, sk, nq, hd)
                for t in (k, v))
        nkv = nq
    n_pad = -nkv % tp
    rows = {ax: Shard(0) for ax in row_axes(pol, mesh, b)}
    pl = mesh_placements(mesh, {pol.model: Shard(2), **rows})
    whole = mesh_placements(mesh, rows)  # every head
    if n_pad:  # padded on each rank's whole heads, so DTensor never pads a shard
        q, k, v = (_local(lambda t: torch.nn.functional.pad(t, (0, 0, 0, n_pad)), t, whole)
                   for t in (q, k, v))
    def attend_local(q_, k_, v_):
        if mesh.size() > 1:  # one rank's gradients are the whole ones, as laid out
            q_, k_, v_ = (contiguous_grad(t) for t in (q_, k_, v_))
        return attend_fn(q_, k_, v_).contiguous()

    fn = local_map(attend_local, out_placements=(pl,),
                   in_placements=(pl, pl, pl), in_grad_placements=(pl, pl, pl),
                   device_mesh=mesh, redistribute_inputs=True)
    out = fn(q, k, v)
    return _local(lambda t: t[..., :nq * hd].contiguous(), out, whole) if n_pad else out


def _local(fn, x, pl):
    """``fn`` on the local tensor of ``x`` placed as ``pl``, in and out."""
    from torch.distributed.tensor.experimental import local_map

    return local_map(fn, out_placements=(pl,), in_placements=(pl,), in_grad_placements=(pl,),
                     device_mesh=x.device_mesh, redistribute_inputs=True)(x)


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
        outs.append(_sdpa(q[:, i * q_chunk:(i + 1) * q_chunk], k, v, mask,
                          constrain_heads=True))
    return torch.cat(outs, dim=1)


def sequence_positions(x: torch.Tensor) -> torch.Tensor:
    """0..S-1 for every row of x (B, S, ...)."""
    b, s = x.shape[:2]
    return torch.arange(s, device=x.device).expand(b, s)


def attend(p: Attention, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool = True) -> torch.Tensor:
    """Attention of projected q (B, S, nq, hd) over k, v (B, S, nkv, hd)
    through the kernel, then WO: (B, S, D).  Under a policy, on DTensors,
    the kernel runs head-parallel on each rank's shard, as ``_sdpa`` does:
    the op's own sharding rule splits only the batch where the kv heads do
    not divide the mesh, and every "model" rank then attends with every
    head."""
    pol = get_policy()
    if pol is not None and is_dtensor(q):
        out = _head_parallel(lambda q_, k_, v_: flash_attention(q_, k_, v_, causal=causal),
                             q, k, v, pol)
    else:
        out = flash_attention(q, k, v, causal=causal)
    return out @ gather_fsdp(p.wo)


def self_attention(p: Attention, cfg, x: torch.Tensor,
                   positions: torch.Tensor | None = None,
                   causal: bool = True) -> torch.Tensor:
    """Full self-attention through the serving kernel (prefill and
    ``Model.forward``; not differentiable on the card: training takes
    ``train_self_attention``). x: (B, S, D)."""
    with obs.span("attention"):
        if positions is None:
            positions = sequence_positions(x)
        return attend(p, *_project_qkv(p, cfg, x, positions), causal=causal)


def _takes_train_kernel(q: torch.Tensor) -> bool:
    """Whether training attends through the kernels: a real (not fake, not
    DTensor) CUDA tensor in bf16 at a head_dim they take."""
    from torch._subclasses.fake_tensor import FakeTensor

    return (q.is_cuda and q.dtype == torch.bfloat16 and q.shape[-1] in TRAIN_HEAD_DIMS
            and not isinstance(q, FakeTensor) and not is_dtensor(q))


def train_self_attention(p: Attention, cfg, x: torch.Tensor,
                         positions: torch.Tensor | None = None,
                         causal: bool = True) -> torch.Tensor:
    """Full self-attention for training, differentiable (the reference's
    ``self_attention``): the training kernels where ``_takes_train_kernel``,
    at any S; else ``_blocked_sdpa`` above ``BLOCKED_ATTN_THRESHOLD`` when S
    is a multiple of ``Q_CHUNK``, else ``_sdpa``.  Counts
    ``attention.train_calls`` and, on the kernels' route,
    ``attention.train_kernel`` and the call's forward operations and bytes
    (``attention.train_kernel_flops``: QKᵀ and PV, halved when causal;
    ``attention.train_kernel_bytes``: q, k, v read and the output written).
    x: (B, S, D)."""
    with obs.span("attention"):
        s = x.shape[1]
        if positions is None:
            positions = sequence_positions(x)
        q, k, v = _project_qkv(p, cfg, x, positions)
        obs.count("attention.train_calls", 1)
        if _takes_train_kernel(q):
            obs.count("attention.train_kernel", 1)
            obs.count("attention.train_kernel_flops",
                      attention_flops(q.shape, k.shape, v.shape, causal))
            obs.count("attention.train_kernel_bytes",
                      q.element_size() * (2 * q.numel() + k.numel() + v.numel()))
            out = flash_attention_train(q, k, v, causal=causal)
        elif s > BLOCKED_ATTN_THRESHOLD and s % Q_CHUNK == 0:
            out = _blocked_sdpa(q, k, v, causal)
        else:
            out = _sdpa(q, k, v, causal_mask(s, s, device=x.device) if causal else None,
                        constrain_heads=True)
        return out @ gather_fsdp(p.wo)


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
    q = split_dim(x @ gather_fsdp(p.wq), 2, (cfg.n_heads, hd))
    k = split_dim(kv_src @ gather_fsdp(p.wk), 2, (cfg.n_kv_heads, hd))
    v = split_dim(kv_src @ gather_fsdp(p.wv), 2, (cfg.n_kv_heads, hd))
    if cfg.qk_norm:
        q = p.q_norm(q)
        k = p.k_norm(k)
    return _sdpa(q, k, v, None, constrain_heads=True) @ gather_fsdp(p.wo)


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
    with obs.span("attention"):
        b = x.shape[0]
        pos = int(pos)
        positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
        q, k_new, v_new = _project_qkv(p, cfg, x, positions)
        write_along(cache["k"], pos, k_new)
        write_along(cache["v"], pos, v_new)
        pol = get_policy()
        if pol is not None and is_dtensor(q):
            out = _decode_sdpa_sharded(q, cache["k"], cache["v"], pos, pol)
        else:
            out = _sdpa(q, cache["k"].to(x.dtype), cache["v"].to(x.dtype),
                        _decode_mask(0, cache["k"].shape[1], pos, x.device))
        return out @ gather_fsdp(p.wo), cache


def _decode_mask(off: int, n: int, pos: int, device) -> torch.Tensor:
    """(1, 1, 1, n) additive mask of cache slots ``off .. off + n``: 0 up to
    ``pos``, -1e30 after."""
    valid = torch.arange(off, off + n, device=device)[None, :] <= pos
    return torch.where(valid, 0.0, NEG_INF).to(torch.float32)[:, None, None, :]


def _decode_sdpa_sharded(q, k, v, pos: int, pol) -> torch.Tensor:
    """Decode attention over a sequence-sharded cache, context-parallel,
    through ``local_map``: each rank attends with its batch rows over its
    own slots of the cache; the softmax is combined across the "model"
    ranks from each rank's max, sum and unnormalised output (three small
    all-reduces), so no rank gathers the cache.  On one model rank it is
    ``_sdpa`` over the rank's cache, op for op."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map

    sk = k.shape[1]
    mesh = q.device_mesh
    split = pol.axis_size(pol.model) > 1
    rows = {ax: Shard(0) for ax in row_axes(pol, mesh, q.shape[0])}
    q_pl, kv_pl = mesh_placements(mesh, rows), mesh_placements(mesh, {pol.model: Shard(1), **rows})

    def attend_local(q_, k_, v_):
        off, n = local_range(sk, mesh, kv_pl, 1)
        mask = _decode_mask(off, n, pos, q_.device)
        k_, v_ = k_.to(q_.dtype), v_.to(q_.dtype)
        if not split:
            return _sdpa(q_, k_, v_, mask)
        group = mesh.get_group(pol.model)
        logits = _scores(q_, k_) + mask[:, :, None, :, :]
        m = funcol.all_reduce(logits.amax(-1, keepdim=True), "max", group)
        e = torch.exp(logits - m)
        total = funcol.all_reduce(e.sum(-1, keepdim=True), "sum", group)
        o = funcol.all_reduce(_weigh(e.to(v_.dtype), v_).float(), "sum", group)
        out = o / total.permute(0, 3, 1, 2, 4)
        return out.to(q_.dtype).reshape(q_.shape[0], 1, -1)

    return local_map(attend_local, out_placements=(q_pl,),
                     in_placements=(q_pl, kv_pl, kv_pl), in_grad_placements=None,
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)
