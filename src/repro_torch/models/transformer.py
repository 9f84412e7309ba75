"""Layer program and block stack (port of ``repro/models/transformer.py``).

Every architecture is described by a per-layer (mixer, ffn) program,
exactly as in the reference.  The port runs it as a plain Python loop over
one ``Block`` module per layer: PyTorch runs eagerly, so there is no scan
and no stacking of parameters over repeats (``interop.load_lm_params``
unstacks the reference's layout).  Mixers: ``attn`` (causal
self-attention), ``attn_nc`` (whisper's non-causal encoder layers),
``cross`` (llama-vision's image layers), ``self_cross`` (whisper's decoder:
causal self-attention, then cross-attention over the encoder's output),
``mamba`` and ``rwkv``; ffns ``mlp``, ``moe`` and ``rwkv_ffn``.

Two blocks run the full sequence: ``apply_block`` attends through the
kernel (serving's ``Model.forward`` and the encoder in serving),
``apply_train_block`` through ``train_self_attention`` (``Model.loss``:
the training kernels on the card in bf16, else ``_sdpa``); both return the
layer's MoE aux losses.  Cross-attention reads ``ctx["kv_src"]`` and is
``_sdpa`` in both.  ``stack_forward`` runs either, sums the aux losses over
the MoE layers and averages them, and with ``remat`` recomputes each
period's activations in the backward pass (``torch.utils.checkpoint``), as
the reference's ``jax.checkpoint`` does.  Prefill merges each layer's K/V
or final recurrent state into its cache; decode carries them, and routes
MoE layers at serving's larger capacity factor.  A ``cross`` layer has no
cache: it attends over ``kv_src`` at every step.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch import nn

from repro_torch import obs
from repro_torch.distributed.context import constrain, write_along
from repro_torch.models import ssm
from repro_torch.models.attention import (
    Attention,
    KVCacheSpec,
    _project_qkv,
    attend,
    cross_attention,
    decode_attention,
    kv_cache_init,
    self_attention,
    sequence_positions,
    train_self_attention,
)
from repro_torch.models.layers import MLP, RMSNorm
from repro_torch.models.moe import MoE, moe

@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str  # attn | attn_nc | mamba | rwkv | cross | self_cross
    ffn: str  # mlp | moe | rwkv_ffn


def layer_program(cfg) -> list[LayerSpec]:
    """The per-layer program of the decoder stack."""
    specs: list[LayerSpec] = []
    for li in range(cfg.n_layers):
        if cfg.family == "ssm":
            specs.append(LayerSpec("rwkv", "rwkv_ffn"))
            continue
        ffn = "mlp"
        if cfg.n_experts and li % cfg.moe_every == cfg.moe_every - 1:
            ffn = "moe"
        if cfg.family == "hybrid":
            mixer = "attn" if li % cfg.attn_period == cfg.attn_period // 2 else "mamba"
        elif cfg.family == "vlm" and cfg.cross_attn_every:
            mixer = (
                "cross" if li % cfg.cross_attn_every == cfg.cross_attn_every - 1 else "attn"
            )
        elif cfg.family == "encdec":
            mixer = "self_cross"
        else:
            mixer = "attn"
        specs.append(LayerSpec(mixer, ffn))
    return specs


def find_period(program: list[LayerSpec]) -> tuple[int, int]:
    """Smallest period p with program[i] == program[i % p]; returns (p, repeats)."""
    n = len(program)
    for p in range(1, n + 1):
        if n % p == 0 and all(program[i] == program[i % p] for i in range(n)):
            return p, n // p
    return n, 1


ATTENTION_MIXERS = ("attn", "attn_nc", "cross", "self_cross")


class Block(nn.Module):
    """One layer, ``norm1 <mixer> norm2 <ffn>``, named as the reference's
    block: the mixer is ``attn`` (``attn``, ``attn_nc``, ``cross``; for
    ``self_cross`` the self-attention, then ``norm_cross`` and ``cross``)
    or ``mixer`` (mamba, rwkv), the ffn ``mlp``, ``moe`` or ``ffn`` (rwkv's
    channel mix)."""

    def __init__(self, cfg, spec: LayerSpec, dtype, device):
        super().__init__()
        self.spec = spec
        self.norm1 = RMSNorm(cfg.d_model, dtype, device)
        if spec.mixer in ATTENTION_MIXERS:
            self.attn = Attention(cfg, dtype, device)
            if spec.mixer == "self_cross":
                self.cross = Attention(cfg, dtype, device)
                self.norm_cross = RMSNorm(cfg.d_model, dtype, device)
        elif spec.mixer == "mamba":
            self.mixer = ssm.Mamba(cfg, dtype, device)
        elif spec.mixer == "rwkv":
            self.mixer = ssm.RWKVTimeMix(cfg, dtype, device)
        else:
            raise ValueError(spec.mixer)
        self.norm2 = RMSNorm(cfg.d_model, dtype, device)
        if spec.ffn == "mlp":
            self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device)
        elif spec.ffn == "moe":
            self.moe = MoE(cfg, dtype, device)
        else:
            self.ffn = ssm.RWKVChannelMix(cfg, dtype, device)

    def init(self, generator: torch.Generator) -> None:
        for child in self.children():
            if not isinstance(child, RMSNorm):
                child.init(generator)


# ---------------------------------------------------------------------------
# full sequence, prefill, decode
# ---------------------------------------------------------------------------


def _cross(p: Block, cfg, x: torch.Tensor, ctx: dict) -> torch.Tensor:
    """x after a ``self_cross`` layer's cross-attention (its own norm);
    unchanged for every other mixer."""
    if p.spec.mixer != "self_cross":
        return x
    x = constrain(x, "btd")  # pinned after the self-attention, as before the ffn
    return x + cross_attention(p.cross, cfg, p.norm_cross(x), ctx["kv_src"])


def _mix(p: Block, cfg, x: torch.Tensor, ctx: dict, attention) -> torch.Tensor:
    """x after the layer's mixer and its residual."""
    h = p.norm1(x)
    mixer = p.spec.mixer
    if mixer == "cross":
        return x + cross_attention(p.attn, cfg, h, ctx["kv_src"])
    if mixer in ("attn", "attn_nc", "self_cross"):
        x = x + attention(p.attn, cfg, h, causal=mixer != "attn_nc")
    elif mixer == "mamba":
        x = x + ssm.mamba(p.mixer, cfg, h)
    else:
        x = x + ssm.rwkv_time_mix(p.mixer, cfg, h)
    return _cross(p, cfg, x, ctx)


def _ffn(p: Block, cfg, h2: torch.Tensor, capacity_factor: float | None = None):
    """The layer's ffn on h2; returns (out, MoE aux losses or None)."""
    if p.spec.ffn == "mlp":
        return p.mlp(h2), None
    if p.spec.ffn == "moe":
        return moe(p.moe, cfg, h2, capacity_factor)
    return ssm.rwkv_channel_mix(p.ffn, cfg, h2), None


def apply_block(p: Block, cfg, x: torch.Tensor, ctx: dict, attention=self_attention):
    """One block over the full sequence, self-attention through the kernel;
    ``ctx["kv_src"]`` (B, T, D) feeds cross-attention.  Returns (x, MoE aux
    losses or None).  Under a policy the residual stream is pinned to the
    ``btd`` layout between the mixer and the ffn too: left to DTensor, the
    mixer's model-partial output is reduce-scattered over d_model, and the
    ffn then gathers its weights whole instead of running tensor-parallel."""
    x = constrain(_mix(p, cfg, x, ctx, attention), "btd")
    out, aux = _ffn(p, cfg, p.norm2(x))
    return x + out, aux


def apply_train_block(p: Block, cfg, x: torch.Tensor, ctx: dict):
    """One block over the full sequence, differentiable: the reference's
    ``apply_block``, attending through ``train_self_attention``."""
    return apply_block(p, cfg, x, ctx, attention=train_self_attention)


# matmuls without batch dims: what jax's dots_with_no_batch_dims_saveable
# keeps (``x @ w`` of a (B, S, D) activation folds to one ``mm``)
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def stack_forward(blocks, cfg, x: torch.Tensor, ctx: dict, block=apply_block,
                  remat: bool = False):
    """Run ``block`` through the stack (the decoder's or the encoder's).
    Returns (x, aux): the MoE aux losses summed over the layers and divided
    by the number of MoE layers (zeros without one), as the reference
    averages them.  With ``remat``, each period of the stack's layer program
    runs under ``torch.utils.checkpoint``, keeping only its input (and
    ``ctx``) for the backward pass (``cfg.remat_policy`` "full"), or also
    its weight matmuls' outputs ("dots")."""

    def run(x, group, ctx):
        lb = z = x.new_zeros((), dtype=torch.float32)
        for p in group:
            x, aux = block(p, cfg, constrain(x, "btd"), ctx)
            if aux is not None:
                lb, z = lb + aux["moe_lb_loss"], z + aux["moe_z_loss"]
        return constrain(x, "btd"), lb, z

    if not remat:
        x, lb, z = run(x, blocks, ctx)
    else:
        from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

        kw = {}
        if cfg.remat_policy == "dots":
            kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                 _save_dots)

        def recomputable(x, group, ctx):
            # inside the backward this call is the recompute (checkpoint.py's own test)
            if torch._C._current_graph_task_id() == -1:
                return run(x, group, ctx)
            with obs.span("model.recompute", device=x.device):
                return run(x, group, ctx)

        period, _ = find_period([p.spec for p in blocks])
        lb = z = x.new_zeros((), dtype=torch.float32)
        for i in range(0, len(blocks), period):
            x, lb_i, z_i = checkpoint(recomputable, x, blocks[i:i + period], ctx,
                                      use_reentrant=False, **kw)
            lb, z = lb + lb_i, z + z_i
    n_moe = max(1, sum(1 for p in blocks if p.spec.ffn == "moe"))
    return x, {"moe_lb_loss": lb / n_moe, "moe_z_loss": z / n_moe}


def stack_prefill(blocks, cfg, x: torch.Tensor, caches: list, ctx: dict):
    """Prefill through the stack.  Writes each self-attention layer's
    prompt K/V into its cache in place (``self_cross`` too, then its
    cross-attention over ``ctx["kv_src"]``), and puts each SSM layer's
    final state into its cache dict; a ``cross`` layer has no cache.
    Returns (x, caches).  The reference projects q/k/v twice here (once for
    the cache, once inside its block); the port projects once, with the
    same numbers."""
    for p, c in zip(blocks, caches):
        x = constrain(x, "btd")
        h = p.norm1(x)
        if p.spec.mixer in ("attn", "self_cross"):
            with obs.span("attention"):
                q, k, v = _project_qkv(p.attn, cfg, h, sequence_positions(h))
                x = x + attend(p.attn, q, k, v, causal=True)
                write_along(c["k"], 0, k)
                write_along(c["v"], 0, v)
            x = _cross(p, cfg, x, ctx)
        elif p.spec.mixer == "cross":
            x = x + cross_attention(p.attn, cfg, h, ctx["kv_src"])
        elif p.spec.mixer == "mamba":
            out, state = ssm.mamba(p.mixer, cfg, h, return_state=True)
            x = x + out
            c.update(state)
        else:
            out, state = ssm.rwkv_time_mix(p.mixer, cfg, h, return_state=True)
            x = x + out
            c.update(s=state["s"], x_prev_att=state["x_prev"])
        x = constrain(x, "btd")  # between the mixer and the ffn, as ``apply_block`` pins it
        h2 = p.norm2(x)
        out, _ = _ffn(p, cfg, h2)
        if p.spec.ffn == "rwkv_ffn":
            c["x_prev_ffn"] = h2[:, -1, :].float()
        x = x + out
    return x, caches


def apply_block_decode(p: Block, cfg, x: torch.Tensor, cache: dict, pos: int, ctx: dict):
    """One block, one token; cross-attention reads ``ctx["kv_src"]``.
    Returns (x, cache); a MoE layer routes at ``max(cfg.moe_capacity_factor,
    2.0)`` (a dropped token is a quality bug in serving)."""
    h = p.norm1(x)
    mixer = p.spec.mixer
    if mixer in ("attn", "self_cross"):
        out, cache = decode_attention(p.attn, cfg, h, cache, pos)
    elif mixer == "cross":
        out = cross_attention(p.attn, cfg, h, ctx["kv_src"])
    elif mixer == "mamba":
        out, state = ssm.mamba_decode(p.mixer, cfg, h, cache)
        cache.update(state)
    else:
        out, state = ssm.rwkv_time_mix_decode(
            p.mixer, cfg, h, {"s": cache["s"], "x_prev": cache["x_prev_att"]})
        cache.update(s=state["s"], x_prev_att=state["x_prev"])
    x = _cross(p, cfg, x + out, ctx)
    h2 = p.norm2(x)
    if p.spec.ffn == "rwkv_ffn":
        out = ssm.rwkv_channel_mix(p.ffn, cfg, h2, cache["x_prev_ffn"])
        cache["x_prev_ffn"] = h2[:, 0, :].float()
    else:
        out, _ = _ffn(p, cfg, h2, capacity_factor=max(cfg.moe_capacity_factor, 2.0))
    return x + out, cache


def stack_decode(blocks, cfg, x: torch.Tensor, caches: list, pos: int, ctx: dict):
    """Decode through the stack, one cache per layer.  Returns (x, caches)."""
    for li, p in enumerate(blocks):
        x, caches[li] = apply_block_decode(p, cfg, constrain(x, "btd"), caches[li], pos, ctx)
    return x, caches


def block_cache_init(cfg, spec: LayerSpec, batch: int, max_seq: int, dtype,
                     device=None) -> dict:
    """A layer's serving cache: K/V (B, max_seq, nkv, hd) of self-attention
    (``attn``, ``self_cross``), nothing for ``cross`` (its keys and values
    come from ``kv_src``), or the f32 recurrent state of mamba ({"h",
    "conv"}) and rwkv ({"s", "x_prev_att", "x_prev_ffn"})."""
    if spec.mixer == "cross":
        return {}
    if spec.mixer == "mamba":
        return ssm.mamba_state_init(cfg, batch, device)
    if spec.mixer == "rwkv":
        return ssm.rwkv_state_init(cfg, batch, device)
    if spec.mixer not in ("attn", "self_cross"):
        raise ValueError(spec.mixer)
    return kv_cache_init(KVCacheSpec(batch, max_seq, cfg.n_kv_heads, cfg.head_dim, dtype),
                         device)


def stack_cache_init(cfg, program: list[LayerSpec], batch: int, max_seq: int, dtype,
                     device=None) -> list:
    """One cache per layer, as in the reference's serving layout."""
    return [block_cache_init(cfg, spec, batch, max_seq, dtype, device) for spec in program]
