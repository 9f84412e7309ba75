"""Layer program and block stack (port of ``repro/models/transformer.py``,
the dense family's parts).

Every architecture is described by a per-layer (mixer, ffn) program,
exactly as in the reference.  The port runs the dense program
``[attn + mlp] * L`` as a plain Python loop over one ``Block`` module per
layer: PyTorch runs eagerly, so there is no scan and no stacking of
parameters over repeats (``interop.load_lm_params`` unstacks the
reference's layout).  Any other mixer or ffn raises ``NotImplementedError``.

Two blocks run the full sequence: ``apply_block`` attends through the
kernel (serving's ``Model.forward``), ``apply_train_block`` through
``_sdpa`` (``Model.loss``).  ``stack_forward`` runs either, and with
``remat`` recomputes each period's activations in the backward pass
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint`` does.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch import nn

from repro_torch.models.attention import (
    Attention,
    KVCacheSpec,
    _project_qkv,
    attend,
    decode_attention,
    kv_cache_init,
    self_attention,
    sequence_positions,
    train_self_attention,
)
from repro_torch.models.layers import RMSNorm, dense_init_, mlp, weight

# the slice of the LM scaffolding's port that brings each other family
LATER_SLICE = {"moe": "MoE", "hybrid": "hybrid/SSM", "ssm": "hybrid/SSM",
               "encdec": "encoder-decoder", "vlm": "vision-language"}


def not_ported(what: str, family: str) -> NotImplementedError:
    slice_ = LATER_SLICE.get(family, "a later")
    return NotImplementedError(
        f"{what} is not ported yet: it comes with the {slice_} slice of the LM "
        f"scaffolding; the port serves the dense family ([attn + mlp] layers)")


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str  # attn | attn_nc | mamba | rwkv | cross | self_cross
    ffn: str  # mlp | moe | rwkv_ffn


DENSE = LayerSpec("attn", "mlp")


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


def _require_dense(cfg, spec: LayerSpec) -> None:
    if spec != DENSE:
        raise not_ported(f"layer {spec} of {cfg.arch}", cfg.family)


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


class Block(nn.Module):
    """One ``("attn", "mlp")`` layer: ``norm1 attn norm2 mlp``."""

    def __init__(self, cfg, spec: LayerSpec, dtype, device):
        super().__init__()
        _require_dense(cfg, spec)
        self.norm1 = RMSNorm(cfg.d_model, dtype, device)
        self.attn = Attention(cfg, dtype, device)
        self.norm2 = RMSNorm(cfg.d_model, dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device)

    def init(self, generator: torch.Generator) -> None:
        self.attn.init(generator)
        self.mlp.init(generator)


# ---------------------------------------------------------------------------
# full sequence, prefill, decode
# ---------------------------------------------------------------------------


def apply_block(p: Block, cfg, x: torch.Tensor) -> torch.Tensor:
    """One block over the full sequence, attending through the kernel."""
    x = x + self_attention(p.attn, cfg, p.norm1(x), causal=True)
    return x + p.mlp(p.norm2(x))


def apply_train_block(p: Block, cfg, x: torch.Tensor) -> torch.Tensor:
    """One block over the full sequence, differentiable: the reference's
    ``apply_block``, attending through ``_sdpa``."""
    x = x + train_self_attention(p.attn, cfg, p.norm1(x), causal=True)
    return x + p.mlp(p.norm2(x))


# matmuls without batch dims: what jax's dots_with_no_batch_dims_saveable
# keeps (``x @ w`` of a (B, S, D) activation folds to one ``mm``)
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def stack_forward(blocks, cfg, x: torch.Tensor, block=apply_block,
                  remat: bool = False) -> torch.Tensor:
    """Run ``block`` through the stack.  With ``remat``, each period of the
    layer program runs under ``torch.utils.checkpoint``, keeping only its
    input for the backward pass (``cfg.remat_policy`` "full"), or also its
    weight matmuls' outputs ("dots")."""

    def run(x, group):
        for p in group:
            x = block(p, cfg, x)
        return x

    if not remat:
        return run(x, blocks)
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _save_dots)
    period, _ = find_period(layer_program(cfg))
    for i in range(0, len(blocks), period):
        x = checkpoint(run, x, blocks[i:i + period], use_reentrant=False, **kw)
    return x


def apply_block_prefill(p: Block, cfg, x: torch.Tensor):
    """One block over the full prompt; returns (x, {"k", "v"} (B, S, nkv, hd)).
    The reference projects q/k/v twice here (once for the cache, once inside
    its block); the port projects once, with the same numbers."""
    h = p.norm1(x)
    q, k, v = _project_qkv(p.attn, cfg, h, sequence_positions(h))
    x = x + attend(p.attn, q, k, v, causal=True)
    x = x + p.mlp(p.norm2(x))
    return x, {"k": k, "v": v}


def stack_prefill(blocks, cfg, x: torch.Tensor, caches: list):
    """Prefill through the stack; writes each layer's prompt K/V into its
    cache (in place).  Returns (x, caches)."""
    for p, c in zip(blocks, caches):
        x, contrib = apply_block_prefill(p, cfg, x)
        s = contrib["k"].shape[1]
        c["k"][:, :s] = contrib["k"].to(c["k"].dtype)
        c["v"][:, :s] = contrib["v"].to(c["v"].dtype)
    return x, caches


def apply_block_decode(p: Block, cfg, x: torch.Tensor, cache: dict, pos: int):
    """One block, one token.  Returns (x, cache)."""
    out, cache = decode_attention(p.attn, cfg, p.norm1(x), cache, pos)
    x = x + out
    return x + p.mlp(p.norm2(x)), cache


def stack_decode(blocks, cfg, x: torch.Tensor, caches: list, pos: int):
    """Decode through the stack, one cache per layer.  Returns (x, caches)."""
    for li, p in enumerate(blocks):
        x, caches[li] = apply_block_decode(p, cfg, x, caches[li], pos)
    return x, caches


def block_cache_init(cfg, spec: LayerSpec, batch: int, max_seq: int, dtype,
                     device=None) -> dict:
    _require_dense(cfg, spec)
    return kv_cache_init(KVCacheSpec(batch, max_seq, cfg.n_kv_heads, cfg.head_dim, dtype),
                         device)


def stack_cache_init(cfg, program: list[LayerSpec], batch: int, max_seq: int, dtype,
                     device=None) -> list:
    """One cache per layer, as in the reference's serving layout."""
    return [block_cache_init(cfg, spec, batch, max_seq, dtype, device) for spec in program]
