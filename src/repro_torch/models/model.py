"""Model-level API for training and serving (port of
``repro/models/model.py``, every family).

``Model(cfg, device=None)`` is an ``nn.Module`` that holds its weights,
named as the reference's parameter pytree (``embed.tok``, ``embed.head``,
``blocks.<layer>.{norm1,attn|mixer,norm_cross,cross,norm2,mlp|moe|ffn}.*``,
``final_norm.scale``, and for whisper the encoder's
``enc.blocks.<layer>.*`` and ``enc.final_norm.scale``).  It is allocated on
``device`` (``None``: the CUDA card, raising without one) and filled by
``init(generator)`` or by ``interop.load_lm_params``.  Batches are dicts
``{"tokens": (B, S) int, "labels": (B, S) int, ["mask"]}``, as in the
reference, with the stub front ends' precomputed embeddings at model
width: ``"enc_frames"`` (B, n_frames, D) for the encoder-decoder family,
``"img_embeds"`` (B, n_img_tokens, D) for the vision-language one
(``context_input``).  Their context, the encoder's output or the image
embeddings, is ``kv_src``: prefill puts it in the cache and decode reads
it there.  Decode takes ``tokens (B, 1)``, the cache and one position for
the whole batch.

``loss`` is differentiable: it attends through ``train_self_attention``
under remat (the training kernels on the card in bf16, else ``_sdpa`` as the
reference trains), and adds the MoE aux losses of a config with
experts.  ``forward``, ``prefill`` and ``decode_step`` run under
``torch.no_grad()`` and self-attend through the kernel (the encoder's
non-causal layers too), so serving builds no autograd graph although the
weights are trainable.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch import obs
from repro_torch.distributed.context import constrain
from repro_torch.kernels._platform import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (
    RMSNorm,
    dense_init_,
    dtype_of,
    embed,
    embed_init_,
    softmax_xent,
    unembed,
    weight,
)

LB_LOSS_WEIGHT = 0.01
Z_LOSS_WEIGHT = 1e-3
VOCAB_ALIGN = 256  # the reference pads the vocab for its sharding; kept for parity


def padded_vocab(vocab: int) -> int:
    return -(-vocab // VOCAB_ALIGN) * VOCAB_ALIGN


def context_input(cfg) -> tuple[str, int] | None:
    """The batch key of the stub front end's embeddings and their length
    (``enc_frames`` and ``n_frames``, or ``img_embeds`` and
    ``n_img_tokens``), or None for a text-only config."""
    if cfg.n_enc_layers:
        return "enc_frames", cfg.n_frames
    if cfg.cross_attn_every:
        return "img_embeds", cfg.n_img_tokens
    return None


class Embedding(nn.Module):
    """``tok`` (vocab_padded, d) and, untied, ``head`` (d, vocab_padded)."""

    def __init__(self, vocab: int, d: int, tie: bool, dtype, device):
        super().__init__()
        self.tok = weight(vocab, d, dtype=dtype, device=device)
        self.head = None if tie else weight(d, vocab, dtype=dtype, device=device)


class Encoder(nn.Module):
    """Whisper's encoder stack: ``blocks`` (non-causal self-attention + MLP)
    and ``final_norm``, the reference's ``params["enc"]``."""

    def __init__(self, cfg, program: list[tf.LayerSpec], dtype, device):
        super().__init__()
        self.blocks = nn.ModuleList(tf.Block(cfg, spec, dtype, device) for spec in program)
        self.final_norm = RMSNorm(cfg.d_model, dtype, device)


class Model(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        dtype = dtype_of(cfg.dtype)
        self.embed = Embedding(self.vocab_padded, cfg.d_model, cfg.tie_embeddings,
                               dtype, self.device)
        self.blocks = nn.ModuleList(tf.Block(cfg, spec, dtype, self.device)
                                    for spec in self.program)
        self.final_norm = RMSNorm(cfg.d_model, dtype, self.device)
        self.enc = (Encoder(cfg, self.enc_program, dtype, self.device)
                    if cfg.n_enc_layers else None)

    # ---- structure ----

    @property
    def dtype(self) -> torch.dtype:
        return dtype_of(self.cfg.dtype)

    @property
    def program(self) -> list[tf.LayerSpec]:
        return tf.layer_program(self.cfg)

    @property
    def enc_program(self) -> list[tf.LayerSpec]:
        return [tf.LayerSpec("attn_nc", "mlp")] * self.cfg.n_enc_layers

    @property
    def vocab_padded(self) -> int:
        return padded_vocab(self.cfg.vocab)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Random weights with the reference's distributions (fan-in
        truncated normal, embedding normal x 0.01, unit norms, zero biases),
        drawn from ``generator`` on its device.  Returns the model."""
        embed_init_(self.embed.tok, generator)
        if self.embed.head is not None:
            dense_init_(self.embed.head, generator)
        for blk in self.blocks:
            blk.init(generator)
        for blk in self.enc.blocks if self.enc is not None else ():
            blk.init(generator)
        for name, p in self.named_parameters():
            if name.endswith(".scale"):
                p.fill_(1.0)
            elif name.rsplit(".", 1)[-1] in ("bq", "bk", "bv"):
                p.zero_()
        return self

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device)

    def _embed(self, tokens) -> torch.Tensor:
        return constrain(embed(self.embed.tok, self._tokens(tokens)).to(self.dtype), "btd")

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = self.final_norm(x)
        logits = constrain(unembed(x, self.embed.tok, self.embed.head), "logits")
        return _mask_padded_vocab(logits, self.cfg.vocab)

    def _context(self, batch: dict, block=tf.apply_block, remat: bool = False) -> dict:
        """``{"kv_src": (B, T, D)}`` in the compute dtype: the encoder stack
        over ``enc_frames`` then its final norm, or ``img_embeds``; ``{}``
        for a text-only config."""
        spec = context_input(self.cfg)
        if spec is None:
            return {}
        src = torch.as_tensor(batch[spec[0]], device=self.device).to(self.dtype)
        if self.enc is not None:
            x, _ = tf.stack_forward(self.enc.blocks, self.cfg, src, {}, block=block, remat=remat)
            src = self.enc.final_norm(x)
        return {"kv_src": src}

    # ---- forward ----

    @torch.no_grad()
    def forward(self, batch: dict) -> torch.Tensor:
        """Logits (B, S, vocab_padded) in the compute dtype, through the
        attention kernel."""
        x, _ = tf.stack_forward(self.blocks, self.cfg, self._embed(batch["tokens"]),
                                self._context(batch))
        return self._logits(x)

    # ---- training ----

    def _train_stack(self, batch: dict):
        remat = self.cfg.remat
        ctx = self._context(batch, block=tf.apply_train_block, remat=remat)
        x, aux = tf.stack_forward(self.blocks, self.cfg, self._embed(batch["tokens"]), ctx,
                                  block=tf.apply_train_block, remat=remat)
        return self._logits(x), aux

    def train_forward(self, batch: dict) -> torch.Tensor:
        """Logits (B, S, vocab_padded) in the compute dtype through the
        training path: ``train_self_attention``, remat as ``cfg.remat`` says.
        Differentiable."""
        return self._train_stack(batch)[0]

    def loss(self, batch: dict):
        """Mean next-token cross-entropy, plus ``0.01 * moe_lb_loss + 1e-3 *
        moe_z_loss`` with experts.  Returns (loss, {"ce", "moe_lb_loss",
        "moe_z_loss"}); the aux losses are zeros without experts, as in the
        reference."""
        with obs.span("model.forward", device=self.device):
            logits, aux = self._train_stack(batch)
            mask = batch.get("mask")
            ce = softmax_xent(logits, self._tokens(batch["labels"]),
                              None if mask is None else self._tokens(mask))
            loss = ce
            if self.cfg.n_experts:
                loss = (loss + LB_LOSS_WEIGHT * aux["moe_lb_loss"]
                        + Z_LOSS_WEIGHT * aux["moe_z_loss"])
            return loss, {"ce": ce, **aux}

    # ---- serving ----

    def init_cache(self, batch: int, max_seq: int, device=None) -> dict:
        """One cache per layer: K/V for self-attention, the f32 recurrent
        state for mamba and rwkv; with a context, ``kv_src`` (B, T, D)
        zeros that prefill replaces.  On the model's device unless
        ``device`` says otherwise (``"meta"``: shapes only)."""
        device = self.device if device is None else torch.device(device)
        cache = {"blocks": tf.stack_cache_init(self.cfg, self.program, batch, max_seq,
                                               self.dtype, device)}
        spec = context_input(self.cfg)
        if spec is not None:
            cache["kv_src"] = torch.zeros(batch, spec[1], self.cfg.d_model, dtype=self.dtype,
                                          device=device)
        return cache

    @torch.no_grad()
    def prefill(self, batch: dict, cache: dict):
        """Run the full prompt, fill the cache (prompt K/V, final SSM states
        and ``kv_src``); returns (last_logits (B, 1, vocab_padded), cache)."""
        with obs.span("model.prefill", device=self.device):
            ctx = self._context(batch)
            x, blocks = tf.stack_prefill(self.blocks, self.cfg, self._embed(batch["tokens"]),
                                         cache["blocks"], ctx)
            return self._logits(x[:, -1:, :]), dict(cache, blocks=blocks, **ctx)

    @torch.no_grad()
    def decode_step(self, tokens, cache: dict, pos: int):
        """One token for the whole batch, cross-attending over the cache's
        ``kv_src``.  tokens: (B, 1); pos: int."""
        with obs.span("model.decode_step", device=self.device):
            ctx = {"kv_src": cache["kv_src"]} if "kv_src" in cache else {}
            x, blocks = tf.stack_decode(self.blocks, self.cfg, self._embed(tokens),
                                        cache["blocks"], int(pos), ctx)
            return self._logits(x), dict(cache, blocks=blocks)


def _mask_padded_vocab(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    if logits.shape[-1] == vocab:
        return logits
    pad = logits.shape[-1] - vocab
    bias = torch.cat([torch.zeros(vocab, dtype=logits.dtype, device=logits.device),
                      torch.full((pad,), -1e30, dtype=logits.dtype, device=logits.device)])
    return logits + bias
