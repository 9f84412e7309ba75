"""Architecture configurations of the LM zoo (port of ``repro/configs/base.py``).

Plain data, copied from the reference field for field: every architecture
is one ``ArchConfig`` registered by its own module
(``repro_torch/configs/<id>.py``), with the published widths and depth.
``reduced()`` yields the small same-family config of the CPU tests.  The
port serves the dense, MoE, hybrid and SSM families (``repro_torch.models``);
the encoder-decoder and vision-language configs are here so that every
field stays comparable with the reference.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# The assigned input-shape set for LM-family transformers.
SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch: str
    family: str  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 -> d_model // n_heads
    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    expert_d_ff: int = 0
    moe_every: int = 1  # a MoE layer every `moe_every` layers (jamba: 2)
    dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    moe_capacity_factor: float = 1.25
    # hybrid (jamba): one attention layer per `attn_period` layers, rest SSM
    attn_period: int = 0  # 0 -> pure attention stack
    ssm_d_state: int = 16
    ssm_d_conv: int = 4
    ssm_expand: int = 2
    # rwkv
    rwkv_head_dim: int = 64
    # encoder-decoder (whisper): decoder uses n_layers above
    n_enc_layers: int = 0
    n_frames: int = 1500  # stub audio frontend: precomputed frame embeddings
    # vlm: cross-attention image layers inserted every `cross_attn_every`
    cross_attn_every: int = 0
    n_img_tokens: int = 1601  # stub vision frontend: precomputed patch embeds
    # execution
    dtype: str = "bfloat16"
    fsdp: bool = False  # shard params/opt-state over the data axis (ZeRO-3)
    remat: bool = True
    # "full": recompute everything in backward (min memory);
    # "dots": save matmul outputs, recompute elementwise only (§Perf: cuts
    # the recompute FLOPs of the expert/projection matmuls ~1.5x at the
    # cost of storing per-layer activations)
    remat_policy: str = "full"
    notes: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this arch serve 500k-token contexts (paper-assigned rule:
        run long_500k only for SSM / hybrid / linear-attention archs)?"""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have an autoregressive decoder

    def shape_applicable(self, shape: str) -> tuple[bool, str]:
        s = SHAPES[shape]
        if s.name == "long_500k" and not self.subquadratic:
            return False, "long_500k needs sub-quadratic attention (skip: full-attention arch)"
        if s.kind == "decode" and not self.has_decoder:
            return False, "encoder-only arch has no decode step"
        return True, ""

    def param_count(self) -> int:
        """Total parameters (embedding + layers), for MODEL_FLOPS."""
        d, h = self.d_model, self.head_dim
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        att = d * (self.n_heads * h) + 2 * d * (self.n_kv_heads * h) + (self.n_heads * h) * d
        if self.qkv_bias:
            att += (self.n_heads + 2 * self.n_kv_heads) * h
        mlp_dense = 3 * d * self.d_ff  # SwiGLU
        per_layer_norms = 2 * d
        total = emb
        n_attn, n_ssm, n_cross = self._layer_mix()
        # ssm layer params (mamba block)
        d_in = self.ssm_expand * d
        ssm = d * d_in * 2 + d_in * self.ssm_d_conv + d_in * (2 * self.ssm_d_state + 2) + d_in * d
        if self.family == "ssm":  # rwkv6: time-mix + channel-mix approx
            ssm = 4 * d * d + 2 * d * self.d_ff
        moe_layers = 0
        dense_layers = 0
        for li in range(self.n_layers):
            if self.n_experts and (li % self.moe_every == self.moe_every - 1):
                moe_layers += 1
            else:
                dense_layers += 1
        eff = self.expert_d_ff or self.d_ff
        moe = self.n_experts * 3 * d * eff + self.n_shared_experts * 3 * d * eff + d * self.n_experts
        if self.dense_residual:
            moe += mlp_dense
        total += n_attn * (att + per_layer_norms) + n_ssm * (ssm + per_layer_norms)
        total += n_cross * (att + per_layer_norms)
        total += moe_layers * moe + dense_layers * mlp_dense
        if self.n_enc_layers:
            total += self.n_enc_layers * (att + mlp_dense + per_layer_norms)
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        eff = self.expert_d_ff or self.d_ff
        full_moe = self.n_experts * 3 * d * eff
        active_moe = (self.top_k + self.n_shared_experts) * 3 * d * eff
        moe_layers = sum(
            1 for li in range(self.n_layers) if li % self.moe_every == self.moe_every - 1
        )
        return int(self.param_count() - moe_layers * (full_moe - active_moe)
                   + moe_layers * 0)

    def _layer_mix(self) -> tuple[int, int, int]:
        """(attention layers, ssm layers, cross-attn layers) in the stack."""
        if self.family == "ssm":
            return 0, self.n_layers, 0
        if self.family == "hybrid":
            n_attn = self.n_layers // self.attn_period
            return n_attn, self.n_layers - n_attn, 0
        if self.family == "vlm":
            n_cross = self.n_layers // self.cross_attn_every
            return self.n_layers - n_cross, 0, n_cross
        return self.n_layers, 0, 0

    def reduced(self) -> "ArchConfig":
        """Same-family tiny config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            n_layers=max(2, min(4, self.n_layers)),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(max(1, self.n_kv_heads * 4 // max(self.n_heads, 1)), 4) or 1,
            d_head=32,
            d_ff=256,
            vocab=512,
            n_experts=min(self.n_experts, 8),
            expert_d_ff=64 if self.expert_d_ff else 0,
            n_enc_layers=2 if self.n_enc_layers else 0,
            n_frames=16 if self.n_enc_layers else self.n_frames,
            cross_attn_every=2 if self.cross_attn_every else 0,
            n_img_tokens=8 if self.cross_attn_every else self.n_img_tokens,
            attn_period=min(self.attn_period, 2) if self.attn_period else 0,
            dtype="float32",
            fsdp=False,
        )


ARCH_IDS = [
    "minitron_8b",
    "qwen2_7b",
    "qwen2_5_3b",
    "qwen3_0_6b",
    "jamba_v0_1_52b",
    "qwen2_moe_a2_7b",
    "arctic_480b",
    "rwkv6_1_6b",
    "whisper_small",
    "llama3_2_vision_90b",
]

ARCH_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    ARCH_REGISTRY[cfg.arch] = cfg
    return cfg


def get_arch(arch_id: str) -> ArchConfig:
    norm = arch_id.replace("-", "_").replace(".", "_")
    if norm not in ARCH_IDS:
        # tolerate e.g. "llama-3.2-vision-90b" vs module "llama3_2_vision_90b"
        squashed = norm.replace("_", "")
        matches = [a for a in ARCH_IDS if a.replace("_", "") == squashed]
        if matches:
            norm = matches[0]
    if norm not in ARCH_REGISTRY:
        importlib.import_module(f"repro_torch.configs.{norm}")
    return ARCH_REGISTRY[norm]


def list_archs() -> list[str]:
    return list(ARCH_IDS)
