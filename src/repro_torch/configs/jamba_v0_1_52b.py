"""Jamba-v0.1 (52B) [arXiv:2403.19887; hf] — Mamba+attention 1:7 hybrid, MoE.

32 layers in period-8 super-blocks: one attention layer (position 4) per 7
Mamba layers; MoE (16 experts, top-2) on every second layer.
"""
from repro_torch.configs.base import ArchConfig, register

JAMBA_V0_1_52B = register(ArchConfig(
    arch="jamba_v0_1_52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65_536,
    n_experts=16,
    top_k=2,
    expert_d_ff=14336,
    moe_every=2,
    attn_period=8,
    ssm_d_state=16,
    ssm_d_conv=4,
    ssm_expand=2,
    notes="sub-quadratic (runs long_500k); attention layers use no RoPE in "
          "the original — kept RoPE for uniformity, noted in DESIGN.md",
))
