"""Snowflake Arctic (480B) [hf:Snowflake/snowflake-arctic-base; hf].

Dense-MoE hybrid: every layer has a 128-expert top-2 MoE *in parallel with*
a dense residual FFN.
"""
from repro_torch.configs.base import ArchConfig, register

ARCTIC_480B = register(ArchConfig(
    arch="arctic_480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab=32_000,
    n_experts=128,
    top_k=2,
    expert_d_ff=4864,
    moe_every=1,
    dense_residual=True,
    notes="largest assigned config (~0.5T params); optimizer state kept in "
          "bf16 so params+opt fit the single-pod mesh (DESIGN.md §Memory)",
))
