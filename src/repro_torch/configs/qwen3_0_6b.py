"""Qwen3-0.6B [hf:Qwen/Qwen3-0.6B; hf] — qk_norm, GQA kv=8, head_dim=128."""
from repro_torch.configs.base import ArchConfig, register

QWEN3_0_6B = register(ArchConfig(
    arch="qwen3_0_6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=3072,
    vocab=151_936,
    d_head=128,  # qwen3 uses head_dim 128 (> d_model / n_heads)
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
))
