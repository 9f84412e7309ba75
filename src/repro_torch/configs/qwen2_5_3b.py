"""Qwen2.5-3B [hf:Qwen/Qwen2.5-3B; hf] — GQA kv=2, QKV bias, tied embeddings."""
from repro_torch.configs.base import ArchConfig, register

QWEN2_5_3B = register(ArchConfig(
    arch="qwen2_5_3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11008,
    vocab=151_936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
))
