"""RWKV-6 "Finch" 1.6B [arXiv:2404.05892] — attention-free, data-dependent
per-channel decay, matrix-valued state (head dim 64)."""
from repro_torch.configs.base import ArchConfig, register

RWKV6_1_6B = register(ArchConfig(
    arch="rwkv6_1_6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,  # 2048 / 64 rwkv heads (informational; attention-free)
    n_kv_heads=32,
    d_ff=7168,
    vocab=65_536,
    rwkv_head_dim=64,
    notes="attention-free: O(1) state per token; runs long_500k",
))
