"""Qwen2-7B [arXiv:2407.10671; hf] — GQA kv=4, QKV bias."""
from repro_torch.configs.base import ArchConfig, register

QWEN2_7B = register(ArchConfig(
    arch="qwen2_7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    notes="28 heads do not divide the 16-way model axis; GSPMD pads the "
          "head dim (see DESIGN.md §Sharding)",
))
