"""Llama-3.2-Vision-90B [hf:meta-llama/Llama-3.2-90B-Vision] — text backbone
with cross-attention image layers every 5th layer; the vision tower is a
STUB per the assignment (input_specs provides 1601 patch embeddings)."""
from repro_torch.configs.base import ArchConfig, register

LLAMA3_2_VISION_90B = register(ArchConfig(
    arch="llama3_2_vision_90b",
    family="vlm",
    n_layers=100,  # 80 self-attention + 20 cross-attention layers
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128_256,
    cross_attn_every=5,
    n_img_tokens=1601,
    rope_theta=500_000.0,
))
