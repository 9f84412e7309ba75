"""Minitron-8B — width/depth-pruned Nemotron-4 [arXiv:2407.14679; hf]."""
from repro_torch.configs.base import ArchConfig, register

MINITRON_8B = register(ArchConfig(
    arch="minitron_8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab=256_000,
    rope_theta=10_000.0,
    notes="pruned nemotron; GQA kv=8; squared-relu FFN in the original, "
          "SwiGLU here (uniform FFN across the zoo; param count matched)",
))
