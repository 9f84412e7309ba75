"""Whisper-small [arXiv:2212.04356] — encoder-decoder; conv audio frontend
is a STUB per the assignment (input_specs provides precomputed 1500-frame
embeddings at model width)."""
from repro_torch.configs.base import ArchConfig, register

WHISPER_SMALL = register(ArchConfig(
    arch="whisper_small",
    family="encdec",
    n_layers=12,  # decoder layers
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51_865,
    n_enc_layers=12,
    n_frames=1500,
    notes="original uses learned absolute positions + LayerNorm; this zoo "
          "uses RoPE + RMSNorm uniformly (DESIGN.md §Adaptations)",
))
