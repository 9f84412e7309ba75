"""Attention forward kernel (CUDA, ``csrc/attention.cu``) and its plain
version."""
from repro_torch.kernels.attention.attention import attention_fwd, attention_plain
from repro_torch.kernels.attention.ops import flash_attention

__all__ = ["attention_fwd", "attention_plain", "flash_attention"]
