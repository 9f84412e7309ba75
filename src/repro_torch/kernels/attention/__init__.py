"""Attention kernels (CUDA, ``csrc/attention.cu``): the forward, and the
training forward with its backward, beside their plain versions."""
from repro_torch.kernels.attention.attention import (
    attention_bwd_plain,
    attention_fwd,
    attention_lse_plain,
    attention_plain,
    attention_train,
)
from repro_torch.kernels.attention.ops import flash_attention, flash_attention_train

__all__ = ["attention_bwd_plain", "attention_fwd", "attention_lse_plain", "attention_plain",
           "attention_train", "flash_attention", "flash_attention_train"]
