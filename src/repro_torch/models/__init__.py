"""LM model definitions of the port (the dense, MoE, hybrid, SSM,
encoder-decoder and vision-language families): ``Model`` binds an
``ArchConfig`` to its weights and to forward / prefill / decode."""
from repro_torch.models.model import Model, padded_vocab

__all__ = ["Model", "padded_vocab"]
