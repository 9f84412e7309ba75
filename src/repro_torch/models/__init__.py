"""LM model definitions of the port (dense, MoE, hybrid and SSM families):
``Model`` binds an ``ArchConfig`` to its weights and to forward / prefill /
decode."""
from repro_torch.models.model import Model, padded_vocab

__all__ = ["Model", "padded_vocab"]
