"""Serving steps (port of ``repro/serve/legacy/serve_step.py``): prefill
(prompt -> cache) and decode (one token, greedy).

The reference's ``jit_serve_steps`` (meshes and shardings) waits for the
port of ``distributed/``.
"""
from __future__ import annotations

import torch

from repro_torch.models.model import Model


def make_prefill_step(model: Model):
    def prefill(batch, cache):
        return model.prefill(batch, cache)

    return prefill


def make_decode_step(model: Model):
    def decode(tokens, cache, pos):
        logits, cache = model.decode_step(tokens, cache, pos)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
        return next_tok, logits, cache

    return decode
