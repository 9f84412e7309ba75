"""Serving steps (port of ``repro/serve/legacy/serve_step.py``): prefill
(prompt -> cache) and decode (one token, greedy), and ``jit_serve_steps``,
both sharded on a mesh (DTensor).  Caches are sequence-sharded over the
"model" axis (context-parallel decode) and batch-sharded over the DP axes.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.context import replicate_dim, whole
from repro_torch.models.model import Model


def make_prefill_step(model: Model):
    def prefill(batch, cache):
        return model.prefill(batch, cache)

    return prefill


def make_decode_step(model: Model):
    def decode(tokens, cache, pos):
        logits, cache = model.decode_step(tokens, cache, pos)
        # a vocab-sharded DTensor is gathered along the vocab for the argmax
        next_tok = torch.argmax(replicate_dim(logits[:, -1, :], -1), dim=-1)
        next_tok = next_tok.to(torch.int32)[:, None]
        return next_tok, logits, cache

    return decode


def jit_serve_steps(model: Model, mesh, batch: int, max_seq: int, batch_example=None):
    """Prefill and decode sharded on ``mesh``.  Replaces each of ``model``'s
    parameters, in place, by a DTensor placed by ``param_specs``.  Returns
    ``(prefill, decode, cache_placements)``: ``prefill(batch, cache) ->
    (logits, cache)`` and ``decode(tokens, cache, pos) -> (next_tok,
    logits, cache)`` take the whole batch and a cache on every rank, place
    them (the cache by ``cache_specs``, once: a cache they return is placed
    already) and return the logits and tokens as plain tensors, the same on
    every rank.  ``batch_example`` (a dict of arrays of the prefill batch's
    shapes) pins the prefill batch's placements; by default they follow
    the batch size."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.context import ActivationPolicy, activation_policy

    shd.place_parameters(model, mesh, shd.param_specs(model, mesh))
    cache_pl = shd.shardings(mesh, shd.cache_specs(mesh, model.init_cache(batch, max_seq,
                                                                          device="meta")))
    b = shd.effective_batch_axes(mesh, batch) or None
    tok_pl = shd.placements(mesh, shd.P(b, None))
    pol = ActivationPolicy(mesh, b)
    prefill_fn = make_prefill_step(model)
    decode_fn = make_decode_step(model)

    def place_batch(batch_: dict) -> dict:
        example = batch_example if batch_example is not None else batch_
        pls = shd.shardings(mesh, shd.batch_specs(mesh, example))
        return {k: shd.place(torch.as_tensor(v, device=model.device), mesh, pls[k])
                for k, v in batch_.items()}

    def prefill(batch_: dict, cache: dict):
        cache = shd.place_tree(cache, mesh, cache_pl)
        with activation_policy(pol), implicit_replication():
            logits, cache = prefill_fn(place_batch(batch_), cache)
        return whole(logits), cache

    def decode(tokens, cache: dict, pos: int):
        cache = shd.place_tree(cache, mesh, cache_pl)
        tokens = shd.place(torch.as_tensor(tokens, device=model.device), mesh, tok_pl)
        with activation_policy(pol), implicit_replication():
            next_tok, logits, cache = decode_fn(tokens, cache, pos)
        return whole(next_tok), whole(logits), cache

    return prefill, decode, cache_pl

