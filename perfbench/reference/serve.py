"""The served tokens' logits, worked out by the plain model: what the
check compares a served wave with.

A static wave serves ``B`` prompts of ``P`` tokens and ``n`` new tokens
each: the prompt is read whole, then each new token is fed back one
position at a time.  The model is causal, so the logits that chose the
served tokens are those of one pass over the prompt and the first ``n - 1``
served tokens, at positions ``P - 1 .. P + n - 2``.  A MoE layer routes the
prompt's tokens in groups of consecutive tokens at the configured
capacity factor, and each later position's ``B`` tokens, one from each
prompt, as one group at the serving factor ``max(factor, 2)``, as the
configuration serves them.
"""
from __future__ import annotations

import torch

from .model import Groups, RefLM, group_size

DECODE_MIN_FACTOR = 2.0


def serve_groups(b: int, p: int, n: int, factor: float, device) -> Groups:
    length = p + n - 1
    prompt = (torch.arange(b, device=device)[:, None] * length
              + torch.arange(p, device=device)[None, :]).reshape(-1)
    g = group_size(prompt.numel())
    parts = [(prompt.reshape(-1, g), factor)]
    for j in range(n - 1):
        parts.append(((torch.arange(b, device=device) * length + p + j)[None, :],
                      max(factor, DECODE_MIN_FACTOR)))
    return Groups(parts)


@torch.no_grad()
def served_logits(arch: dict, weights: dict, prompts: torch.Tensor, served: torch.Tensor,
                  precision: str = "f32", pairs: dict | None = None) -> torch.Tensor:
    """Logits (B, n, vocab) in float32 of the positions that chose each of
    the ``served`` (B, n) tokens after ``prompts`` (B, P).  ``pairs``
    ({capacity factor: [routed, dropped]}) gathers the MoE's pair counts."""
    b, p = prompts.shape
    n = served.shape[1]
    lm = RefLM(arch, weights, precision)
    if pairs is not None:
        lm.pairs = pairs
    tokens = torch.cat([prompts, served[:, :-1]], dim=1).long()
    groups = serve_groups(b, p, n, arch.get("moe_capacity_factor", 1.25), tokens.device)
    x = lm.embed(tokens)
    for i in range(arch["n_layers"]):
        x = lm.block(i, x, groups)[0]
    return lm.logits(x[:, p - 1:])


def token_gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's logit lies below the best logit at its
    position: (B, n)."""
    return logits.max(-1).values - logits.gather(-1, tokens.long()[..., None])[..., 0]
