"""Operations and bytes of the hybrid (Jamba) cells, from shapes: the
yardstick of their prefill's FLOP share and the Mamba scan's roofline.

As ``flops.py``: a multiply-add counts two operations, and only the work
the model needs is counted (two of the routed experts a token, not the
capacity slots the experts compute empty).  ``arch`` is a configuration
file's ``arch`` block.  A layer attends where ``i % attn_period ==
attn_period // 2``, else it is a Mamba-1 mixer; its ffn is the routed
experts where ``i % moe_every == moe_every - 1``, else a dense SwiGLU.
"""
from __future__ import annotations

import math

from perfbench.flops import attention_call, causal_attention_flops, least_time  # noqa: F401


def mamba_dims(arch: dict) -> dict:
    d = arch["d_model"]
    return {"d_inner": arch.get("ssm_expand", 2) * d, "d_state": arch.get("ssm_d_state", 16),
            "dt_rank": math.ceil(d / 16)}


def layer_kinds(arch: dict) -> list:
    """(mixer, ffn) of each layer: mixer ``attn`` or ``mamba``, ffn ``moe``
    or ``mlp``."""
    period, every = arch["attn_period"], arch.get("moe_every", 1)
    return [("attn" if i % period == period // 2 else "mamba",
             "moe" if arch.get("n_experts") and i % every == every - 1 else "mlp")
            for i in range(arch["n_layers"])]


def mixer_params(arch: dict, mixer: str) -> int:
    """Weight-matrix entries a token passes through in a mixer: attention's
    q, k, v, o; Mamba's in, x, dt and out projections."""
    d = arch["d_model"]
    if mixer == "attn":
        hd = arch.get("d_head") or d // arch["n_heads"]
        return 2 * d * arch["n_heads"] * hd + 2 * d * arch["n_kv_heads"] * hd
    m = mamba_dims(arch)
    d_in, ds, r = m["d_inner"], m["d_state"], m["dt_rank"]
    return d * 2 * d_in + d_in * (r + 2 * ds) + r * d_in + d_in * d


def ffn_params(arch: dict, ffn: str) -> int:
    """A dense SwiGLU's three matrices, or the router and top-k experts'."""
    d = arch["d_model"]
    if ffn == "mlp":
        return 3 * d * arch["d_ff"]
    eff = arch.get("expert_d_ff") or arch["d_ff"]
    return d * arch["n_experts"] + arch["top_k"] * 3 * d * eff


def prefill_flops(arch: dict, batch: int, seq: int) -> dict:
    """One prefill of ``batch`` prompts of ``seq`` tokens: 2 x each layer's
    weight-matrix entries x prompt tokens, the attention layers' causal
    attention, and the last token's unembedding."""
    kinds = layer_kinds(arch)
    per_token = sum(mixer_params(arch, m) + ffn_params(arch, f) for m, f in kinds)
    dense = 2 * per_token * batch * seq
    hd = arch.get("d_head") or arch["d_model"] // arch["n_heads"]
    attn = sum(m == "attn" for m, _ in kinds) * causal_attention_flops(
        batch, seq, arch["n_heads"], hd)
    head = 2 * arch["d_model"] * arch["vocab"] * batch
    return {"dense_flops": dense + head, "attention_flops": attn, "flops": dense + attn + head}


def scan_bytes(tokens: int, d_inner: int, d_state: int, elem_bytes: int = 2) -> int:
    """The selective scan's least bytes over ``tokens`` tokens: dt, x and y
    at ``d_inner`` and B and C at ``d_state``, each read or written once in
    bf16, the state never leaving the chip; the same whatever implements
    the scan."""
    return tokens * (3 * d_inner + 2 * d_state) * elem_bytes
