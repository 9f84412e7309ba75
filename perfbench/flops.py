"""Operations and bytes from shapes: the yardstick of every FLOP share and
roofline share the benchmark reports.

A multiply-add counts as two operations.  Only the work the model needs is
counted: remat's recompute, the routing's own arithmetic, the capacity
slots an expert computes empty and the vocabulary's padding are not.
``arch`` is a configuration file's ``arch`` block (the port's field names).
"""
from __future__ import annotations


def _head_dim(arch: dict) -> int:
    return arch.get("d_head") or arch["d_model"] // arch["n_heads"]


def layer_matmul_params(arch: dict) -> int:
    """Weight-matrix entries one token passes through in one layer:
    attention's q, k, v, o and the ffn (a MoE layer: the router, its top-k
    routed experts and its shared experts)."""
    d, hd = arch["d_model"], _head_dim(arch)
    attn = 2 * d * arch["n_heads"] * hd + 2 * d * arch["n_kv_heads"] * hd
    if arch.get("n_experts"):
        eff = arch.get("expert_d_ff") or arch["d_ff"]
        ffn = (d * arch["n_experts"]
               + (arch["top_k"] + arch.get("n_shared_experts", 0)) * 3 * d * eff)
    else:
        ffn = 3 * d * arch["d_ff"]
    return attn + ffn


def matmul_params(arch: dict) -> int:
    """Every layer's ``layer_matmul_params`` plus the unembedding."""
    return arch["n_layers"] * layer_matmul_params(arch) + arch["d_model"] * arch["vocab"]


def causal_attention_flops(batch: int, seq: int, n_heads: int, head_dim: int) -> int:
    """One causal attention's forward, QKᵀ and PV over the half of the
    score matrix it needs: 2·B·nq·S²·hd."""
    return 2 * batch * n_heads * seq * seq * head_dim


def train_flops(arch: dict, batch: int, seq: int) -> dict:
    """One train step (forward and backward, three times the forward): 6 x
    the weight-matrix entries a token passes through x tokens, plus the
    causal attention products of every layer."""
    tokens = batch * seq
    dense = 6 * matmul_params(arch) * tokens
    attn = 3 * arch["n_layers"] * causal_attention_flops(batch, seq, arch["n_heads"],
                                                         _head_dim(arch))
    return {"dense_flops": dense, "attention_flops": attn, "flops": dense + attn}


def prefill_flops(arch: dict, batch: int, seq: int) -> dict:
    """One prefill of ``batch`` prompts of ``seq`` tokens: 2 x the layers'
    weight-matrix entries x prompt tokens, the causal attention of every
    layer, and the last token's unembedding."""
    dense = 2 * arch["n_layers"] * layer_matmul_params(arch) * batch * seq
    attn = arch["n_layers"] * causal_attention_flops(batch, seq, arch["n_heads"],
                                                     _head_dim(arch))
    head = 2 * arch["d_model"] * arch["vocab"] * batch
    return {"dense_flops": dense + head, "attention_flops": attn,
            "flops": dense + attn + head}


def attention_call(batch: int, seq: int, n_heads: int, n_kv_heads: int, head_dim: int,
                   causal: bool = True, elem_bytes: int = 2) -> dict:
    """The attention kernel's one call: its operations (causal: half the
    score matrix) and its bytes, q, k, v read once and o written once."""
    flops = causal_attention_flops(batch, seq, n_heads, head_dim) * (1 if causal else 2)
    bytes_ = elem_bytes * batch * seq * head_dim * (2 * n_heads + 2 * n_kv_heads)
    return {"flops": flops, "bytes": bytes_}


def least_time(flops: float, bytes_: float, peak: dict) -> float:
    """The roofline's least seconds: the larger of operations over the peak
    rate and bytes over the memory bandwidth."""
    return max(flops / peak["bf16_flops_per_s"], bytes_ / peak["hbm_bytes_per_s"])
