"""Qwen1.5/2-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

60 routed experts top-4 + 4 shared experts (modelled as one fused MLP of
width 4 x 1408), MoE in every layer, MHA (kv=16).
"""
from repro_torch.configs.base import ArchConfig, register

QWEN2_MOE_A2_7B = register(ArchConfig(
    arch="qwen2_moe_a2_7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=151_936,
    qkv_bias=True,
    n_experts=60,
    top_k=4,
    n_shared_experts=4,
    expert_d_ff=1408,
    moe_every=1,
    # §Perf note: remat_policy="dots" was measured and REFUTED here (-1.4%
    # HLO FLOPs only — the batched expert matmuls are not covered by the
    # no-batch-dims save policy); kept at full remat.
))
