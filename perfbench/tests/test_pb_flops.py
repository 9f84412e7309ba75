"""The FLOP and byte arithmetic against closed forms worked out by hand."""
import pytest

from perfbench import flops, harness as hx

QWEN3 = hx.find_cell("qwen3_0_6b.train_4k").arch


def test_qwen3_layer_params():
    # q, o: 1,024 x 2,048 each; k, v: 1,024 x 1,024 each; SwiGLU 3 x 1,024 x 3,072
    assert flops.layer_matmul_params(QWEN3) == 2 * 1024 * 2048 + 2 * 1024 * 1024 + 3 * 1024 * 3072
    assert flops.matmul_params(QWEN3) == 28 * 15_728_640 + 1024 * 151_936


def test_qwen3_train_4k():
    f = flops.train_flops(QWEN3, 4, 4096)
    dense = 6 * (28 * 15_728_640 + 1024 * 151_936) * 16_384
    attn = 28 * 6 * 4 * 16 * 128 * 4096 ** 2
    assert f == {"dense_flops": dense, "attention_flops": attn, "flops": dense + attn}
    assert f["flops"] == pytest.approx(81.72e12, rel=1e-3)
    assert attn / f["flops"] == pytest.approx(0.2826, abs=1e-3)


def test_qwen3_prefill_8k():
    f = flops.prefill_flops(QWEN3, 16, 8192)
    dense = 2 * 28 * 15_728_640 * 16 * 8192 + 2 * 1024 * 151_936 * 16
    attn = 28 * 2 * 16 * 16 * 128 * 8192 ** 2
    assert f["flops"] == dense + attn
    assert attn / f["flops"] == pytest.approx(0.5161, abs=1e-3)


def test_b4_call_and_its_least_time():
    c = flops.attention_call(16, 8192, 16, 8, 128)
    assert c["flops"] == 2 * 16 * 16 * 8192 ** 2 * 128
    assert c["bytes"] == 2 * 16 * 8192 * 128 * (16 + 16 + 8 + 8)
    peak = {"bf16_flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12}
    assert flops.least_time(c["flops"], c["bytes"], peak) == pytest.approx(c["flops"] / 989e12)
    nc = flops.attention_call(4, 1500, 12, 12, 64, causal=False)
    assert nc["flops"] == 4 * 4 * 12 * 1500 ** 2 * 64


def test_moe_layer_counts_the_routed_and_shared_experts():
    a = hx.find_cell("qwen2_moe_a2_7b.prefill_4k").arch
    assert flops.layer_matmul_params(a) == (4 * 2048 * 2048 + 2048 * 60
                                            + (4 + 4) * 3 * 2048 * 1408)
