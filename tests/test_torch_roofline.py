"""The port's roofline instrument (``repro_torch/roofline``) on
hand-countable programs, and its terms against the JAX package's.

The reference validates its HLO analyzer in ``tests/test_roofline.py``;
these are those cases for the op counter, which counts eager aten ops:
exact matmul FLOPs; a Python loop of N matmuls counts N of them (eager
execution has no loops to multiply); a sharded contraction on a fake
process group of 8 counts one all-reduce of the output's bytes; an
in-place slice write counts the slice, not the buffer; ``top_ops`` orders
by value.  ``roofline_terms`` and ``model_flops`` give the reference's
numbers for the same hardware constants, and the attention op's formula is
counted.
"""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro.configs.base import get_arch as ref_get_arch
from repro.roofline import analysis as ref_analysis
from repro_torch.configs.base import get_arch
from repro_torch.kernels._platform import LAUNCHES
from repro_torch.kernels.attention.attention import attention_flops, attention_fwd
from repro_torch.roofline.analysis import HW, HardwareSpec, model_flops, roofline_terms
from repro_torch.roofline.counter import OpCounter, analyze

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def test_single_matmul_flops_exact():
    a, b = torch.randn(64, 256), torch.randn(256, 32)
    assert analyze(lambda: a @ b)["flops"] == 2 * 64 * 32 * 256


def test_a_loop_of_matmuls_counts_each():
    x = torch.randn(128, 128)

    def loop():
        y = x
        for _ in range(8):
            y = y @ x
        return y

    a = analyze(loop)
    assert a["flops"] == 8 * 2 * 128 ** 3
    assert a["n_loops"] == 0


def test_in_place_slice_write_counts_the_slice_not_the_buffer():
    buf, upd = torch.zeros(1024, 1024), torch.randn(1, 1024)
    with OpCounter() as c:
        buf[7:8] = upd
    # copy_ reads the update and the slice and writes the slice
    assert c.bytes == 3 * 1024 * 4
    assert c.flops == 0


def test_top_ops_orders_by_value():
    x, w = torch.randn(256, 256), torch.randn(256, 64)
    with OpCounter() as c:
        for _ in range(4):
            y = x @ x
        z = (y + 1.0) @ w
    rows = c.top_ops(k=5, by="flops")
    assert [r["op"] for r in rows] == ["mm"]
    assert rows[0]["count"] == 5 and rows[0]["value"] == 4 * 2 * 256 ** 3 + 2 * 256 * 64 * 256
    assert c.top_shapes(k=5) == [
        {"value": 4 * 2 * 256 ** 3, "op": "mm", "shapes": [(256, 256), (256, 256)], "count": 4},
        {"value": 2 * 256 * 64 * 256, "op": "mm", "shapes": [(256, 256), (256, 64)], "count": 1}]
    traffic = c.top_ops(k=5, by="traffic")
    assert traffic[0]["value"] >= traffic[-1]["value"]
    assert {r["op"] for r in traffic} == {"mm", "add"}
    assert z.shape == (256, 64)


def test_live_bytes_follow_the_tensors():
    with OpCounter(track_memory=True) as c:
        a = torch.ones(1024)  # 4 KiB
        b = a * 2
        view = b[:10]  # a view adds no storage
        del a
    assert c.peak_bytes == 2 * 4096
    assert c.live_bytes == 4096
    del b, view
    assert c.live_bytes == 0


def test_collectives_counted_on_a_fake_group():
    """A contraction sharded over 8 ranks: each computes 1/8 of the FLOPs
    and the (64, 32) f32 output is all-reduced."""
    code = textwrap.dedent("""
        import torch, torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import Shard, distribute_tensor
        from repro_torch.roofline.counter import OpCounter
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
        mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("m",))
        x = distribute_tensor(torch.randn(64, 256), mesh, [Shard(1)], src_data_rank=None)
        w = distribute_tensor(torch.randn(256, 32), mesh, [Shard(0)], src_data_rank=None)
        with OpCounter() as c:
            out = (x @ w).full_tensor()
        a = c.analysis()
        assert a["flops"] == 2 * 64 * 32 * 32, a["flops"]
        assert a["collective_bytes"] == 64 * 32 * 4, a
        assert a["collectives_by_op"] == {"all-reduce": 64 * 32 * 4}, a
        assert out.shape == (64, 32)
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "OK" in out.stdout


def test_attention_op_counts_its_formula_and_launches_nothing_on_the_cpu():
    from torch._subclasses.fake_tensor import FakeTensorMode

    assert attention_flops((2, 16, 4, 32), None, None, True) == 4 * 2 * 4 * 16 * 16 * 32 // 2
    assert attention_flops((2, 16, 4, 32), None, None, False) == 4 * 2 * 4 * 16 * 16 * 32
    before = dict(LAUNCHES)
    with FakeTensorMode():
        q, kv = torch.empty(2, 16, 4, 32), torch.empty(2, 16, 2, 32)
        with OpCounter() as c:
            out = torch.ops.repro_torch.flash_attention(q, kv, kv, True)
    assert out.shape == q.shape and c.flops == 4 * 2 * 4 * 16 * 16 * 32 // 2
    # a plain CPU tensor takes the plain version, which autograd differentiates
    q = torch.randn(1, 8, 2, 32, requires_grad=True)
    k = torch.randn(1, 8, 1, 32)
    attention_fwd(q, k, k, causal=True).sum().backward()
    assert q.grad is not None and dict(LAUNCHES) == before
    with OpCounter() as c:  # and is counted as the ops it is made of
        attention_fwd(q.detach(), k, k, causal=False)
    assert c.flops == 4 * 1 * 2 * 8 * 8 * 32


def test_roofline_terms_match_reference():
    ref_hw = ref_analysis.HW
    hw = HardwareSpec(name=ref_hw.name, peak_flops=ref_hw.peak_flops, hbm_bw=ref_hw.hbm_bw,
                      link_bw=ref_hw.ici_bw)
    for args in ((197e12, 0.0, 0.0), (0.0, 819e9, 100e9), (3e12, 5e9, 1e9)):
        assert roofline_terms(*args, hw=hw) == ref_analysis.roofline_terms(*args)
    t = roofline_terms(HW.peak_flops, 0.0, 0.0)
    assert t["dominant"] == "compute" and abs(t["compute_s"] - 1.0) < 1e-12
    assert (HW.peak_flops, HW.hbm_bw, HW.link_bw) == (989e12, 3.35e12, 450e9)


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "arctic_480b", "qwen2_moe_a2_7b"])
@pytest.mark.parametrize("kind", ["train", "inference"])
def test_model_flops_match_reference(arch, kind):
    assert model_flops(get_arch(arch), 1_000_000, kind) == \
        ref_analysis.model_flops(ref_get_arch(arch), 1_000_000, kind)
