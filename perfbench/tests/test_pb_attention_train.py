"""The readers of training's attention kernels, ``train.attention_kernel_pct``
and ``train.attention_roofline_pct``: each on a synthetic record and
snapshot against the value worked out by hand, and None where there is
nothing to read (a program without the counters, a trace without the
kernels, a serving record, no peak)."""
import sys

import pytest

from perfbench import harness as hx

PEAK = {"bf16_flops_per_s": 1000e12, "hbm_bytes_per_s": 4e12}
# two calls a step over 2 profiled steps: forward and remat's recompute
# each call, one backward (dsum, dq, dkdv) each call
FWD = "void attention_fwd_lse_bf16_kernel<128, true>"
OPS = ([(FWD, 0.0, 100.0)] * 8
       + [("void attention_bwd_dsum_kernel<128>", 0.0, 10.0),
          ("void attention_bwd_dq_bf16_kernel<128, true>", 0.0, 150.0),
          ("void attention_bwd_dkdv_bf16_kernel<128, true>", 0.0, 200.0)] * 4
       + [("nvjet_tst_256x128_h_bz_NNT", 0.0, 500.0),
          ("void attention_fwd_bf16_kernel<128, true>", 0.0, 700.0)])
TRACE = {"device_ops": OPS, "spans": [], "host_ops": [], "window": (0.0, 5000.0)}
TRAIN = {"kind": "train", "trace": TRACE}
# a call: 40 GFLOP and 4 MB forward, so its operations bound it
COUNTERS = {"attention.train_calls": {"train_step": 4},
            "attention.train_kernel": {"train_step": 4},
            "attention.train_kernel_flops": {"train_step": 4 * 40_000_000_000},
            "attention.train_kernel_bytes": {"train_step": 4 * 4_000_000}}


@pytest.fixture
def snap(monkeypatch):
    from repro_torch import obs

    def use(counters):
        monkeypatch.setattr(obs, "snapshot", lambda: {"records": [], "counters": counters})
    return use


def read(metric, rec, peak=PEAK):
    return hx.reader(metric).read(rec, peak)


def test_kernel_share(snap):
    snap(COUNTERS)
    assert read("train.attention_kernel_pct", TRAIN) == pytest.approx(100.0)
    snap(dict(COUNTERS, **{"attention.train_kernel": {"train_step": 1}}))
    assert read("train.attention_kernel_pct", TRAIN) == pytest.approx(25.0)
    snap({"attention.train_calls": {"train_step": 4}})
    assert read("train.attention_kernel_pct", TRAIN) == 0.0


def test_roofline_share(snap):
    snap(COUNTERS)
    # 8 forwards at 40 us (40 GFLOP at 1,000 TFLOP/s; 4 MB take 1 us) and 4
    # backwards at 100 us (100 GFLOP; 8 MB) over 8 x 100 + 4 x 360 us
    assert read("train.attention_roofline_pct", TRAIN) == pytest.approx(
        100 * (8 * 40 + 4 * 100) / (8 * 100 + 4 * 360))


def test_roofline_share_where_bytes_bound_the_calls(snap):
    snap(dict(COUNTERS, **{"attention.train_kernel_bytes": {"train_step": 4 * 400_000_000}}))
    # forward 400 MB at 4 TB/s is 100 us; backward 800 MB is 200 us
    assert read("train.attention_roofline_pct", TRAIN) == pytest.approx(
        100 * (8 * 100 + 4 * 200) / (8 * 100 + 4 * 360))


@pytest.mark.parametrize("metric", ["train.attention_kernel_pct", "train.attention_roofline_pct"])
def test_nothing_to_read_is_none(metric, snap, monkeypatch):
    snap(COUNTERS)
    assert read(metric, {"kind": "serve", "trace": TRACE}) is None
    snap({})
    assert read(metric, TRAIN) is None
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)  # a program without obs.py
    assert read(metric, TRAIN) is None


def test_roofline_share_without_the_kernels_or_a_peak_is_none(snap):
    snap(COUNTERS)
    bare = dict(TRACE, device_ops=[op for op in OPS if "attention_bwd" not in op[0]
                                   and "lse" not in op[0]])
    assert read("train.attention_roofline_pct", {"kind": "train", "trace": bare}) is None
    assert read("train.attention_roofline_pct", TRAIN, peak=None) is None
    snap(dict(COUNTERS, **{"attention.train_kernel": {"train_step": 0}}))
    assert read("train.attention_roofline_pct", TRAIN) is None
