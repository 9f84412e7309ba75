"""Each per-layer metric's reader on a synthetic record, against the value
worked out by hand; and the trace's reduction."""
import pytest

from perfbench import harness as hx

PEAK = {"bf16_flops_per_s": 1000e12, "hbm_bytes_per_s": 4e12}
# (name, start_us, end_us): two products, a softmax, the attention kernel
OPS = [("nvjet_tst_256x128_h_bz_NNT", 0.0, 400.0), ("ampere_sgemm_128x64", 500.0, 600.0),
       ("cunn_SoftMaxForward", 600.0, 700.0),
       ("void (anonymous namespace)::attention_fwd_bf16_kernel<128, true>", 800.0, 1000.0)]
TRACE = {"device_ops": OPS, "spans": [("train.step", 0.0, 1100.0)],
         "host_ops": [("aten::mm", 390.0, 560.0)], "window": (0.0, 1200.0)}
TRAIN = {"kind": "train", "trace": TRACE, "step_s": 2.0, "profiled_steps": 2,
         "step_flops": 1e11, "fwd_bwd_s": 1.5, "optimizer_s": 0.25}
CALL = {"count": 28, "flops": 1e9, "bytes": 2e6}
SERVE = {"kind": "serve", "trace": TRACE, "prefill_s": 1.0, "prefill_flops": 200e12,
         "decode_step_s": 0.05, "attention_calls": [CALL]}


def read(metric, rec):
    return hx.reader(metric).read(rec, PEAK)


def test_train_readers():
    assert read("train.mfu_pct", TRAIN) == pytest.approx(100 * 1e11 / (2.0 * 1000e12))
    assert read("train.fwd_bwd_s", TRAIN) == 1.5
    assert read("train.optimizer_s", TRAIN) == 0.25
    # matmul kernels: 400 + 100 us; two steps of 1e11 operations
    assert read("train.matmul_roofline_pct", TRAIN) == pytest.approx(
        100 * 2e11 / (500e-6 * 1000e12))
    # busy 400 + 100 + 100 + 200 of a 1,200 us window
    assert read("train.device_idle_pct", TRAIN) == pytest.approx(100 * (1 - 800 / 1200))


def test_serve_readers():
    assert read("serve.prefill_mfu_pct", SERVE) == pytest.approx(20.0)
    assert read("serve.decode_step_ms", SERVE) == pytest.approx(50.0)
    assert read("serve.attention_roofline_pct", SERVE) == pytest.approx(
        100 * 28 * 1e-3 / 200e-6 / 1e3)
    assert read("serve.device_idle_pct", SERVE) == pytest.approx(100 * (1 - 800 / 1200))


@pytest.mark.parametrize("metric", ["train.mfu_pct", "train.matmul_roofline_pct",
                                    "train.device_idle_pct", "serve.attention_roofline_pct",
                                    "serve.prefill_mfu_pct"])
def test_a_share_with_nothing_to_read_is_none_never_zero(metric):
    empty = {"device_ops": [], "spans": [], "host_ops": [], "window": (0.0, 1.0)}
    for kind in ("train", "serve"):
        rec = dict(TRAIN if kind == "train" else SERVE, trace=empty, step_s=0, prefill_s=0)
        assert read(metric, rec) is None
    if "idle" not in metric:  # a share of the peak needs the card's peak
        assert hx.reader(metric).read(TRAIN if metric.startswith("train") else SERVE,
                                      None) is None


def test_readers_keep_to_their_kind():
    assert read("train.mfu_pct", SERVE) is None
    assert read("serve.decode_step_ms", TRAIN) is None


def test_breakdown_and_busy():
    busy, window = hx.busy_and_window(TRACE)
    assert (busy, window) == pytest.approx((800e-6, 1200e-6))
    b = hx.breakdown(TRACE)
    assert b["device_ops"][0] == ["nvjet_tst_256x128_h_bz_NNT", pytest.approx(400e-6)]
    idle = dict(b["idle_gaps"])
    # gaps 400-500 (inside aten::mm), 700-800 and 1000-1200 (mid-point inside the span)
    assert idle == pytest.approx({"train.step/aten::mm": 100e-6, "train.step/host": 300e-6})
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_union_of_overlapping_intervals():
    assert hx.union_length([(0, 2), (1, 3), (5, 6)]) == 4


def test_reduce_events_drops_the_spans_device_copies():
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    def ev(name, dev, s, e):
        return NS(name=name, device_type=dev, time_range=NS(start=s, end=e))

    events = [ev("perfbench.window", DeviceType.CPU, 0, 100), ev("train.step", DeviceType.CPU, 1, 90),
              ev("train.step", DeviceType.CUDA, 2, 95), ev("gemm_kernel", DeviceType.CUDA, 10, 20),
              ev("aten::mm", DeviceType.CPU, 5, 9)]
    rec = hx.reduce_events(events, {"perfbench.window", "train.step"})
    assert rec["device_ops"] == [("gemm_kernel", 10.0, 20.0)]
    assert rec["spans"] == [("train.step", 1.0, 90.0)]
    assert rec["window"] == (0.0, 100.0)
