"""The readers of the program's spans and counters (``repro_torch.obs``):
each on a synthetic record and snapshot against the value worked out by
hand; None from a program that records nothing (the parent of the change
that added the module) and from a CPU run's device times; and a tiny CPU
``run_cell`` of each cell with ``--trace 1``."""
import math
import sys

import pytest

from perfbench import harness as hx
from perfbench.run import run_cell

from pb_tiny import tiny_cell

SPAN_METRICS = ["train.forward_s", "train.backward_s", "train.update_s", "train.recompute_pct",
                "serve.decode_launches", "serve.decode_busy_pct"]
COUNTER_METRICS = ["train.moe_drop_pct", "serve.decode_used_pct", "serve.moe_drop_pct",
                   "serve.moe_prefill_fill_pct"]


def _records(spans):
    return [{"name": n, "parent": None, "tag": None, "device_s": s} for n, s in spans]


TRAIN_SNAP = {
    "records": _records([("train_step", 1.0), ("model.forward", 0.30), ("model.recompute", 0.05),
                         ("model.recompute", 0.05), ("model.backward", 0.60),
                         ("optimizer.update", 0.10), ("train_step", 1.2),
                         ("model.forward", 0.32), ("model.recompute", 0.05),
                         ("model.recompute", 0.05), ("model.backward", 0.70),
                         ("optimizer.update", 0.12)]),
    "counters": {"moe.pairs": {"train_step": 1000}, "moe.kept": {"train_step": 977},
                 "moe.slots": {"train_step": 1400}}}
SERVE_SNAP = {
    "records": _records([("engine.wave", None), ("model.prefill", 1.0)]),
    "counters": {"engine.decode_steps": {None: 8}, "engine.decode_steps_used": {None: 7},
                 "moe.pairs": {"model.prefill": 1000, "model.decode_step": 100},
                 "moe.kept": {"model.prefill": 897, "model.decode_step": 100},
                 "moe.slots": {"model.prefill": 1300, "model.decode_step": 400}}}
# two decode steps 0-100 and 200-300 us, each in a decode iteration 0-120, 200-320
HOST = [("model.decode_step", 0.0, 100.0), ("model.decode_step", 200.0, 300.0),
        ("engine.decode", 0.0, 120.0), ("engine.decode", 200.0, 320.0),
        ("cudaLaunchKernel", 10.0, 12.0), ("cudaLaunchKernel", 20.0, 22.0),
        ("cudaLaunchKernel", 50.0, 52.0), ("cudaLaunchKernel", 150.0, 152.0),
        ("cudaLaunchKernel", 210.0, 212.0), ("cuLaunchKernelEx", 250.0, 251.0),
        ("aten::mm", 9.0, 30.0)]
DEVICE = [("k", 10.0, 30.0), ("k", 20.0, 40.0), ("k", 110.0, 130.0), ("k", 130.0, 150.0),
          ("k", 250.0, 400.0)]
TRACE = {"device_ops": DEVICE, "spans": [], "host_ops": HOST, "window": (0.0, 400.0)}
TRAIN = {"kind": "train", "trace": TRACE}
SERVE = {"kind": "serve", "trace": TRACE}


@pytest.fixture
def snap(monkeypatch):
    """Hand the readers a snapshot of the test's choosing."""
    from repro_torch import obs

    def use(value):
        monkeypatch.setattr(obs, "snapshot", lambda: value)
    return use


def read(metric, rec):
    return hx.reader(metric).read(rec, None)


def test_train_readers(snap):
    snap(TRAIN_SNAP)
    assert read("train.forward_s", TRAIN) == pytest.approx(0.31)
    assert read("train.backward_s", TRAIN) == pytest.approx(0.65)
    assert read("train.update_s", TRAIN) == pytest.approx(0.11)
    assert read("train.recompute_pct", TRAIN) == pytest.approx(100 * 0.2 / 2.2)
    assert read("train.moe_drop_pct", TRAIN) == pytest.approx(2.3)


def test_serve_readers(snap):
    snap(SERVE_SNAP)
    assert read("serve.decode_used_pct", SERVE) == pytest.approx(87.5)
    assert read("serve.moe_drop_pct", SERVE) == pytest.approx(10.3)
    assert read("serve.moe_prefill_fill_pct", SERVE) == pytest.approx(100 * 897 / 1300)
    # launches at 10, 20, 50 in the first step, 210 and 250 in the second; 150 is outside
    assert read("serve.decode_launches", SERVE) == pytest.approx(2.5)
    # busy 10-40 and 110-120 of 0-120, 250-320 of 200-320
    assert read("serve.decode_busy_pct", SERVE) == pytest.approx(100 * (30 + 10 + 70) / 240)


def test_no_recompute_reads_zero(snap):
    snap(dict(TRAIN_SNAP, records=[r for r in TRAIN_SNAP["records"]
                                   if r["name"] != "model.recompute"]))
    assert read("train.recompute_pct", TRAIN) == 0.0


@pytest.mark.parametrize("metric", ["train.forward_s", "train.backward_s", "train.update_s",
                                    "train.recompute_pct"])
def test_a_cpu_runs_device_time_is_none(metric, snap):
    snap(dict(TRAIN_SNAP, records=[dict(r, device_s=None) for r in TRAIN_SNAP["records"]]))
    assert read(metric, TRAIN) is None


@pytest.mark.parametrize("metric", SPAN_METRICS + COUNTER_METRICS)
def test_a_program_that_records_nothing_reads_none(metric, monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)  # the import fails
    bare = {"device_ops": DEVICE, "spans": [], "window": (0.0, 400.0),
            "host_ops": [op for op in HOST if not op[0].startswith(("model.", "engine."))]}
    for kind in ("train", "serve"):
        assert read(metric, {"kind": kind, "trace": bare}) is None


@pytest.mark.parametrize("metric", SPAN_METRICS + COUNTER_METRICS)
def test_readers_keep_to_their_kind(metric, snap):
    snap(dict(TRAIN_SNAP, counters={**TRAIN_SNAP["counters"], **SERVE_SNAP["counters"]}))
    other = SERVE if metric.startswith("train.") else TRAIN
    assert read(metric, other) is None


@pytest.mark.parametrize("name", ["qwen3_0_6b.train_4k", "qwen2_moe_a2_7b.train_1k",
                                  "qwen3_0_6b.prefill_8k", "qwen2_moe_a2_7b.prefill_4k"])
def test_a_traced_cpu_run_reads_counters_and_no_device_time(name):
    from repro_torch import obs

    cell = tiny_cell(name)
    obs.reset()
    try:
        r = run_cell(name, 3_000_000_019, 0.2, True, device="cpu", cell=cell, t_start=0.0)
    finally:
        obs.reset()
    mine = [m["name"] for m in cell.per_layer if m["name"] in SPAN_METRICS + COUNTER_METRICS]
    assert mine
    for metric in mine:
        if metric in COUNTER_METRICS:
            assert math.isfinite(r["metrics"][metric]["value"]), metric
        else:
            assert metric not in r["metrics"], metric
    if "prefill" in name:
        new = cell.traffic["new"]
        assert r["metrics"]["serve.decode_used_pct"]["value"] == pytest.approx(
            100 * (new - 1) / new)
    for metric in ("train.moe_drop_pct", "serve.moe_drop_pct", "serve.moe_prefill_fill_pct"):
        if metric in mine:
            assert 0 <= r["metrics"][metric]["value"] <= 100
