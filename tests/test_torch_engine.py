"""The port's timing engine against the JAX reference.

``simulate_batch`` / ``simulate_sequential`` / ``simulate_dram`` /
``simulate_many`` on the CPU (the kernel's plain version) must return
``TimingReport`` s equal to the reference's -- ints exact and floats exact,
since the float code is carried over unchanged -- and the same
``dispatch_stats()``: dedup, bucketing and chunking are the reference's.
Covers the address mappings x page policies x pseudo-channels, the
analytic fast engine (small ``scan_cutoff``) and lazy accelerator traces.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.configs.graphsim import default_config as ref_default_config  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core.accelerators import ACCELERATORS as REF_ACCELERATORS  # noqa: E402
from repro.core.dram import dram_config as ref_dram_config  # noqa: E402
from repro.core.trace import Trace as RefTrace  # noqa: E402
from repro.graph.generators import GraphSpec as RefGraphSpec  # noqa: E402
from repro.graph.problems import PROBLEMS as REF_PROBLEMS  # noqa: E402
from repro_torch.configs.graphsim import default_config  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.accelerators import ACCELERATORS  # noqa: E402
from repro_torch.core.dram import dram_config  # noqa: E402
from repro_torch.graph.generators import GraphSpec  # noqa: E402
from repro_torch.graph.problems import PROBLEMS  # noqa: E402
from repro_torch.interop import dram_config_from_dict, traces_from_numpy  # noqa: E402

TINY = ("tiny", "uniform", 256, 1024, True, 1, 0)


def _items(seed: int, n: int = 5) -> list:
    """Random traces with locality (sequential runs) and scatter, lengths
    in two buckets (<= 256 and <= 512), plus one empty trace."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        length = int(rng.integers(100, 256)) if i == 0 else int(rng.integers(257, 512))
        run = np.int64(rng.integers(0, 1 << 20)) + np.arange(length // 2)
        scatter = rng.integers(0, 1 << 16, size=length - length // 2)
        items.append((np.concatenate([run, scatter]).astype(np.int64),
                      rng.random(length) < 0.3))
    items.append((np.zeros(0, np.int64), np.zeros(0, bool)))
    return items


def _pair(items):
    return traces_from_numpy(items), [RefTrace(l, w) for l, w in items]


def _dicts(reports):
    return [r.to_dict() for r in reports]


def _cfgs(preset, **kw):
    """The same DRAM config in both packages (carried over as a dict)."""
    rcfg = ref_dram_config(preset, **kw)
    return dram_config_from_dict(dataclasses.asdict(rcfg)), rcfg


@pytest.mark.parametrize("policy", ["open", "closed"])
@pytest.mark.parametrize("mapping", ["row", "bank", "bank_xor"])
def test_simulate_batch_and_sequential_equal(mapping, policy):
    cfg, rcfg = _cfgs("default", mapping=mapping, page_policy=policy)
    assert cfg == dram_config("default", mapping=mapping, page_policy=policy)
    ours, ref = _pair(_items(len(mapping) + (policy == "open")))
    engine.reset_dispatch_stats()
    ref_engine.reset_dispatch_stats()
    assert _dicts(engine.simulate_batch(ours, cfg, device="cpu")) == \
        _dicts(ref_engine.simulate_batch(ref, rcfg))
    assert engine.dispatch_stats() == ref_engine.dispatch_stats()
    assert engine.dispatch_stats()["dispatches"] == 2  # two length buckets
    engine.reset_dispatch_stats()
    ref_engine.reset_dispatch_stats()
    assert _dicts(engine.simulate_sequential(ours[:3], cfg, device="cpu")) == \
        _dicts(ref_engine.simulate_sequential(ref[:3], rcfg))
    assert engine.dispatch_stats() == ref_engine.dispatch_stats()


@pytest.mark.parametrize("pseudo_channels", [False, True])
@pytest.mark.parametrize("batched", [True, False])
def test_simulate_dram_equal(pseudo_channels, batched):
    cfg, rcfg = _cfgs("hbm", channels=4, mapping="bank_xor",
                      pseudo_channels=pseudo_channels)
    ours, ref = _pair(_items(21, n=3))
    got = engine.simulate_dram(ours, cfg, batched=batched, device="cpu")
    assert got.to_dict() == ref_engine.simulate_dram(ref, rcfg, batched=batched).to_dict()
    assert got.channels_used == (6 if pseudo_channels else 3)


def test_fast_engine_and_cutoff_policy_equal():
    cfg, rcfg = _cfgs("ddr3", page_policy="closed")
    ours, ref = _pair(_items(5))
    for eng, cutoff in (("auto", 300), ("fast", engine.SCAN_CUTOFF)):
        engine.reset_dispatch_stats()
        ref_engine.reset_dispatch_stats()
        assert _dicts(engine.simulate_batch(ours, cfg, eng, cutoff, device="cpu")) == \
            _dicts(ref_engine.simulate_batch(ref, rcfg, eng, cutoff))
        assert engine.dispatch_stats() == ref_engine.dispatch_stats()
    assert engine.select_engine(301, "auto", 300) == "fast"
    with pytest.raises(ValueError):
        engine.select_engine(1, "exact")


def test_simulate_many_groups_like_the_reference():
    items = _items(9)
    work, rwork = [], []
    for preset, policy in (("default", "open"), ("hbm", "closed"), ("default", "open")):
        cfg, rcfg = _cfgs(preset, page_policy=policy)
        ours, ref = _pair(items)
        work += [(t, cfg, "auto", engine.SCAN_CUTOFF) for t in ours]
        rwork += [(t, rcfg, "auto", ref_engine.SCAN_CUTOFF) for t in ref]
    engine.reset_dispatch_stats()
    ref_engine.reset_dispatch_stats()
    assert _dicts(engine.simulate_many(work, device="cpu")) == \
        _dicts(ref_engine.simulate_many(rwork))
    assert engine.dispatch_stats() == ref_engine.dispatch_stats()


@pytest.mark.parametrize("accel", ["thundergp", "hitgraph"])
def test_lazy_accelerator_traces_dedup_like_the_reference(accel):
    """Lazy traces (structural-key dedup, fused decode) of a real scenario:
    ThunderGP re-emits static streams every iteration, which dedup collapses."""
    g, rg = GraphSpec(*TINY).build(), RefGraphSpec(*TINY).build()
    pend = ACCELERATORS[accel](default_config(accel)).prepare(
        g, PROBLEMS["bfs"], dram="hbm")
    rpend = REF_ACCELERATORS[accel](ref_default_config(accel)).prepare(
        rg, REF_PROBLEMS["bfs"], dram="hbm")
    engine.reset_dispatch_stats()
    ref_engine.reset_dispatch_stats()
    assert _dicts(engine.simulate_batch(pend.traces(), pend.dram, device="cpu")) == \
        _dicts(ref_engine.simulate_batch(rpend.traces(), rpend.dram))
    stats = engine.dispatch_stats()
    assert stats == ref_engine.dispatch_stats()
    assert stats["traces"] <= len(pend.traces())


def test_trace_batch_is_equal():
    cfg, rcfg = _cfgs("hitgraph")
    ours, ref = _pair(_items(13))
    a = engine.TraceBatch.from_traces(ours, cfg)
    b = ref_engine.TraceBatch.from_traces(ref, rcfg)
    for x, y in ((a.bank, b.bank), (a.row, b.row), (a.lengths, b.lengths)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
