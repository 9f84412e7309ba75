"""The port's device semantic engine (``repro_torch.core.semexec``) against
the JAX reference, on the CPU (``device="cpu"``: the kernels' plain
versions).

Mirrors ``tests/test_semexec.py``.  For all 16 (accelerator, problem) pairs
of ``semexec.SUPPORTED`` on the tiny graph, the port's ``device`` engine is
held against both of the reference's engines:

- the same ``layout["engine"]``, iteration count and request-stream hash,
- min-problem values bit-equal (f32 min is exact and order-independent),
- acc-problem values allclose at ``rtol=1e-5, atol=1e-6``, the reference's
  own device-vs-numpy tolerance: the sums associate in another order than
  ``np.add.at`` and XLA's segment sum.

Also: the device address decode against ``TraceBatch`` packing, the
resolve/warn behaviour, the semantic cache key, and the device policy.
"""
import dataclasses
import warnings

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs.graphsim import default_config as ref_default_config  # noqa: E402
from repro.core import semexec as ref_semexec  # noqa: E402
from repro.core.accelerators import ACCELERATORS as REF_ACCELERATORS  # noqa: E402
from repro.core.dram import dram_config as ref_dram_config  # noqa: E402
from repro.core.trace import emit_bank_row_device as ref_emit_bank_row_device  # noqa: E402
from repro.core.trace import trace_stream_hash as ref_trace_stream_hash  # noqa: E402
from repro.graph.generators import GraphSpec as RefGraphSpec  # noqa: E402
from repro.graph.problems import PROBLEMS as REF_PROBLEMS  # noqa: E402
from repro_torch.configs.graphsim import NONE, default_config  # noqa: E402
from repro_torch.core import semexec  # noqa: E402
from repro_torch.core.accelerators import ACCELERATORS, AccelConfig, run_accelerator  # noqa: E402
from repro_torch.core.dram import AddressMapping, dram_config  # noqa: E402
from repro_torch.core.engine import TraceBatch  # noqa: E402
from repro_torch.core.trace import emit_bank_row_device, trace_stream_hash  # noqa: E402
from repro_torch.graph.problems import PROBLEMS  # noqa: E402
from repro_torch.interop import graph_from_numpy  # noqa: E402
from repro_torch.kernels._platform import LAUNCHES  # noqa: E402

COMBOS = [(a, p) for a, probs in sorted(semexec.SUPPORTED.items())
          for p in sorted(probs)]
RTOL, ATOL = 1e-5, 1e-6  # acc sums associate differently (see module doc)


@pytest.fixture(scope="module")
def tiny_graphs():
    """(port graph, reference graph) pairs, unweighted and weighted, over
    the same numpy arrays."""
    rg = RefGraphSpec("tiny", "uniform", 256, 1024, True, 1, 0).build()
    out = {}
    for weighted, g in ((False, rg), (True, rg.with_weights())):
        out[weighted] = (graph_from_numpy(g.n, g.src, g.dst, g.weights, g.name,
                                          g.directed), g)
    return out


def _cfg(factory, accel: str, engine: str, **kw):
    return dataclasses.replace(factory(accel), interval_size=64, n_pes=2,
                               semexec=engine, **kw)


def _port(accel, g, prob, engine="device", **kw):
    return ACCELERATORS[accel](_cfg(default_config, accel, engine, **kw)).prepare(
        g, PROBLEMS[prob], root=int(g.degrees_out.argmax()), device="cpu")


def _ref(accel, g, prob, engine):
    return REF_ACCELERATORS[accel](_cfg(ref_default_config, accel, engine)).prepare(
        g, REF_PROBLEMS[prob], root=int(g.degrees_out.argmax()))


@pytest.mark.parametrize("accel,prob", COMBOS)
def test_device_engine_matches_reference_engines(accel, prob, tiny_graphs):
    g, rg = tiny_graphs[PROBLEMS[prob].needs_weights]
    before = dict(LAUNCHES)
    got = _port(accel, g, prob)
    assert LAUNCHES == before  # the CPU takes the plain versions: no launch
    assert got.layout["engine"] == "device"
    thash = trace_stream_hash(got.traces())
    for engine in ("device", "numpy"):
        want = _ref(accel, rg, prob, engine)
        assert want.layout["engine"] == engine
        assert got.iterations == want.iterations
        assert thash == ref_trace_stream_hash(want.traces())
        if PROBLEMS[prob].kind == "min":
            assert got.values.tobytes() == want.values.tobytes()
        else:
            np.testing.assert_allclose(got.values, want.values, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("opts", ["none", "edge_sorting", "update_filtering"])
@pytest.mark.parametrize("prob", ["bfs", "sssp"])
def test_hitgraph_device_masks_and_counts_without_combining(opts, prob, tiny_graphs):
    """The per-partition update counts and the filter/skip masks of the
    HitGraph step with update combining off (the paper default has it on)."""
    g, _ = tiny_graphs[PROBLEMS[prob].needs_weights]
    optimizations = NONE if opts == "none" else frozenset({opts, "partition_skipping"})
    dev = _port("hitgraph", g, prob, optimizations=optimizations)
    host = _port("hitgraph", g, prob, engine="numpy", optimizations=optimizations)
    assert dev.layout["engine"] == "device" and host.layout["engine"] == "numpy"
    assert dev.iterations == host.iterations
    assert trace_stream_hash(dev.traces()) == trace_stream_hash(host.traces())
    assert [dataclasses.asdict(s) for s in dev.stats] == \
        [dataclasses.asdict(s) for s in host.stats]
    assert dev.values.tobytes() == host.values.tobytes()


@pytest.mark.parametrize("mapping", ["row", "bank", "bank_xor"])
def test_emit_bank_row_device_matches_trace_batch(mapping, tiny_graphs):
    """The device decode agrees bit for bit with the host TraceBatch
    packing and with the reference's device decode, for every mapping."""
    g, rg = tiny_graphs[False]
    traces = _port("hitgraph", g, "bfs", engine="numpy").traces()
    cfg = dram_config("default", mapping=AddressMapping(mapping))
    want = TraceBatch.from_traces(traces, cfg, pad_batch=False)
    bank, row, lengths = emit_bank_row_device(traces, cfg, device="cpu")
    assert bank.dtype == row.dtype == torch.int32
    assert tuple(bank.shape) == want.bank.shape and tuple(row.shape) == want.row.shape
    np.testing.assert_array_equal(bank.numpy(), want.bank)
    np.testing.assert_array_equal(row.numpy(), want.row)
    np.testing.assert_array_equal(lengths, want.lengths)
    ref_traces = _ref("hitgraph", rg, "bfs", "numpy").traces()
    rbank, rrow, rlengths = ref_emit_bank_row_device(
        ref_traces, ref_dram_config("default", mapping=mapping))
    np.testing.assert_array_equal(bank.numpy(), np.asarray(rbank))
    np.testing.assert_array_equal(row.numpy(), np.asarray(rrow))
    np.testing.assert_array_equal(lengths, rlengths)


def test_bank_xor_needs_a_power_of_two_bank_count(tiny_graphs):
    g, _ = tiny_graphs[False]
    traces = _port("hitgraph", g, "bfs", engine="numpy").traces()
    cfg = dram_config("default", mapping=AddressMapping("bank_xor"))
    cfg = dataclasses.replace(cfg, banks_per_rank=12)
    with pytest.raises(ValueError, match="power-of-two"):
        emit_bank_row_device(traces, cfg, device="cpu")


def test_unsupported_pair_falls_back_with_warning():
    semexec._FALLBACK_WARNED.clear()
    with pytest.warns(UserWarning, match="falling back"):
        assert semexec.resolve_engine("accugraph", "sssp", "device") == "numpy"
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # second request: silent
        assert semexec.resolve_engine("accugraph", "sssp", "device") == "numpy"


def test_supported_pairs_and_resolution_match_reference():
    assert semexec.SUPPORTED == ref_semexec.SUPPORTED
    assert semexec.ENGINES == ref_semexec.ENGINES
    for accel, prob in COMBOS:
        assert semexec.resolve_engine(accel, prob, "device") == "device"
        assert semexec.resolve_engine(accel, prob, "numpy") == "numpy"
    with pytest.raises(ValueError, match="unknown semantic engine"):
        semexec.resolve_engine("hitgraph", "bfs", "cuda")


def test_semexec_excluded_from_semantic_key():
    cfg_n = default_config("hitgraph")
    cfg_d = dataclasses.replace(cfg_n, semexec="device")
    assert cfg_n.semantic_key() == cfg_d.semantic_key()
    with pytest.raises(ValueError, match="unknown semantic engine"):
        dataclasses.replace(cfg_n, semexec="cuda")


def test_device_engine_without_cuda_raises(monkeypatch, tiny_graphs):
    """``device=None`` means the card: the device engine raises without
    one, while the numpy engine's semantic half needs none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g, _ = tiny_graphs[False]
    cfg = _cfg(default_config, "hitgraph", "device")
    with pytest.raises(RuntimeError, match="CUDA"):
        ACCELERATORS["hitgraph"](cfg).prepare(g, PROBLEMS["bfs"], root=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_accelerator("hitgraph", g, PROBLEMS["bfs"], 0, None, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        emit_bank_row_device([], dram_config("default"))
    numpy_cfg = _cfg(default_config, "hitgraph", "numpy")
    assert ACCELERATORS["hitgraph"](numpy_cfg).prepare(
        g, PROBLEMS["bfs"], root=0).layout["engine"] == "numpy"


def test_device_run_reports_equal_numpy_run(tiny_graphs):
    """Through the entry point: the same SimReport from both engines on the
    CPU, apart from the engine recorded in the layout."""
    g, _ = tiny_graphs[False]
    reps = {e: run_accelerator("foregraph", g, PROBLEMS["bfs"], 0, "hbm",
                               AccelConfig(interval_size=64, n_pes=2, semexec=e),
                               device="cpu") for e in ("numpy", "device")}
    assert reps["device"].layout == {**reps["numpy"].layout, "engine": "device"}
    assert reps["device"].timing.to_dict() == reps["numpy"].timing.to_dict()
    assert reps["device"].values.tobytes() == reps["numpy"].values.tobytes()
