"""The port's main path -- one scenario in, one ``SimReport`` out -- against
the JAX reference, on the CPU (``device="cpu"``, the kernel's plain version).

The numpy semantic engine is carried over, so values are array-equal;
``timing``, ``iterations``, ``per_iteration`` and ``layout`` are equal.
Scenarios come from the reference's own ``SweepSpec`` and reach the port as
plain dicts (``repro_torch.interop``).
"""
import dataclasses
import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core.accelerators import ACCELERATORS as REF_ACCELERATORS  # noqa: E402
from repro.core.accelerators import run_accelerator as ref_run_accelerator  # noqa: E402
from repro.core.trace import trace_stream_hash as ref_trace_stream_hash  # noqa: E402
from repro.graph.generators import GraphSpec as RefGraphSpec  # noqa: E402
from repro.graph.problems import PROBLEMS as REF_PROBLEMS  # noqa: E402
from repro.sweep.spec import SweepSpec  # noqa: E402
from repro_torch.core.accelerators import ACCELERATORS, run_accelerator  # noqa: E402
from repro_torch.core.trace import trace_stream_hash  # noqa: E402
from repro_torch.graph.problems import PROBLEMS  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    accel_config_from_dict,
    dram_config_from_dict,
    graph_from_numpy,
)

TINY = RefGraphSpec("tiny", "uniform", 256, 1024, True, 1, 0)
GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                           "golden_hashes_tiny.json")


@pytest.fixture(scope="module")
def graphs():
    rg = TINY.build()
    return graph_from_numpy(rg.n, rg.src, rg.dst, rg.weights, rg.name, rg.directed), rg


def _port_args(scenario):
    return (dram_config_from_dict(dataclasses.asdict(scenario.dram)),
            accel_config_from_dict(dataclasses.asdict(scenario.config)))


def _assert_same_report(got, want):
    assert (got.accelerator, got.graph, got.problem, got.dram, got.n, got.m) == \
        (want.accelerator, want.graph, want.problem, want.dram, want.n, want.m)
    assert got.timing.to_dict() == want.timing.to_dict()  # ints and floats exact
    assert got.iterations == want.iterations
    assert [dataclasses.asdict(s) for s in got.per_iteration] == \
        [dataclasses.asdict(s) for s in want.per_iteration]
    assert got.layout == want.layout
    assert got.values.dtype == want.values.dtype
    np.testing.assert_array_equal(got.values, want.values)


def test_tiny_golden_trace_hashes(graphs):
    """The 8 scenarios of benchmarks/golden_hashes_tiny.json through the port."""
    g, _ = graphs
    baseline = json.load(open(GOLDEN_PATH))
    spec = SweepSpec(name="golden", accelerators=tuple(REF_ACCELERATORS),
                     graphs=(TINY,), problems=("bfs",), drams=("default", "hbm"))
    scenarios = spec.scenarios()
    assert len(scenarios) == len(baseline) == 8
    for s in scenarios:
        dram, cfg = _port_args(s)
        pending = ACCELERATORS[s.accelerator](cfg).prepare(
            g, PROBLEMS[s.problem], root=s.root, dram=dram)
        assert trace_stream_hash(pending.traces())[:16] == baseline[s.scenario_id], \
            s.scenario_id


def _pairs():
    out = []
    for accel, cls in REF_ACCELERATORS.items():
        for prob, p in REF_PROBLEMS.items():
            if not (p.needs_weights and not cls.supports_weights):
                out.append((accel, prob))
    return out


@pytest.mark.parametrize("accel,prob", _pairs())
def test_simreport_parity_default_dram(accel, prob, graphs):
    g, rg = graphs
    spec = SweepSpec(name="p", accelerators=(accel,), graphs=(TINY,),
                     problems=(prob,), drams=("default",))
    (s,) = spec.scenarios()
    dram, cfg = _port_args(s)
    got = run_accelerator(accel, g, PROBLEMS[prob], s.root, dram, cfg, device="cpu")
    want = ref_run_accelerator(accel, rg, REF_PROBLEMS[prob], s.root, s.dram, s.config)
    _assert_same_report(got, want)


@pytest.mark.parametrize("accel", list(REF_ACCELERATORS))
def test_simreport_parity_hbm_controller_corner(accel, graphs):
    """bfs on HBM with pseudo-channels, the XOR bank mapping and closed page."""
    g, rg = graphs
    spec = SweepSpec(name="c", accelerators=(accel,), graphs=(TINY,),
                     problems=("bfs",), drams=("hbm",), mappings=("bank_xor",),
                     page_policies=("closed",), pseudo_channels=(True,))
    (s,) = spec.scenarios()
    dram, cfg = _port_args(s)
    assert dram.pseudo_channels and dram.mapping.scheme == "bank_xor"
    pending = ACCELERATORS[accel](cfg).prepare(g, PROBLEMS["bfs"], root=s.root, dram=dram)
    rpending = REF_ACCELERATORS[accel](s.config).prepare(
        rg, REF_PROBLEMS["bfs"], root=s.root, dram=s.dram)
    assert trace_stream_hash(pending.traces()) == ref_trace_stream_hash(rpending.traces())
    _assert_same_report(pending.finalize(device="cpu"), rpending.finalize())


def test_simreport_parity_degree_reorder(graphs):
    g, rg = graphs
    spec = SweepSpec(name="r", accelerators=("hitgraph",), graphs=(TINY,),
                     problems=("wcc",), drams=("default",), reorders=("degree",))
    (s,) = spec.scenarios()
    dram, cfg = _port_args(s)
    assert cfg.reorder == "degree"
    got = run_accelerator("hitgraph", g, PROBLEMS["wcc"], s.root, dram, cfg, device="cpu")
    want = ref_run_accelerator("hitgraph", rg, REF_PROBLEMS["wcc"], s.root, s.dram, s.config)
    _assert_same_report(got, want)
    assert got.layout["reorder"] == "degree" and got.layout["engine"] == "numpy"
