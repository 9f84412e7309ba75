"""The port's host substrate against the JAX reference: graphs, partitions,
address decode, request-stream hashes and the reference solver.

Everything but ``reference_solve`` is numpy code carried over, so it must
be equal byte for byte.  ``reference_solve`` runs on torch
``scatter_reduce``: min problems are bit-equal (min is order-free); pr and
spmv sum in another order, so they are held to ``rtol=1e-4, atol=1e-7``
(the tolerance of ``tests/test_layout.py``'s acc-problem comparisons).
"""
import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import hostcache as ref_hostcache  # noqa: E402
from repro.core.dram import decode_lines as ref_decode_lines  # noqa: E402
from repro.core.dram import dram_config as ref_dram_config  # noqa: E402
from repro.core import trace as ref_trace  # noqa: E402
from repro.graph import partition as ref_partition  # noqa: E402
from repro.graph.generators import PAPER_GRAPHS as REF_PAPER_GRAPHS  # noqa: E402
from repro.graph.generators import rmat as ref_rmat  # noqa: E402
from repro.graph.layout import relabel_graph as ref_relabel_graph  # noqa: E402
from repro.graph.problems import PROBLEMS as REF_PROBLEMS  # noqa: E402
from repro.graph.problems import reference_solve as ref_reference_solve  # noqa: E402
from repro_torch.core import hostcache, trace  # noqa: E402
from repro_torch.core.dram import decode_lines, dram_config  # noqa: E402
from repro_torch.graph import partition  # noqa: E402
from repro_torch.graph.generators import PAPER_GRAPHS, rmat  # noqa: E402
from repro_torch.graph.layout import relabel_graph  # noqa: E402
from repro_torch.graph.problems import PROBLEMS, reference_solve  # noqa: E402
from repro_torch.interop import graph_from_numpy  # noqa: E402


def _assert_same_graph(a, b):
    assert (a.n, a.name, a.directed) == (b.n, b.name, b.directed)
    np.testing.assert_array_equal(a.src, b.src)
    np.testing.assert_array_equal(a.dst, b.dst)
    if a.weights is None:
        assert b.weights is None
    else:
        np.testing.assert_array_equal(a.weights, b.weights)
    assert a.fingerprint == b.fingerprint


@pytest.mark.parametrize("name", ["sd", "db", "yt", "rd"])
def test_paper_graphs_are_byte_equal(name):
    assert PAPER_GRAPHS[name] == type(PAPER_GRAPHS[name])(
        **REF_PAPER_GRAPHS[name].canonical())
    _assert_same_graph(PAPER_GRAPHS[name].build(), REF_PAPER_GRAPHS[name].build())


def test_rmat_weights_and_relabel_are_byte_equal():
    # relabel_graph caches on the graph's content, not its name: another
    # test's equal rmat under another name (tests/test_layout.py) must not
    # hand this one its relabeled graph, so both packages start cold
    ref_hostcache.clear_all()
    hostcache.clear_all()
    a, b = rmat(9, edge_factor=8, seed=23, name="r"), ref_rmat(9, edge_factor=8, seed=23, name="r")
    _assert_same_graph(a, b)
    _assert_same_graph(a.with_weights(), b.with_weights())
    for reorder in ("degree", "bfs", "random"):
        (ga, pa), (gb, pb) = relabel_graph(a, reorder), ref_relabel_graph(b, reorder)
        _assert_same_graph(ga, gb)
        np.testing.assert_array_equal(pa, pb)


def test_interop_graph_round_trip():
    b = ref_rmat(8, edge_factor=4, seed=2, name="x").with_weights()
    _assert_same_graph(graph_from_numpy(b.n, b.src, b.dst, b.weights, b.name,
                                        b.directed), b)


def test_partition_indices_are_equal():
    g, rg = rmat(10, edge_factor=8, seed=3), ref_rmat(10, edge_factor=8, seed=3)
    for by in ("src", "dst"):
        a = partition.horizontal_partition(g, 128, by=by)
        b = ref_partition.horizontal_partition(rg, 128, by=by)
        assert a.k == b.k
        for x, y in zip(a.edge_idx, b.edge_idx):
            np.testing.assert_array_equal(x, y)
        for p in range(a.k):
            for x, y in zip(a.csr_for(p), b.csr_for(p)):
                np.testing.assert_array_equal(x, y)
    a = partition.vertical_partition(g, 128, n_chunks=3)
    b = ref_partition.vertical_partition(rg, 128, n_chunks=3)
    assert (a.k, a.n_chunks) == (b.k, b.n_chunks)
    for xs, ys in zip(a.edge_idx, b.edge_idx):
        for x, y in zip(xs, ys):
            np.testing.assert_array_equal(x, y)
    a = partition.interval_shard_partition(g, 128)
    b = ref_partition.interval_shard_partition(rg, 128)
    assert a.q == b.q
    for xs, ys in zip(a.shard_edge_idx, b.shard_edge_idx):
        for x, y in zip(xs, ys):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(partition.stride_mapping(1000, 7),
                                  ref_partition.stride_mapping(1000, 7))


@pytest.mark.parametrize("scheme", ["row", "bank", "bank_xor"])
def test_decode_lines_plain_and_fused_are_equal(scheme):
    rng = np.random.default_rng(5)
    lines = rng.integers(0, 1 << 26, size=5000).astype(np.int64)
    for preset in ("default", "hbm", "hitgraph"):
        cfg, rcfg = dram_config(preset, mapping=scheme), ref_dram_config(preset, mapping=scheme)
        want = ref_decode_lines(lines.copy(), rcfg)
        for got in (decode_lines(lines.copy(), cfg),
                    decode_lines(lines.copy(), cfg, np.empty(len(lines), np.int32),
                                 np.empty(len(lines), np.int32))):
            for x, y in zip(got, want):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)


def _streams(mod, lazy: bool):
    """One expression over every combinator, built from the same inputs."""
    rng = np.random.default_rng(11)
    idx = rng.integers(0, 4096, size=700)
    prev = mod.lazy_enabled()
    mod.set_lazy(lazy)
    try:
        a = mod.seq_read(0, 64 * 300 + 17)
        b = mod.seq_write(1 << 20, 64 * 90)
        c = mod.random_read(1 << 22, idx, 4)
        d = mod.random_write(1 << 23, idx[::3], 8, coalesced=False)
        merged = mod.proportional_interleave(mod.round_robin(a, c), b, d)
        out = [mod.concat(merged, mod.coalesce(mod.concat(d, d)))]
        out += mod.split_round_robin(out[0], 2, 4)
        out += mod.split_round_robin(merged, 3)
        return out
    finally:
        mod.set_lazy(prev)


@pytest.mark.parametrize("lazy", [True, False])
def test_trace_stream_hash_is_equal(lazy):
    a, b = _streams(trace, lazy), _streams(ref_trace, lazy)
    assert [t.n for t in a] == [t.n for t in b]
    assert [t.write_bytes for t in a] == [t.write_bytes for t in b]
    assert trace.trace_stream_hash(a) == ref_trace.trace_stream_hash(b)


@pytest.mark.parametrize("prob", ["bfs", "wcc", "sssp", "pr", "spmv"])
def test_reference_solve_matches(prob):
    g, rg = rmat(10, edge_factor=8, seed=3), ref_rmat(10, edge_factor=8, seed=3)
    root = int(np.argmax(g.degrees_out))
    got, it = reference_solve(g, PROBLEMS[prob], root, device="cpu")
    want, rit = ref_reference_solve(rg, REF_PROBLEMS[prob], root)
    assert it == rit and got.dtype == want.dtype == np.float32
    if PROBLEMS[prob].kind == "min":
        np.testing.assert_array_equal(got, want)  # bit-equal
    else:  # scatter-sum order differs from XLA's segment_sum
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
