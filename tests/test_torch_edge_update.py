"""The port's edge-update (scatter-min) plain version against the JAX
reference.

``repro_torch.kernels.edge_update.edge_update_plain`` -- what the port's CPU
path runs, and what ``chip_smoke.py`` holds the CUDA kernel
``csrc/edge_update.cu`` against on the card -- must be bit-equal to the
Pallas kernel run in interpret mode and to the reference's segment-min
oracle, for f32 and int32, with sentinel sources, ``src = -1`` edges and
empty segments.  Tolerance: none; min is order-independent and exact.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.graph.generators import uniform_random  # noqa: E402
from repro.kernels.edge_update.edge_update import edge_update_pallas  # noqa: E402
from repro.kernels.edge_update.ops import relax_step as ref_relax_step  # noqa: E402
from repro.kernels.edge_update.ops import scatter_min as ref_scatter_min  # noqa: E402
from repro.kernels.edge_update.ref import edge_update_ref  # noqa: E402
from repro_torch.interop import graph_from_numpy  # noqa: E402
from repro_torch.kernels._platform import LAUNCHES  # noqa: E402
from repro_torch.kernels.edge_update import (  # noqa: E402
    edge_update,
    edge_update_plain,
    relax_step,
    scatter_min,
    sentinel_max,
)

BLOCK = 512  # the Pallas kernel's edge block; m is a multiple of it


def _inputs(seed: int, dtype, n: int = 300, m: int = 4 * BLOCK):
    """Random edges with ~10% src = -1, destinations only in the lower half
    (the upper half are empty segments), ~30% sentinel sources, negative
    values and deltas."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=m).astype(np.int32)
    src[rng.random(m) < 0.1] = -1
    dst = rng.integers(0, n // 2, size=m).astype(np.int32)
    if dtype == np.float32:
        values = (rng.standard_normal(n) * 10).astype(np.float32)
        values[rng.random(n) < 0.3] = np.inf
        delta = (rng.standard_normal(m) * 3).astype(np.float32)
    else:
        values = rng.integers(-50, 1000, size=n).astype(np.int32)
        values[rng.random(n) < 0.3] = np.iinfo(np.int32).max
        delta = rng.integers(-5, 6, size=m).astype(np.int32)
    return src, dst, delta, values


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_plain_matches_pallas_and_ref_bit_for_bit(dtype, seed):
    src, dst, delta, values = _inputs(seed, dtype)
    got = edge_update_plain(*_t(src, dst, delta, values)).numpy()
    pallas = np.asarray(edge_update_pallas(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(delta), jnp.asarray(values),
        block=BLOCK, interpret=True))
    ref = np.asarray(edge_update_ref(jnp.asarray(src), jnp.asarray(dst),
                                     jnp.asarray(delta), jnp.asarray(values), len(values)))
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, ref)
    top = sentinel_max(torch.from_numpy(values).dtype)
    assert (got[len(values) // 2:] == top).all()  # empty segments
    assert (got != top).any()


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_scatter_min_mask_matches_reference(dtype):
    src, dst, delta, values = _inputs(5, dtype)
    mask = np.random.default_rng(6).random(len(src)) < 0.6
    got = scatter_min(*_t(src, dst, delta, values), mask=torch.from_numpy(mask)).numpy()
    want = np.asarray(ref_scatter_min(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(delta), jnp.asarray(values),
        mask=jnp.asarray(mask), use_pallas=True, block=BLOCK, interpret=True))
    np.testing.assert_array_equal(got, want)
    unmasked = scatter_min(*_t(src, dst, delta, values)).numpy()
    assert not np.array_equal(got, unmasked)  # the mask dropped live edges


def test_int32_sentinel_sources_do_not_overflow():
    """A source at the int32 max adds no delta: nothing wraps negative."""
    n = 8
    values = np.full(n, np.iinfo(np.int32).max, dtype=np.int32)
    values[0] = 3
    src = np.array([1, 2, 0], dtype=np.int32)
    dst = np.array([4, 5, 6], dtype=np.int32)
    delta = np.array([5, 7, 2], dtype=np.int32)
    got = edge_update(*_t(src, dst, delta, values)).numpy()
    assert got.tolist() == [np.iinfo(np.int32).max] * 6 + [5, np.iinfo(np.int32).max]


def test_zero_edges_give_all_sentinel():
    values = torch.tensor([1.0, float("inf")])
    empty = torch.zeros(0, dtype=torch.int32)
    out = scatter_min(empty, empty, torch.zeros(0), values)
    assert torch.isinf(out).all()


@pytest.mark.parametrize("problem", ["bfs", "wcc", "sssp"])
def test_relax_step_matches_reference(problem):
    rg = uniform_random(200, 800, seed=7)
    if problem == "sssp":
        rg = rg.with_weights()
    g = graph_from_numpy(rg.n, rg.src, rg.dst, rg.weights, rg.name, rg.directed)
    rng = np.random.default_rng(7)
    values = np.where(rng.random(g.n) < 0.3, rng.random(g.n) * 10,
                      np.inf).astype(np.float32)
    got = relax_step(g, values, problem, device="cpu")
    want = ref_relax_step(rg, values, problem, use_pallas=True, interpret=True)
    np.testing.assert_array_equal(got, want)


def test_wrapper_takes_plain_version_on_cpu_and_counts_no_launch():
    args = _t(*_inputs(3, np.float32))
    before = LAUNCHES["edge_update"]
    assert torch.equal(edge_update(*args), edge_update_plain(*args))
    assert LAUNCHES["edge_update"] == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    src, dst, delta, values = _t(*_inputs(4, np.float32))
    with pytest.raises(TypeError, match="int32"):
        edge_update(src.long(), dst, delta, values)
    with pytest.raises(TypeError, match="float32 or int32"):
        edge_update(src, dst, delta.double(), values.double())
    with pytest.raises(TypeError, match="delta"):
        edge_update(src, dst, delta.int(), values)
    with pytest.raises(ValueError, match=r"\(m,\)"):
        edge_update(src, dst[:-1], delta, values)
    with pytest.raises(ValueError, match="1-D"):
        edge_update(src, dst, delta, values[None])
    with pytest.raises(ValueError, match="contiguous"):
        edge_update(src[::2], dst[::2], delta[::2].contiguous(), values)
    with pytest.raises(ValueError, match="unsupported device"):
        edge_update(*(t.to("meta") for t in (src, dst, delta, values)))
