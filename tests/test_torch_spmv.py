"""The port's SpMV layout and plain versions against the JAX reference.

- ``to_ell`` is a numpy copy of the reference's and must be array-equal.
- ``spmv_ell_plain`` (what ``chip_smoke.py`` holds the CUDA kernel
  ``csrc/spmv.cu`` against on the card) sums each row in column order; the
  reference's Pallas kernel sums with ``jnp.sum`` in tree order, so the two
  agree to ``rtol=1e-5, atol=1e-6`` (the semexec acc tolerance,
  ``tests/test_semexec.py``), not bit for bit.
- ``spmv_coo_plain`` sums by ``index_add_``, in another order than XLA's
  segment sum: allclose at the same tolerance.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.graph.generators import rmat, uniform_random  # noqa: E402
from repro.kernels.spmv.ops import spmv as ref_spmv  # noqa: E402
from repro.kernels.spmv.ref import spmv_coo_ref  # noqa: E402
from repro.kernels.spmv.ref import to_ell as ref_to_ell  # noqa: E402
from repro.kernels.spmv.spmv import spmv_ell_pallas  # noqa: E402
from repro_torch.interop import graph_from_numpy  # noqa: E402
from repro_torch.kernels._platform import LAUNCHES  # noqa: E402
from repro_torch.kernels.spmv import (  # noqa: E402
    spmv,
    spmv_coo_plain,
    spmv_edges,
    spmv_ell,
    spmv_ell_plain,
    to_ell,
)

RTOL, ATOL = 1e-5, 1e-6  # summation order differs from the reference's


def _graph(kind: str, seed: int):
    if kind == "rmat":
        return rmat(8, edge_factor=8, seed=seed).with_weights()
    return uniform_random(300, 1200, seed=seed).with_weights()


def _x(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=n).astype(np.float32)


@pytest.mark.parametrize("block_rows", [64, 256])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("kind,seed", [("uniform", 0), ("uniform", 1), ("rmat", 3)])
def test_to_ell_array_equal_to_reference(kind, seed, weighted, block_rows):
    g = _graph(kind, seed)
    w = g.weights if weighted else None
    idx, val = to_ell(g.src, g.dst, w, g.n, block_rows=block_rows)
    ridx, rval = ref_to_ell(g.src, g.dst, w, g.n, block_rows=block_rows)
    assert idx.dtype == ridx.dtype and val.dtype == rval.dtype
    np.testing.assert_array_equal(idx, ridx)
    np.testing.assert_array_equal(val, rval)
    assert idx.shape[0] % block_rows == 0


@pytest.mark.parametrize("kind,seed", [("uniform", 0), ("uniform", 1), ("rmat", 3)])
def test_spmv_ell_plain_matches_pallas(kind, seed):
    g = _graph(kind, seed)
    idx, val = to_ell(g.src, g.dst, g.weights, g.n, block_rows=64)
    x = _x(g.n, seed)
    got = spmv_ell_plain(*(torch.from_numpy(a) for a in (idx, val, x))).numpy()
    want = np.asarray(spmv_ell_pallas(jnp.asarray(idx), jnp.asarray(val), jnp.asarray(x),
                                      block_rows=64, interpret=True))
    assert got.shape == (idx.shape[0],)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_spmv_ell_plain_sums_each_row_in_column_order():
    """The plain version is the kernel's arithmetic: a float32 loop over the
    columns, one rounding per multiply and per add."""
    g = _graph("rmat", 5)
    idx, val = to_ell(g.src, g.dst, g.weights, g.n)
    x = _x(g.n, 5)
    want = np.zeros(idx.shape[0], dtype=np.float32)
    for d in range(idx.shape[1]):
        gathered = np.where(idx[:, d] >= 0, x[np.maximum(idx[:, d], 0)], np.float32(0))
        want = want + val[:, d] * gathered
    got = spmv_ell_plain(*(torch.from_numpy(a) for a in (idx, val, x))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind,seed", [("uniform", 2), ("rmat", 4)])
def test_spmv_edges_matches_coo_ref(kind, seed):
    g = _graph(kind, seed)
    x = _x(g.n, seed)
    want = np.asarray(spmv_coo_ref(jnp.asarray(g.src), jnp.asarray(g.dst),
                                   jnp.asarray(g.weights), jnp.asarray(x), g.n))
    src, dst, w, xt = (torch.from_numpy(a) for a in (g.src, g.dst, g.weights, x))
    coo = spmv_edges(src, dst, w, xt, g.n).numpy()
    np.testing.assert_allclose(coo, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(coo, spmv_coo_plain(src, dst, w, xt, g.n).numpy())
    ell = tuple(torch.from_numpy(a) for a in to_ell(g.src, g.dst, g.weights, g.n))
    via_ell = spmv_edges(src, dst, w, xt, g.n, ell=ell).numpy()
    assert via_ell.shape == (g.n,)
    np.testing.assert_allclose(via_ell, want, rtol=RTOL, atol=ATOL)


def test_graph_spmv_matches_reference():
    rg = _graph("uniform", 9)
    g = graph_from_numpy(rg.n, rg.src, rg.dst, rg.weights, rg.name, rg.directed)
    x = _x(g.n, 9)
    np.testing.assert_allclose(spmv(g, x, device="cpu"),
                               ref_spmv(rg, x, use_pallas=True, interpret=True),
                               rtol=RTOL, atol=ATOL)


def test_wrapper_takes_plain_version_on_cpu_and_counts_no_launch():
    g = _graph("uniform", 0)
    args = [torch.from_numpy(a) for a in (*to_ell(g.src, g.dst, g.weights, g.n),
                                         _x(g.n, 0))]
    before = LAUNCHES["spmv"]
    assert torch.equal(spmv_ell(*args), spmv_ell_plain(*args))
    assert LAUNCHES["spmv"] == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    g = _graph("uniform", 1)
    idx, val, x = (torch.from_numpy(a) for a in (*to_ell(g.src, g.dst, g.weights, g.n),
                                                 _x(g.n, 1)))
    with pytest.raises(TypeError, match="idx"):
        spmv_ell(idx.long(), val, x)
    with pytest.raises(TypeError, match="w must be"):
        spmv_ell(idx, val.double(), x)
    with pytest.raises(ValueError, match=r"\(n_pad, D\)"):
        spmv_ell(idx, val[:-1], x)
    with pytest.raises(ValueError, match="1-D"):
        spmv_ell(idx, val, x[None])
    with pytest.raises(ValueError, match="contiguous"):
        spmv_ell(idx.t().contiguous().t(), val.t().contiguous().t(), x)
    with pytest.raises(ValueError, match="unsupported device"):
        spmv_ell(idx.to("meta"), val.to("meta"), x.to("meta"))


def test_spmv_edges_without_ell_raises_off_the_cpu():
    """No quiet COO fallback: off the CPU an ELL layout is required."""
    src = torch.zeros(4, dtype=torch.int32, device="meta")
    w = torch.zeros(4, device="meta")
    x = torch.zeros(3, device="meta")
    with pytest.raises(ValueError, match="ELL"):
        spmv_edges(src, src, w, x, 3)
