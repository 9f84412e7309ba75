"""The port's edge-update (scatter-min) plain version against the JAX
reference, and a numpy model of the CUDA kernel's steps.

``repro_torch.kernels.edge_update.edge_update_plain`` -- what the port's CPU
path runs, and what ``chip_smoke.py`` holds the CUDA kernel
``csrc/edge_update.cu`` against on the card -- must be bit-equal to the
Pallas kernel run in interpret mode and to the reference's segment-min
oracle, for f32 and int32, with sentinel sources, ``src = -1`` edges,
empty segments and destinations outside ``[0, n)`` (below 0: vertex 0; from
n on: dropped).  ``warp_aggregated_model`` walks the kernel's plan, lanes,
runs, segmented min and atomics and must be bit-equal to both, on edge
orders and values chosen to break the grouping.  Tolerance: none; min is
order-independent and exact.
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
from repro_torch.kernels.edge_update.edge_update import (  # noqa: E402
    THREADS,
    _check,
    _launch,
    launch_plan,
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


@pytest.mark.parametrize("resident", [None, 1])
def test_launch_takes_cuda_tensors_only(resident):
    args = _t(*_inputs(3, np.float32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        _launch(*args, resident=resident)


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


# ---------------------------------------------------------------------------
# A numpy model of the kernel's steps (csrc/edge_update.cu), in its lane
# order: the plan's chunks and rounds, the key map, the lanes' runs, the
# segmented min over the lanes' heads, and the leaders' atomics in the
# float's integer views.  Held bit for bit against the plain version and the
# Pallas kernel; change it with the kernel.
# ---------------------------------------------------------------------------

I32MAX = np.iinfo(np.int32).max
F32_NONE, F32_TOP = np.uint32(0xFFFFFFFF), np.uint32(0xFF800000)  # no candidate; key of +inf


def f32_key(v: np.ndarray) -> np.ndarray:
    """The order-preserving uint32 view of float32 values."""
    b = np.asarray(v, np.float32).view(np.uint32)
    return b ^ np.where(b >> 31, np.uint32(0xFFFFFFFF), np.uint32(0x80000000))


def f32_unkey(k: np.ndarray) -> np.ndarray:
    """The float32 bits (as uint32) of keys."""
    k = np.asarray(k, np.uint32)
    return k ^ np.where(k >> 31, np.uint32(0x80000000), np.uint32(0xFFFFFFFF))


def _shfl_down(x: np.ndarray, o: int) -> np.ndarray:
    """__shfl_down_sync over 32 lanes: past lane 31 a lane gets its own."""
    return np.concatenate([x[o:], x[32 - o:]]) if o else x


def _shfl_up(x: np.ndarray, o: int) -> np.ndarray:
    return np.concatenate([x[:o], x[:32 - o]])


def warp_aggregated_model(src, dst, delta, values, resident: int):
    """The kernel's result and the atomics it issues, as (out, atomics):
    every step in the kernel's order, the chunks of ``launch_plan(m,
    resident)`` walked a round at a time."""
    m, n = len(src), len(values)
    per_lane, blocks, chunk = launch_plan(m, resident)
    f32 = values.dtype == np.float32
    none, top_key = (F32_NONE, F32_TOP) if f32 else (np.int64(I32MAX), np.int64(I32MAX))
    top = np.float32(np.inf) if f32 else np.int32(I32MAX)
    sv = values[np.maximum(src, 0)]
    live = (src >= 0) & (sv != top)
    with np.errstate(over="ignore"):
        cand = sv + delta  # float32 round to nearest; int32 wraps
    keys = np.where(live, f32_key(cand), none) if f32 else np.where(live, cand.astype(np.int64),
                                                                   none)
    # out in the views the atomics use: float bits as int32 and as uint32
    out = np.full(n, np.float32(np.inf) if f32 else I32MAX,
                  np.float32 if f32 else np.int32).view(np.int32).copy()
    atomics = []

    def apply(d, k):
        atomics.append(int(d))
        if not f32:
            out[d] = min(out[d], int(k))
            return
        b = f32_unkey(k)
        if b.view(np.int32) >= 0:
            out[d] = min(out[d], int(b.view(np.int32)))
        else:
            out.view(np.uint32)[d] = max(out.view(np.uint32)[d], b)

    lanes = np.arange(32)
    for c in range(blocks * (THREADS // 32)):
        begin, end = c * chunk, min((c + 1) * chunk, m)
        for base in range(begin, end, 32 * per_lane):
            e = base + per_lane * lanes[:, None] + np.arange(per_lane)[None, :]  # [32, P]
            inside = e < end
            ec = np.minimum(e, max(m - 1, 0))
            raw = dst[ec] if m else np.full(e.shape, -1, np.int32)
            # take_dst: below 0 is vertex 0; from n on, dropped as a skipped
            # edge with dst n - 1
            dropped = raw >= n
            d = np.where(inside, np.where(dropped, n - 1, np.maximum(raw, 0)), -1)
            k = np.where(inside & ~dropped, keys[ec] if m else none, none)
            if not (k < top_key).any():
                continue
            head, cur = k[:, 0].copy(), k[:, 0].copy()
            single = np.ones(32, bool)
            for j in range(1, per_lane):
                for lane in range(32):
                    if d[lane, j] != d[lane, j - 1]:
                        if single[lane]:
                            head[lane] = cur[lane]
                        elif cur[lane] < top_key:
                            apply(d[lane, j - 1], cur[lane])
                        single[lane] = False
                        cur[lane] = k[lane, j]
                    elif k[lane, j] < cur[lane]:
                        cur[lane] = k[lane, j]
            dh, dt = d[:, 0], d[:, per_lane - 1]
            h = np.where(single, cur, head)
            dh_next = _shfl_down(dh, 1)
            if ((lanes < 31) & (dh_next == dh)).any():
                for o in (1, 2, 4, 8, 16):
                    d2, h2 = _shfl_down(dh, o), _shfl_down(h, o)
                    h = np.where((d2 == dh) & (h2 < h), h2, h)
            dt_prev, h_next = _shfl_up(dt, 1), _shfl_down(h, 1)
            for lane in range(32):
                if (lane == 0 or dt_prev[lane] != dh[lane]) and h[lane] < top_key:
                    apply(dh[lane], h[lane])
                if not single[lane]:
                    t = cur[lane]
                    if lane < 31 and dh_next[lane] == dt[lane] and h_next[lane] < t:
                        t = h_next[lane]
                    if t < top_key:
                        apply(dt[lane], t)
    return out.view(values.dtype), atomics


def _order(order: str, src, dst, delta):
    """Edges in the order a layout gives them: random, sorted by dst (runs
    of equal dst of ``run`` edges), sorted by src, or every edge to one
    destination."""
    if order == "random":
        return src, dst, delta
    if order.startswith("dst-runs"):
        run = int(order.removeprefix("dst-runs"))
        dst = (np.arange(len(dst)) // run).astype(np.int32) % max(1, len(dst) // run + 1)
        return src, dst, delta
    if order == "src-sorted":
        o = np.argsort(src, kind="stable")
        return src[o], dst[o], delta[o]
    assert order == "one-dst"
    return src, np.full(len(dst), 7, np.int32), delta


def _model_case(order: str, kind: str, m: int, seed: int = 0):
    """Edges and values of one case.  ``f32-mixed``: negative and positive
    candidates in one group; ``f32-masked``: sentinel sources and src -1
    edges inside groups; ``i32-wrap``: int32 values near the max, where the
    add wraps, and int32-max sources."""
    rng = np.random.default_rng(seed)
    n = 64 + m // 4
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    if kind.startswith("f32"):
        values = (rng.standard_normal(n) * 10).astype(np.float32)
        delta = (rng.standard_normal(m) * 3).astype(np.float32)
        if kind == "f32-masked":
            values[rng.random(n) < 0.3] = np.inf
            src[rng.random(m) < 0.2] = -1
    else:
        values = rng.integers(I32MAX - 40, I32MAX, n).astype(np.int32)
        values[rng.random(n) < 0.3] = I32MAX
        delta = rng.integers(-5, 60, m).astype(np.int32)
        src[rng.random(m) < 0.1] = -1
    src, dst, delta = _order(order, src, dst, delta)
    return src, dst % n, delta, values


ORDERS = ["random", "dst-runs5", "dst-runs32", "dst-runs77", "src-sorted", "one-dst"]
KINDS = ["f32-mixed", "f32-masked", "i32-wrap"]


@pytest.mark.parametrize("m", [0, 1, 31, 33, 1030])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("order", ORDERS)
def test_model_of_the_kernel_matches_plain_bit_for_bit(order, kind, m):
    """The kernel's steps give the plain version's result, bit for bit, for
    one edge a lane (a card that holds many blocks) and four (one block:
    rounds of 128, several a warp), on a base offset by one edge too (the
    kernel then loads an edge at a time)."""
    src, dst, delta, values = _model_case(order, kind, m + 1)
    for base in (0, 1):  # one edge in: the arrays no longer 16-byte aligned
        s, d, dl = src[base:base + m], dst[base:base + m], delta[base:base + m]
        want = edge_update_plain(*_t(s, d, dl, values)).numpy()
        assert want.dtype == values.dtype
        for resident in (792, 1):
            per_lane = launch_plan(m, resident)[0]
            got, _ = warp_aggregated_model(s, d, dl, values, resident)
            np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32),
                                          err_msg=f"resident {resident}, per_lane {per_lane}")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("order", ORDERS)
def test_model_of_the_kernel_matches_pallas_in_interpret_mode(order, kind):
    src, dst, delta, values = _model_case(order, kind, 1030, seed=1)
    pad = 1536 - len(src)  # the Pallas kernel takes a multiple of its block
    padded = (np.concatenate([src, np.full(pad, -1, np.int32)]),
              np.concatenate([dst, np.zeros(pad, np.int32)]),
              np.concatenate([delta, np.zeros(pad, delta.dtype)]))
    pallas = np.asarray(edge_update_pallas(*(jnp.asarray(a) for a in padded),
                                           jnp.asarray(values), block=BLOCK, interpret=True))
    for resident in (792, 1):
        got, _ = warp_aggregated_model(src, dst, delta, values, resident)
        np.testing.assert_array_equal(got.view(np.uint32), pallas.view(np.uint32))


@pytest.mark.parametrize("resident", [792, 1])
@pytest.mark.parametrize("order", ["dst-runs5", "dst-runs32", "dst-runs77", "one-dst"])
def test_model_issues_one_atomic_per_run_with_a_candidate(order, resident):
    """On edges sorted by dst, each run of equal dst inside a round (32
    edges a warp, or 128) takes exactly one atomic if it holds a candidate,
    none otherwise; every edge to one destination is one atomic a round."""
    src, dst, delta, values = _model_case(order, "f32-masked", 2000, seed=2)
    m = len(src)
    per_lane, blocks, chunk = launch_plan(m, resident)
    live = (src >= 0) & np.isfinite(values[np.maximum(src, 0)])
    want = 0
    for c in range(blocks * (THREADS // 32)):
        for base in range(c * chunk, min((c + 1) * chunk, m), 32 * per_lane):
            e = np.arange(base, min(base + 32 * per_lane, (c + 1) * chunk, m))
            starts = np.flatnonzero(np.r_[True, dst[e][1:] != dst[e][:-1]])
            want += sum(bool(live[e][a:b].any())
                        for a, b in zip(starts, np.r_[starts[1:], len(e)]))
    _, atomics = warp_aggregated_model(src, dst, delta, values, resident)
    assert len(atomics) == want
    assert len(atomics) < int(live.sum())  # one a live edge: the first design


OUT_OF_RANGE = (-5, -1, "n", "n+7")  # destinations outside [0, n)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_out_of_range_dst_taken_as_the_reference_takes_it(dtype):
    """dst -5 and -1 go to vertex 0, dst n and n + 7 are dropped, mixed with
    valid edges (runs of equal dst broken by them, sorted and not): the plain
    version and the kernel's model equal ``edge_update_ref`` and the Pallas
    kernel in interpret mode bit for bit."""
    src, dst, delta, values = _inputs(11, dtype, m=2 * BLOCK)
    n, m = len(values), len(src)
    rng = np.random.default_rng(12)
    dst = np.sort(dst).astype(np.int32)  # runs of equal dst, as HitGraph's blocks
    bad = rng.random(m) < 0.25
    dst[bad] = rng.choice([v if isinstance(v, int) else n + (7 if v == "n+7" else 0)
                           for v in OUT_OF_RANGE], int(bad.sum()))
    dst[:4] = [-5, -1, n, n + 7]  # each at least once, in the first round
    assert ((dst < 0) | (dst >= n)).sum() > m // 5
    j = [jnp.asarray(a) for a in (src, dst, delta, values)]
    ref = np.asarray(edge_update_ref(*j, n))
    pallas = np.asarray(edge_update_pallas(*j, block=BLOCK, interpret=True))
    np.testing.assert_array_equal(pallas.view(np.uint32), ref.view(np.uint32))
    got = edge_update_plain(*_t(src, dst, delta, values)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    for resident in (792, 1):
        model, atomics = warp_aggregated_model(src, dst, delta, values, resident)
        np.testing.assert_array_equal(model.view(np.uint32), ref.view(np.uint32))
        assert all(0 <= a < n for a in atomics)  # no address outside [0, n)
    # vertex 0 took the negative destinations' candidates, and dropping the
    # rest changed the result (against the same edges with dst clipped to n - 1)
    top = sentinel_max(torch.from_numpy(values).dtype)
    assert got[0] != top
    clipped = edge_update_plain(*_t(src, np.minimum(dst, n - 1), delta, values)).numpy()
    assert not np.array_equal(clipped, got)


def test_key_map_orders_like_the_floats():
    """Keys order as the float32 values do (-0.0 below +0.0), and map back."""
    v = np.array([-np.inf, -3e38, -1.0, -1e-45, -0.0, 0.0, 1e-45, 1.0, 3e38, np.inf],
                 np.float32)
    k = f32_key(v)
    assert (np.diff(k.astype(np.int64)) > 0).all()
    np.testing.assert_array_equal(f32_unkey(k), v.view(np.uint32))
    assert f32_key(np.float32(np.inf)) == F32_TOP
    rng = np.random.default_rng(3)
    r = (rng.standard_normal(1000) * 1e3).astype(np.float32)
    np.testing.assert_array_equal(np.argsort(f32_key(r), kind="stable"),
                                  np.argsort(r, kind="stable"))


@pytest.mark.parametrize("m,resident", [(0, 792), (1, 792), (33, 1), (10_209, 792),
                                        (202_752, 792), (202_753, 792), (1_784_584, 792),
                                        (1_784_584, 684), (5000, 3)])
def test_launch_plan_covers_the_edges_within_the_card(m, resident):
    """One edge a lane while the card gives every 32 edges a warp, four
    beyond; blocks within what the card holds; chunks of whole rounds that
    cover every edge, one round a warp with one edge a lane."""
    per_lane, blocks, chunk = launch_plan(m, resident)
    warps = resident * (THREADS // 32)
    assert per_lane == (1 if m <= warps * 32 else 4)
    assert 1 <= blocks <= resident
    assert chunk % (32 * per_lane) == 0 and chunk > 0
    assert blocks * (THREADS // 32) * chunk >= m
    if per_lane == 1:
        assert chunk == 32  # a warp a round


REFUSED = [  # (what, args from (src, dst, delta, values), exception, message)
    ("values 2-D", lambda s, d, dl, v: (s, d, dl, v[None]), ValueError, "1-D"),
    ("values float64", lambda s, d, dl, v: (s, d, dl.double(), v.double()), TypeError,
     "float32 or int32"),
    ("values int64", lambda s, d, dl, v: (s, d, dl.long(), v.long()), TypeError,
     "float32 or int32"),
    ("src 2-D", lambda s, d, dl, v: (s[None], d[None], dl[None], v), ValueError, r"\(m,\)"),
    ("dst shorter", lambda s, d, dl, v: (s, d[:-1], dl, v), ValueError, r"\(m,\)"),
    ("delta shorter", lambda s, d, dl, v: (s, d, dl[:-1], v), ValueError, r"\(m,\)"),
    ("src int64", lambda s, d, dl, v: (s.long(), d, dl, v), TypeError, "src must be"),
    ("dst int64", lambda s, d, dl, v: (s, d.long(), dl, v), TypeError, "dst must be"),
    ("delta int32 for f32", lambda s, d, dl, v: (s, d, dl.int(), v), TypeError, "delta must be"),
    ("src on meta", lambda s, d, dl, v: (s.to("meta"), d, dl, v), ValueError, "src is on meta"),
    ("delta on meta", lambda s, d, dl, v: (s, d, dl.to("meta"), v), ValueError,
     "delta is on meta"),
    ("src strided", lambda s, d, dl, v: (s[::2], d[::2].contiguous(), dl[::2].contiguous(), v),
     ValueError, "src must be contiguous"),
    ("delta strided", lambda s, d, dl, v: (s[::2].contiguous(), d[::2].contiguous(), dl[::2], v),
     ValueError, "delta must be contiguous"),
    ("values strided", lambda s, d, dl, v: (s, d, dl, torch.stack([v, v], 1)[:, 0]), ValueError,
     "values must be contiguous"),
    ("all on meta", lambda s, d, dl, v: tuple(t.to("meta") for t in (s, d, dl, v)), ValueError,
     "unsupported device"),
]


@pytest.mark.parametrize("what,make,exc,match", REFUSED, ids=[r[0] for r in REFUSED])
def test_trimmed_wrapper_still_raises_on_every_input_it_refused(what, make, exc, match):
    """The wrapper checks the common case in one expression; every input
    that the full checks refuse is still refused, with the same error."""
    args = make(*_t(*_inputs(8, np.float32)))
    with pytest.raises(exc, match=match):
        edge_update(*args)
    if match != "unsupported device":  # the full checks alone raise the same
        with pytest.raises(exc, match=match):
            _check(*args)
