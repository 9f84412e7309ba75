"""The port's DRAM-timing plain version against the JAX reference.

``repro_torch.kernels.dram_timing.dram_timing_batch_plain`` (the CUDA
kernel's plain PyTorch version, which the port's CPU path runs) must be
bit-equal in int32 to both the reference's vmapped scan engine
(``repro.core.engine._scan_engine_batch``) and the Pallas kernel run in
interpret mode, on random batches with ragged padding, for every DRAM
preset's timings and both page policies.  The CUDA kernel itself is held
against the plain version on the card by ``chip_smoke.py``.

The kernel's matrix path cuts each trace into segments and folds their
max-plus maps; ``segmented_scan_model`` is a numpy model of that algorithm,
step for step (classes across segment edges, chunks of 32 classified as the
warp does, D x D maps saturated at NEG, groups of about sqrt(segments / 3) maps
multiplied into one, the fold reading entries below NEG / 2 as -inf), held
bit for bit against both.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core.dram import dram_config as ref_dram_config  # noqa: E402
from repro.core.engine import _scan_engine_batch  # noqa: E402
from repro.kernels.dram_timing.dram_timing import dram_timing_pallas_batch  # noqa: E402
from repro_torch.kernels._platform import LAUNCHES  # noqa: E402
from repro_torch.kernels.dram_timing import (  # noqa: E402
    MATRIX_BANKS,
    MAX_BANKS,
    dram_timing_batch,
    dram_timing_batch_plain,
    matrix_path_holds,
    plan_segments,
)
from repro_torch.kernels.dram_timing.dram_timing import _launch  # noqa: E402

PRESETS = {
    "ddr3": lambda: ref_dram_config("ddr3"),
    "default": lambda: ref_dram_config("default"),
    "hbm": lambda: ref_dram_config("hbm"),
    "hitgraph": lambda: ref_dram_config("hitgraph"),  # 2 ranks x 8 = 16 banks
    "hbm-pc": lambda: ref_dram_config("hbm", pseudo_channels=True).pseudo_channel_view(),
}


def _kwargs(cfg) -> dict:
    t = cfg.timing_cycles()
    return dict(nbanks=cfg.nbanks, tCL=t["tCL"], tRCD=t["tRCD"], tRP=t["tRP"],
                tRC=t["tRC"], tBL=t["tBL"], lookahead=16 * t["tBL"],
                page_open=cfg.page_open)


def _batch(seed: int, nbanks: int, B: int = 8, L: int = 1024):
    """Random [B, L] batch: ragged -1 padding, a narrow row range (so hits,
    misses and conflicts all occur), one all-padding row and one full row."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, L, size=B).astype(np.int32)
    lengths[0], lengths[1] = 0, L
    bank = rng.integers(0, nbanks, size=(B, L)).astype(np.int32)
    row = rng.integers(0, 4, size=(B, L)).astype(np.int32)
    pad = np.arange(L)[None, :] >= lengths[:, None]
    bank[pad], row[pad] = -1, 0
    return bank, row, lengths


@pytest.mark.parametrize("policy", ["open", "closed"])
@pytest.mark.parametrize("preset", list(PRESETS))
def test_plain_matches_scan_engine_and_pallas_bit_for_bit(preset, policy):
    cfg = dataclasses.replace(PRESETS[preset](), page_policy=policy)
    kw = _kwargs(cfg)
    bank, row, lengths = _batch(2 * list(PRESETS).index(preset) + (policy == "closed"),
                                 cfg.nbanks)

    got = dram_timing_batch_plain(torch.from_numpy(bank), torch.from_numpy(row),
                                  torch.from_numpy(lengths), **kw)
    assert got.dtype == torch.int32 and got.shape == (8, 4)
    got = got.numpy()

    scan = np.stack([np.asarray(a) for a in _scan_engine_batch(
        jnp.asarray(bank), jnp.asarray(row), **kw)], axis=1)
    pallas = np.asarray(dram_timing_pallas_batch(
        jnp.asarray(bank), jnp.asarray(row), interpret=True, **kw))
    # tolerance: none -- all three are the same int32 state machine
    np.testing.assert_array_equal(got, scan)
    np.testing.assert_array_equal(got, pallas)
    assert got[0].tolist() == [kw["tCL"], 0, 0, 0]  # all-padding row
    if policy == "open":
        assert (got[:, 1] > 0).any() and (got[:, 3] > 0).any()
    else:
        assert (got[:, 1] == 0).all() and (got[:, 3] == 0).all()


def test_padding_past_lengths_is_ignored():
    """The kernel walks only ``lengths[b]`` requests; garbage past them must
    not matter, exactly as bank == -1 padding does not."""
    cfg = ref_dram_config("default")
    kw = _kwargs(cfg)
    bank, row, lengths = _batch(7, cfg.nbanks)
    want = dram_timing_batch_plain(torch.from_numpy(bank), torch.from_numpy(row),
                                   torch.from_numpy(lengths), **kw)
    rng = np.random.default_rng(8)
    pad = np.arange(bank.shape[1])[None, :] >= lengths[:, None]
    bank[pad] = rng.integers(0, cfg.nbanks, size=int(pad.sum()))
    got = dram_timing_batch_plain(torch.from_numpy(bank), torch.from_numpy(row),
                                  torch.from_numpy(lengths), **kw)
    assert torch.equal(got, want)


def test_wrapper_takes_plain_version_on_cpu_and_counts_no_launch():
    cfg = ref_dram_config("hbm")
    kw = _kwargs(cfg)
    args = [torch.from_numpy(a) for a in _batch(3, cfg.nbanks)]
    before = LAUNCHES["dram_timing"]
    assert torch.equal(dram_timing_batch(*args, **kw),
                       dram_timing_batch_plain(*args, **kw))
    assert LAUNCHES["dram_timing"] == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    kw = _kwargs(ref_dram_config("default"))
    bank, row, lengths = (torch.from_numpy(a) for a in _batch(4, 16))
    with pytest.raises(TypeError, match="int32"):
        dram_timing_batch(bank.long(), row, lengths, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        dram_timing_batch(bank.t().contiguous().t(), row, lengths, **kw)
    with pytest.raises(ValueError, match=r"\[B, L\]"):
        dram_timing_batch(bank[0], row[0], lengths, **kw)
    with pytest.raises(ValueError, match="lengths"):
        dram_timing_batch(bank, row, lengths[:3], **kw)
    with pytest.raises(ValueError, match="nbanks"):
        dram_timing_batch(bank, row, lengths, **{**kw, "nbanks": MAX_BANKS + 1})


# ---------------------------------------------------------------------------
# the matrix path's algorithm (csrc/dram_timing.cu, kernels 1-5) in numpy
# ---------------------------------------------------------------------------

NEG = -(1 << 30)
NONE = np.iinfo(np.int32).min
_TIMING = ("nbanks", "tRCD", "tRP", "tRC", "tBL", "lookahead")


def segmented_scan_model(bank, row, lengths, segments, *, nbanks, tCL, tRCD, tRP,
                         tRC, tBL, lookahead, page_open=True):
    """Int32 ``[B, 4]`` as the kernel's matrix path computes it with each
    trace cut into ``segments`` pieces of ceil(L / segments) requests."""
    B, L = bank.shape
    nb, D = nbanks, 2 * nbanks + 2
    seg = -(-L // segments)
    lens = np.clip(lengths, 0, L)

    def bounds(b, s):
        return s * seg, min((s + 1) * seg, int(lens[b]))

    # kernel 1: the last row each segment leaves in each bank
    last = np.full((B, segments, nb), NONE, np.int64)
    for b in range(B):
        for s in range(segments):
            lo, hi = bounds(b, s)
            for i in range(lo, hi):
                if bank[b, i] >= 0:
                    last[b, s, bank[b, i]] = row[b, i]
    # kernel 2: exclusive scan -> each bank's open row at each segment's start
    open0 = np.empty_like(last)
    for b in range(B):
        carry = np.full(nb, -1, np.int64)
        for s in range(segments):
            open0[b, s] = carry
            carry = np.where(last[b, s] != NONE, last[b, s], carry)

    zc = np.full(D, NEG, np.int64)
    zc[0] = 0
    out = np.zeros((B, 4), np.int64)
    for b in range(B):
        x = np.zeros(D, np.int64)  # (0, bus_free, last_act.., last_data..)
        x[2:2 + nb] = -(tRC + 1)
        counts = np.zeros(3, np.int64)
        maps = []
        for s in range(segments):
            lo, hi = bounds(b, s)
            if lo >= hi:
                break  # this and later segments are empty: no map, no fold step
            # kernel 3: classes, 32 requests at a time, as the warp finds them
            opened = open0[b, s].copy()
            classes = []  # (bank, is_hit, is_conf) of each valid request
            for c0 in range(lo, hi, 32):
                chunk = [(int(bank[b, i]), int(row[b, i])) for i in range(c0, min(c0 + 32, hi))]
                for lane, (k, r) in enumerate(chunk):
                    if k < 0:
                        continue
                    prev = [rr for kk, rr in chunk[:lane] if kk == k]
                    cur = prev[-1] if prev else int(opened[k])
                    hit, miss = (cur == r, cur == -1) if page_open else (False, True)
                    counts += (hit, miss, page_open and not hit and not miss)
                    classes.append((k, hit, page_open and not hit and not miss))
                for k, r in chunk:
                    if k >= 0:
                        opened[k] = r
            # the segment's map, from the identity, a row a state
            M = np.full((D, D), NEG, np.int64)
            np.fill_diagonal(M, 0)
            for k, hit, conf in classes:
                bf, a, d = M[1], M[2 + k], M[2 + nb + k]
                horizon = np.maximum(bf - lookahead, zc)
                if hit:
                    t_act, ready = a, np.maximum(a + tRCD, zc)
                elif conf:
                    t_act = np.maximum(np.maximum(d, horizon) + tRP, a + tRC)
                    ready = t_act + tRCD
                else:
                    t_act = np.maximum(np.maximum(a + tRC, d), horizon)
                    ready = t_act + tRCD
                slot_end = np.maximum(ready, bf) + tBL
                M[2 + k], M[2 + nb + k], M[1] = t_act, slot_end, slot_end
            # saturation: no entry below NEG, none near the int32 edges
            assert M.min() >= NEG and M.max() < 1 << 29
            maps.append(M)
        # kernel 4: groups of G maps multiplied into one (an entry at or
        # below NEG / 2 is -inf, stored as NEG)
        G = next(g for g in range(1, segments + 1) if 3 * g * g >= segments)
        G = 1 if G < 3 else G
        products = []
        for first in range(0, len(maps), G):
            P = maps[first]
            for M in maps[first + 1:first + G]:
                P = (M[:, :, None] + P[None, :, :]).max(1)
                assert P.min() >= 2 * NEG  # no int32 wrap
                P = np.where(P > NEG // 2, P, NEG)
            products.append(P)
        # kernel 5: the fold
        for P in products:
            x = np.where(P > NEG // 2, P + x[None, :], NONE).max(1)
        out[b] = (x[1] + tCL, *counts)
    assert np.abs(out).max() < 1 << 31
    return out.astype(np.int32)


def _model_batch(seed: int, nbanks: int, B: int = 6, L: int = 256):
    """Ragged lengths, an all-padding row and a full one, -1 banks inside
    the lengths, and row -1 requests (a hit and a miss on a closed bank)."""
    bank, row, lengths = _batch(seed, nbanks, B=B, L=L)
    rng = np.random.default_rng(seed + 100)
    live = np.arange(L)[None, :] < lengths[:, None]
    row[live & (rng.random((B, L)) < 0.1)] = -1
    bank[live & (rng.random((B, L)) < 0.03)] = -1
    return bank, row, lengths


@pytest.mark.parametrize("segments", [1, 2, 7, 30, 300])  # 300 > L: empty segments
@pytest.mark.parametrize("policy", ["open", "closed"])
@pytest.mark.parametrize("preset", list(PRESETS))
def test_segmented_scan_model_matches_plain_and_scan_engine(preset, policy, segments):
    cfg = dataclasses.replace(PRESETS[preset](), page_policy=policy)
    kw = _kwargs(cfg)
    assert matrix_path_holds(256, **{k: kw[k] for k in _TIMING})
    bank, row, lengths = _model_batch(10 * list(PRESETS).index(preset) + segments,
                                      cfg.nbanks)
    got = segmented_scan_model(bank, row, lengths, segments, **kw)
    plain = dram_timing_batch_plain(torch.from_numpy(bank), torch.from_numpy(row),
                                    torch.from_numpy(lengths), **kw).numpy()
    # the reference scan has no lengths: cut the rows with -1 padding
    cut = np.where(np.arange(bank.shape[1])[None, :] < lengths[:, None], bank, -1)
    scan = np.stack([np.asarray(a) for a in _scan_engine_batch(
        jnp.asarray(cut), jnp.asarray(row), **kw)], axis=1)
    # tolerance: none -- max and + are exact in int32
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, scan)
    assert got[0].tolist() == [kw["tCL"], 0, 0, 0]
    if policy == "open":
        assert (got[:, 1] > 0).any() and (got[:, 3] > 0).any()


def test_plan_segments_cuts_long_batches_and_walks_the_rest():
    kw = {k: _kwargs(ref_dram_config("hitgraph"))[k] for k in _TIMING}
    kw["warps"] = 132 * 32  # an H100 SXM's 132 SMs, 32 warps each
    # the path's largest call: a few long traces fill the card by segments
    assert plan_segments(2, 262_144, **kw) == 1024  # segments of 256 requests
    assert plan_segments(8, 2048, **kw) == 8
    assert plan_segments(16, 262_144, **kw) == 264  # B x segments fill the card
    assert plan_segments(16, 262_144, **{**kw, "warps": 114 * 32}) == 228  # fewer SMs
    assert plan_segments(8, 256, **kw) == 1  # too short to cut
    assert plan_segments(4096, 1 << 20, **kw) == 2  # B alone nearly fills it
    assert plan_segments(2, 262_144, **{**kw, "nbanks": MATRIX_BANKS + 1}) == 1
    assert plan_segments(2, 262_144, **{**kw, "tRCD": kw["tRC"] + 2}) == 1
    assert plan_segments(2, 262_144, **{**kw, "tRP": -1}) == 1
    assert plan_segments(0, 262_144, **kw) == 1


def test_wrapper_on_cpu_takes_plain_version_whatever_the_segments():
    # the wrapper plans no segments on the CPU; only ``_launch`` takes a
    # count, and it launches the kernels on CUDA tensors or raises
    cfg = ref_dram_config("default")
    kw = _kwargs(cfg)
    args = [torch.from_numpy(a) for a in _batch(5, cfg.nbanks)]
    want = dram_timing_batch_plain(*args, **kw)
    before = LAUNCHES["dram_timing"]
    assert torch.equal(dram_timing_batch(*args, **kw), want)
    for segments in (1, 3):
        with pytest.raises(ValueError, match="CUDA tensors"):
            _launch(*args, segments, **kw)
    assert LAUNCHES["dram_timing"] == before


@pytest.mark.parametrize("segments, nbanks", [(0, 16), (-1, 8), (3, MATRIX_BANKS + 1)])
def test_launch_refuses_segment_counts_that_do_not_hold(segments, nbanks):
    cfg = ref_dram_config("default")
    kw = {**_kwargs(cfg), "nbanks": nbanks}
    args = [torch.from_numpy(a) for a in _batch(6, nbanks)]
    with pytest.raises(ValueError, match="segments do not hold"):
        _launch(*args, segments, **kw)
