"""The port's DRAM-timing plain version against the JAX reference.

``repro_torch.kernels.dram_timing.dram_timing_batch_plain`` (the CUDA
kernel's plain PyTorch version, which the port's CPU path runs) must be
bit-equal in int32 to both the reference's vmapped scan engine
(``repro.core.engine._scan_engine_batch``) and the Pallas kernel run in
interpret mode, on random batches with ragged padding, for every DRAM
preset's timings and both page policies.  The CUDA kernel itself is held
against the plain version on the card by ``chip_smoke.py``.
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
    MAX_BANKS,
    dram_timing_batch,
    dram_timing_batch_plain,
)

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
