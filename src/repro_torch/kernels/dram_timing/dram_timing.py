"""DRAM bank state-machine timing: the CUDA kernel's wrapper and its plain
PyTorch version.

``dram_timing_batch`` times every row of a padded ``[B, L]`` bank/row batch
(bank == -1 marks a no-op; ``lengths[b]`` true requests per row) and returns
int32 ``[B, 4]``: (cycles + tCL, hits, misses, conflicts).  On a CUDA tensor
it launches the hand-written kernel ``csrc/dram_timing.cu`` (the port of
``repro/kernels/dram_timing/dram_timing.py::dram_timing_pallas_batch``) or
raises; on a CPU tensor it takes ``dram_timing_batch_plain``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._platform import LAUNCHES

MAX_BANKS = 128  # the kernel's shared-memory bank-state capacity

_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = _build.load("dram_timing").dram_timing_batch_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(bank: torch.Tensor, row: torch.Tensor, lengths: torch.Tensor,
           nbanks: int) -> None:
    if bank.dim() != 2 or row.shape != bank.shape:
        raise ValueError(f"bank/row must be equal [B, L], got {tuple(bank.shape)} "
                         f"and {tuple(row.shape)}")
    if lengths.shape != (bank.shape[0],):
        raise ValueError(f"lengths must be [B={bank.shape[0]}], got {tuple(lengths.shape)}")
    for name, t in (("bank", bank), ("row", row), ("lengths", lengths)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != bank.device:
            raise ValueError(f"{name} is on {t.device}, bank on {bank.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 0 < nbanks <= MAX_BANKS:
        raise ValueError(f"nbanks must be in 1..{MAX_BANKS}, got {nbanks}")


def dram_timing_batch(bank: torch.Tensor, row: torch.Tensor,
                      lengths: torch.Tensor, *, nbanks: int, tCL: int,
                      tRCD: int, tRP: int, tRC: int, tBL: int, lookahead: int,
                      page_open: bool = True) -> torch.Tensor:
    """Time a ``[B, L]`` batch; returns int32 ``[B, 4]`` on bank's device.

    CUDA tensors launch the kernel on the current stream (no sync); CPU
    tensors take the plain version.  Anything else raises."""
    _check(bank, row, lengths, nbanks)
    kw = dict(nbanks=nbanks, tCL=tCL, tRCD=tRCD, tRP=tRP, tRC=tRC, tBL=tBL,
              lookahead=lookahead, page_open=page_open)
    if bank.device.type == "cpu":
        return dram_timing_batch_plain(bank, row, lengths, **kw)
    if bank.device.type != "cuda":
        raise ValueError(f"unsupported device {bank.device}")
    B, L = bank.shape
    out = torch.empty((B, 4), dtype=torch.int32, device=bank.device)
    if B == 0:
        return out
    stream = torch.cuda.current_stream(bank.device).cuda_stream
    with torch.cuda.device(bank.device):
        err = _kernel_fn()(bank.data_ptr(), row.data_ptr(), lengths.data_ptr(),
                           out.data_ptr(), B, L, nbanks, tCL, tRCD, tRP, tRC,
                           tBL, lookahead, int(bool(page_open)), stream)
    if err != 0:
        raise RuntimeError(f"dram_timing kernel launch failed: CUDA error {err}")
    LAUNCHES["dram_timing"] += 1
    return out


def dram_timing_batch_plain(bank: torch.Tensor, row: torch.Tensor,
                            lengths: torch.Tensor, *, nbanks: int, tCL: int,
                            tRCD: int, tRP: int, tRC: int, tBL: int,
                            lookahead: int, page_open: bool = True) -> torch.Tensor:
    """The same function in plain PyTorch: a Python loop over the request
    axis, vectorised over B, in int32, with the reference's update rules
    (``repro/core/engine.py::_scan_engine_impl``).  A request is valid when
    its bank is >= 0 and it lies before ``lengths[b]``; an invalid one
    leaves every state unchanged."""
    B, L = bank.shape
    dev = bank.device
    i32 = torch.int32
    # per-bank state [B, nbanks, 4]: open_row, row_ready, last_data, last_act
    state = torch.zeros((B, nbanks, 4), dtype=i32, device=dev)
    state[:, :, 0] = -1
    state[:, :, 3] = -(tRC + 1)
    bus_free = torch.zeros(B, dtype=i32, device=dev)
    valid_all = (bank >= 0) & (torch.arange(L, device=dev)[None, :]
                               < lengths.to(torch.int64)[:, None])
    idx_all = bank.clamp_min(0).to(torch.int64)[:, :, None, None].expand(B, L, 1, 4)
    steps = min(int(lengths.max()), L) if B else 0
    hit_log = torch.zeros((max(steps, 1), B), dtype=torch.bool, device=dev)
    miss_log = torch.zeros((max(steps, 1), B), dtype=torch.bool, device=dev)
    for i in range(steps):
        valid = valid_all[:, i]
        r = row[:, i]
        idx = idx_all[:, i]
        st = state.gather(1, idx).squeeze(1)
        cur, ready_b, data_b, act_b = st.unbind(1)
        if page_open:
            is_hit = (cur == r) & valid
            is_miss = (cur == -1) & valid
            is_conf = valid & ~(is_hit | is_miss)
        else:
            is_hit = torch.zeros_like(valid)
            is_miss = valid
            is_conf = is_hit

        horizon = (bus_free - lookahead).clamp_min(0)
        act_rc = act_b + tRC
        t_act_conf = torch.maximum(torch.maximum(data_b, horizon) + tRP, act_rc)
        t_act_miss = torch.maximum(torch.maximum(act_rc, data_b), horizon)
        t_act = torch.where(is_conf, t_act_conf, t_act_miss)
        new_ready = torch.where(is_hit, ready_b, t_act + tRCD)
        slot_end = torch.maximum(new_ready, bus_free) + tBL
        bus_free = torch.where(valid, slot_end, bus_free)

        new = torch.stack([r, new_ready, slot_end,
                           torch.where(is_hit, act_b, t_act)], 1)
        state.scatter_(1, idx, torch.where(valid[:, None], new, st).unsqueeze(1))
        hit_log[i] = is_hit
        miss_log[i] = is_miss
    hits = hit_log.sum(0, dtype=i32)
    misses = miss_log.sum(0, dtype=i32)
    n_valid = valid_all.sum(1, dtype=i32)
    # a request is exactly one of hit/miss/conflict unless it is both a
    # hit and a miss (row -1 on a closed bank), which the reference counts
    # in both and never as a conflict
    both = (hit_log & miss_log).sum(0, dtype=i32)
    confs = n_valid - hits - misses + both if page_open else torch.zeros_like(hits)
    return torch.stack([bus_free + tCL, hits, misses, confs], 1)
