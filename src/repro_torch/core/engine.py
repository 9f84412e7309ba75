"""DRAM timing engines.

Two engines with identical request-level semantics:

1. The exact sequential model: per-bank state carried request by request.
   On the CUDA card it is the hand-written kernel
   ``repro_torch/csrc/dram_timing.cu`` (each trace cut into segments whose
   max-plus maps are folded, or walked directly); on the CPU its plain
   PyTorch version
   (``repro_torch.kernels.dram_timing.dram_timing_batch_plain``).  Both are
   bit-equal to the reference's ``repro.core.engine._scan_engine_impl``.
   It is the default for small and medium traces.

2. ``simulate_channel_fast`` — a fully-vectorised analytic model: row
   hit/miss/conflict classification is *exact* (it only depends on the
   previous request to the same bank, computable with a stable sort), and
   the execution time is approximated as the max of the bus-occupancy bound
   and the busiest-bank latency bound.  Used for very long traces.

Both engines also exist in *batched* form: :class:`TraceBatch` packs many
traces into padded ``[B, L]`` bank/row arrays (power-of-two bucketing on
both axes) and :func:`simulate_batch` / :func:`simulate_many` time a whole
batch with a single kernel launch per (timing-config, length-bucket) group
instead of one launch and one blocking host sync per trace.  The batched
path produces *identical* ``TimingReport`` s to the per-trace path: padding
requests are no-ops, so the bucket length never affects results.

Memory-controller configuration lives on
:class:`repro_torch.core.dram.DRAMConfig` and threads through both engines:

- address mapping (``cfg.mapping``): :func:`decode` delegates to the
  vectorised ``repro_torch.core.dram.decode_lines`` (row-interleaved
  default, bank-interleaved, XOR bank permutation);
- page policy (``cfg.page_policy``): under ``closed`` every access
  auto-precharges — all requests are misses (activate on the critical
  path), conflicts cannot occur, and both engines take the closed-page
  path via the ``page_open`` flag;
- HBM pseudo-channels (``cfg.pseudo_channels``): :func:`simulate_dram`
  deals every channel trace across two pseudo-channels (at the mapping's
  channel-interleave granularity) and times each against
  ``cfg.pseudo_channel_view()`` — half bus width, half banks.

Every entry point takes ``device=None``: the CUDA card, raising when there
is none; ``device="cpu"`` takes the plain version.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.dram import DRAMConfig, decode_lines
from repro_torch.core.trace import Trace, split_round_robin
from repro_torch.kernels._platform import resolve_device
from repro_torch.kernels.dram_timing import dram_timing_batch

# Version tag of the simulation semantics (accelerator models + DRAM timing
# engines).  Bump whenever a change alters simulation *results*; the sweep
# result cache (repro.sweep.cache) keys on it, so stale cached reports are
# invalidated automatically.
# v2: bw_utilization denominator unified on actual channels used (previously
# simulate_phased divided by cfg.channels, simulate_dram by len(traces)).
# v3: proportional_interleave breaks virtual-time ties by exact lexsort
# instead of an i*1e-12 float epsilon — merge order changes for streams
# whose position gaps fall below the epsilon (length products > ~5e11).
# v4: semantic-engine axis (AccelConfig.semexec, numpy | device) joins the
# cache key; device-resident execution is byte-identical on traces but acc
# problems (pr/spmv) reduce in a different association order, so values can
# differ within float tolerance — results move to new addresses.
ENGINE_VERSION = "4"

# Default request-count threshold of the "auto" engine policy: traces up to
# this many requests use the exact scan engine, longer ones the analytic
# fast engine.
SCAN_CUTOFF = 2_000_000

# Cap on B*L elements of one batched dispatch (keeps padded request arrays
# a few dozen MB); larger groups are split into several dispatches.
MAX_BATCH_ELEMS = 4 << 20


def select_engine(trace_len: int, engine: str = "auto",
                  scan_cutoff: int = SCAN_CUTOFF) -> str:
    """The single engine-selection policy: resolve ``engine`` ("auto" |
    "scan" | "fast") for a trace of ``trace_len`` requests."""
    if engine == "auto":
        return "scan" if trace_len <= scan_cutoff else "fast"
    if engine not in ("scan", "fast"):
        raise ValueError(f"unknown engine {engine!r} (use auto|scan|fast)")
    return engine


# ---------------------------------------------------------------------------
# dispatch accounting
# ---------------------------------------------------------------------------

# Dispatch counters (exact-engine invocations; the fast engine is host-side
# numpy and launches nothing).  Equal to the reference's for the same
# inputs: dedup, bucketing and chunking are the same.
_DISPATCH = dict(dispatches=0, traces=0, requests=0)


def reset_dispatch_stats() -> None:
    _DISPATCH.update(dispatches=0, traces=0, requests=0)


def dispatch_stats() -> dict:
    """Counters since the last reset: device ``dispatches``, ``traces``
    timed through them, and true (unpadded) ``requests`` simulated."""
    return dict(_DISPATCH)


def _record_dispatch(n_traces: int, n_requests: int) -> None:
    _DISPATCH["dispatches"] += 1
    _DISPATCH["traces"] += n_traces
    _DISPATCH["requests"] += n_requests


@dataclasses.dataclass
class TimingReport:
    time_ns: float
    cycles: int
    hits: int
    misses: int
    conflicts: int
    bytes_total: int
    bytes_read: int
    bytes_written: int
    requests: int
    channels_used: int
    bw_utilization: float  # achieved / peak over the busy window

    @staticmethod
    def zero() -> "TimingReport":
        return TimingReport(0.0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0.0)

    def to_dict(self) -> dict:
        """Plain-scalar dict (JSON round-trip via ``from_dict``)."""
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "TimingReport":
        return TimingReport(**d)


def decode(lines: np.ndarray, cfg: DRAMConfig) -> tuple[np.ndarray, np.ndarray]:
    """line index -> (bank, row) under the config's address mapping."""
    return decode_lines(lines, cfg)


def _exact_engine_batch(bank: np.ndarray, row: np.ndarray, lengths: np.ndarray,
                       cfg: DRAMConfig, device: torch.device) -> np.ndarray:
    """Exact sequential engine over a padded ``[B, L]`` batch (one copy to
    ``device``, one kernel launch, one host sync).  ``lengths`` holds the
    true request counts of the first rows; the rest are all padding.
    Returns int64 ``[B, 4]``: (cycles, hits, misses, conflicts)."""
    B = bank.shape[0]
    lens = np.zeros(B, dtype=np.int32)
    lens[: len(lengths)] = lengths
    t = cfg.timing_cycles()
    out = dram_timing_batch(
        torch.from_numpy(bank).to(device), torch.from_numpy(row).to(device),
        torch.from_numpy(lens).to(device), nbanks=cfg.nbanks,
        tCL=t["tCL"], tRCD=t["tRCD"], tRP=t["tRP"], tRC=t["tRC"], tBL=t["tBL"],
        lookahead=16 * t["tBL"], page_open=cfg.page_open,
    )
    return out.cpu().numpy().astype(np.int64)


def classify_fast(bank: np.ndarray, row: np.ndarray, nbanks: int,
                  page_open: bool = True) -> np.ndarray:
    """Exact hit(0)/miss(1)/conflict(2) classification, vectorised.

    A request's class depends only on the previous request to the same bank
    (open-page policy), independent of timing.  Under the closed-page
    policy every request auto-precharges its row, so all requests are
    misses."""
    n = len(bank)
    if n == 0:
        return np.zeros(0, dtype=np.int8)
    if not page_open:
        return np.ones(n, dtype=np.int8)
    order = np.argsort(bank, kind="stable")
    sb, sr = bank[order], row[order]
    same_bank = sb[1:] == sb[:-1]
    cls_sorted = np.full(n, 1, dtype=np.int8)  # first touch of a bank: miss
    hit = np.zeros(n, dtype=bool)
    conf = np.zeros(n, dtype=bool)
    hit[1:] = same_bank & (sr[1:] == sr[:-1])
    conf[1:] = same_bank & (sr[1:] != sr[:-1])
    cls_sorted[hit] = 0
    cls_sorted[conf] = 2
    cls = np.empty(n, dtype=np.int8)
    cls[order] = cls_sorted
    return cls


def _pow2_bucket(n: int, minimum: int = 256) -> int:
    """Smallest power-of-two >= n (>= minimum): the padded size class, so
    the jitted engines compile once per bucket instead of once per shape."""
    target = minimum
    while target < n:
        target *= 2
    return target


def _pad_pow2(bank: np.ndarray, row: np.ndarray, minimum: int = 256):
    """Pad request arrays to the next power of two so the jitted scan engine
    compiles once per size class instead of once per trace length."""
    target = _pow2_bucket(len(bank), minimum)
    pad = target - len(bank)
    if pad:
        bank = np.concatenate([bank, np.full(pad, -1, dtype=bank.dtype)])
        row = np.concatenate([row, np.zeros(pad, dtype=row.dtype)])
    return bank, row


@dataclasses.dataclass
class TraceBatch:
    """A batch of decoded traces packed into padded ``[B, L]`` arrays.

    ``bank`` rows are padded with -1 (engine no-ops); both L (request axis)
    and B (batch axis) are padded to power-of-two buckets so the batched
    engines compile once per (B, L) size class.  ``lengths`` holds the true
    per-trace request counts; rows past ``size`` are pure padding.
    """

    bank: np.ndarray  # [B, L] int32, -1 padded
    row: np.ndarray  # [B, L] int32
    lengths: np.ndarray  # [size] int64 true request counts
    traces: list[Trace]  # originals, for byte/request accounting

    @property
    def size(self) -> int:
        """Number of real traces (the batch axis may be padded beyond)."""
        return len(self.traces)

    @property
    def bucket_len(self) -> int:
        return int(self.bank.shape[1])

    @staticmethod
    def from_traces(
        traces: Sequence[Trace],
        cfg: DRAMConfig,
        min_len: int = 256,
        pad_batch: bool = True,
    ) -> "TraceBatch":
        """Decode + pack traces (empty ones become all-padding rows).  The
        request axis is padded to the power-of-two bucket of the longest
        trace; the batch axis to a power of two when ``pad_batch``."""
        lengths = np.array([t.n for t in traces], dtype=np.int64)
        L = _pow2_bucket(int(lengths.max()) if len(traces) else 0, min_len)
        B = _pow2_bucket(max(len(traces), 1), 1) if pad_batch else max(len(traces), 1)
        bank = np.full((B, L), -1, dtype=np.int32)
        row = np.zeros((B, L), dtype=np.int32)
        scratch = None  # shared line buffer for the fused lazy-emit path
        for i, t in enumerate(traces):
            if not t.n:
                continue
            emit = getattr(t, "emit_bank_row", None)
            if emit is not None:
                # lazy trace IR: materialise directly into the padded batch
                # buffers (one pass, no per-combinator intermediates)
                if scratch is None:
                    scratch = np.empty(L, dtype=np.int64)
                emit(bank[i, : t.n], row[i, : t.n], cfg, scratch)
            else:
                bank[i, : t.n], row[i, : t.n] = decode(t.lines, cfg)
        return TraceBatch(bank, row, lengths, list(traces))


def _channel_report(trace: Trace, cfg: DRAMConfig, cycles: int,
                    hits: int, misses: int, conflicts: int) -> TimingReport:
    """Single-channel report from engine counters (shared by the per-trace
    and batched paths, so both construct bit-identical reports)."""
    time_ns = cycles * cfg.tCK_ns
    peak_bytes = time_ns * cfg.bw_per_channel  # GB/s == B/ns
    return TimingReport(
        time_ns=time_ns,
        cycles=cycles,
        hits=hits,
        misses=misses,
        conflicts=conflicts,
        bytes_total=trace.bytes,
        bytes_read=trace.read_bytes,
        bytes_written=trace.write_bytes,
        requests=trace.n,
        channels_used=1,
        bw_utilization=trace.bytes / max(peak_bytes, 1e-9),
    )


def simulate_channel_scan(trace: Trace, cfg: DRAMConfig,
                          device=None) -> TimingReport:
    dev = resolve_device(device)
    if trace.n == 0:
        return TimingReport.zero()
    bank, row = decode(trace.lines, cfg)
    bank, row = _pad_pow2(bank, row)
    out = _exact_engine_batch(bank[None], row[None], np.array([trace.n]),
                              cfg, dev)
    _record_dispatch(1, trace.n)
    cycles, hits, misses, conflicts = out[0]
    return _channel_report(trace, cfg, int(cycles), int(hits), int(misses),
                           int(conflicts))


def _closed_page_chain_bound(n: int, same_bank_adjacent: int,
                             t: dict[str, int]) -> int:
    """Closed-page program-order bound: every request activates, and
    back-to-back activates in one bank serialise at tRC — for row-mapped
    sequential streams that is (almost) *every* adjacent pair, which the
    per-bank total wildly underestimates (requests to one bank are
    consecutive, so their tRC chain cannot overlap other banks)."""
    return n * t["tBL"] + same_bank_adjacent * max(t["tRC"] - t["tBL"], 0)


def _fast_cycles(n: int, cls: np.ndarray, bank: np.ndarray, cfg: DRAMConfig,
                 t: dict[str, int]) -> tuple[int, int, int, int]:
    """Shared analytic-time formula on a single trace's classification."""
    hits = int((cls == 0).sum())
    misses = int((cls == 1).sum())
    conflicts = int((cls == 2).sum())
    bus_bound = n * t["tBL"]
    # per-bank serial chain: hits stream at the bus rate; a miss costs
    # max(tRC, tRCD+tBL) in its bank, a conflict max(tRC, tRP+tRCD+tBL)
    # (matching the scan engine's per-bank dependency chain).
    miss_cost = max(t["tRC"], t["tRCD"] + t["tBL"])
    conf_cost = max(t["tRC"], t["tRP"] + t["tRCD"] + t["tBL"])
    act_cost = np.where(cls == 0, t["tBL"], np.where(cls == 1, miss_cost, conf_cost))
    per_bank = np.bincount(bank, weights=act_cost, minlength=cfg.nbanks)
    bank_bound = int(per_bank.max())
    if not cfg.page_open:
        adj = int((bank[1:] == bank[:-1]).sum()) if n > 1 else 0
        bank_bound = max(bank_bound, _closed_page_chain_bound(n, adj, t))
    cycles = int(max(bus_bound, bank_bound)) + t["tCL"]
    return cycles, hits, misses, conflicts


def simulate_channel_fast(trace: Trace, cfg: DRAMConfig) -> TimingReport:
    """Analytic engine: exact request classification, approximate time.

    time ~= max( bus bound, busiest-bank latency bound ) where the bank
    bound accounts for tRC-limited back-to-back activates."""
    if trace.n == 0:
        return TimingReport.zero()
    bank, row = decode(trace.lines, cfg)
    cls = classify_fast(bank, row, cfg.nbanks, cfg.page_open)
    t = cfg.timing_cycles()
    cycles, hits, misses, conflicts = _fast_cycles(trace.n, cls, bank, cfg, t)
    return _channel_report(trace, cfg, cycles, hits, misses, conflicts)


def _classify_fast_batch(bank: np.ndarray, row: np.ndarray, valid: np.ndarray,
                         nbanks: int, page_open: bool = True) -> np.ndarray:
    """Batched exact classification on padded [B, L] arrays.  Padding slots
    get sort-key ``nbanks`` (past any real bank) so the stable per-row sort
    orders real requests exactly as the per-trace classifier; entries at
    ``~valid`` positions are garbage and must be masked by the caller."""
    B, L = bank.shape
    if not page_open:  # closed page: every valid request is a miss
        return np.ones((B, L), dtype=np.int8)
    bkey = np.where(valid, bank, np.int32(nbanks))
    order = np.argsort(bkey, axis=1, kind="stable")
    sb = np.take_along_axis(bkey, order, axis=1)
    sr = np.take_along_axis(row, order, axis=1)
    same_bank = sb[:, 1:] == sb[:, :-1]
    cls_sorted = np.full((B, L), 1, dtype=np.int8)
    hit = np.zeros((B, L), dtype=bool)
    conf = np.zeros((B, L), dtype=bool)
    hit[:, 1:] = same_bank & (sr[:, 1:] == sr[:, :-1])
    conf[:, 1:] = same_bank & (sr[:, 1:] != sr[:, :-1])
    cls_sorted[hit] = 0
    cls_sorted[conf] = 2
    cls = np.empty((B, L), dtype=np.int8)
    np.put_along_axis(cls, order, cls_sorted, axis=1)
    return cls


def _simulate_fast_batch(traces: list[Trace], cfg: DRAMConfig) -> list[TimingReport]:
    """Batched analytic engine: one vectorised pass over padded [B, L]
    arrays.  All arithmetic is integer-exact (cycle counts summed in
    float64 stay below 2**53), so results equal the per-trace fast engine
    bit-for-bit."""
    batch = TraceBatch.from_traces(traces, cfg, pad_batch=False)
    B, L = batch.bank.shape  # pad_batch=False keeps B == len(traces)
    valid = np.arange(L)[None, :] < batch.lengths[:, None]
    cls = _classify_fast_batch(batch.bank, batch.row, valid, cfg.nbanks,
                               cfg.page_open)
    t = cfg.timing_cycles()
    miss_cost = max(t["tRC"], t["tRCD"] + t["tBL"])
    conf_cost = max(t["tRC"], t["tRP"] + t["tRCD"] + t["tBL"])
    act_cost = np.where(cls == 0, t["tBL"], np.where(cls == 1, miss_cost, conf_cost))
    act_cost = np.where(valid, act_cost, 0)
    flat_bank = (np.arange(B)[:, None] * cfg.nbanks
                 + np.where(valid, batch.bank, 0)).ravel()
    per_bank = np.bincount(
        flat_bank, weights=act_cost.ravel().astype(np.float64),
        minlength=B * cfg.nbanks,
    ).reshape(B, cfg.nbanks)
    if not cfg.page_open:
        # closed-page chain bound (see _closed_page_chain_bound); padding is
        # a suffix, so masking the trailing element of each pair suffices
        adj = ((batch.bank[:, 1:] == batch.bank[:, :-1]) & valid[:, 1:])
        adj_counts = adj.sum(axis=1)
    reports = []
    for i, tr in enumerate(traces):
        if tr.n == 0:
            reports.append(TimingReport.zero())
            continue
        v = valid[i]
        hits = int(((cls[i] == 0) & v).sum())
        misses = int(((cls[i] == 1) & v).sum())
        conflicts = int(((cls[i] == 2) & v).sum())
        bus_bound = tr.n * t["tBL"]
        bank_bound = int(per_bank[i].max())
        if not cfg.page_open:
            bank_bound = max(bank_bound, _closed_page_chain_bound(
                tr.n, int(adj_counts[i]), t))
        cycles = int(max(bus_bound, bank_bound)) + t["tCL"]
        reports.append(_channel_report(tr, cfg, cycles, hits, misses, conflicts))
    return reports


def _chunk(seq: list, size: int):
    for i in range(0, len(seq), size):
        yield seq[i : i + size]


def simulate_sequential(
    traces: Sequence[Trace],
    cfg: DRAMConfig,
    engine: str = "auto",
    scan_cutoff: int = SCAN_CUTOFF,
    device=None,
) -> list[TimingReport]:
    """The one-dispatch-per-trace path: the equivalence oracle for the
    batched engines (and the benchmark baseline)."""
    dev = resolve_device(device)
    return [
        simulate_channel_scan(tr, cfg, dev)
        if select_engine(tr.n, engine, scan_cutoff) == "scan"
        else simulate_channel_fast(tr, cfg)
        for tr in traces
    ]


def simulate_batch(
    traces: Sequence[Trace],
    cfg: DRAMConfig,
    engine: str = "auto",
    scan_cutoff: int = SCAN_CUTOFF,
    device=None,
) -> list[TimingReport]:
    """Time many single-channel traces with a handful of kernel launches.

    Traces routed to the exact engine are grouped into power-of-two length
    buckets; each bucket is one :class:`TraceBatch` and one kernel launch
    (split only past :data:`MAX_BATCH_ELEMS`).
    Fast-engine traces go through one vectorised host-side pass.  Returns
    per-trace reports in input order, identical to calling
    ``simulate_channel_scan`` / ``simulate_channel_fast`` per trace.

    Lazy-IR traces carry a structural key, so *byte-identical* streams —
    e.g. the static per-partition streams an accelerator emits every
    iteration, or identical traces from scenarios differing only in the
    problem axis — are simulated once per timing config and the report is
    shared.  The request-level model is deterministic per (stream, config),
    so deduplication is exact.
    """
    dev = resolve_device(device)
    reports: list[TimingReport | None] = [None] * len(traces)
    by_bucket: dict[int, list[int]] = {}
    fast_by_bucket: dict[int, list[int]] = {}
    canonical: dict = {}  # structural key -> representative index
    dup_of: dict[int, int] = {}
    for i, tr in enumerate(traces):
        if tr.n == 0:
            reports[i] = TimingReport.zero()
            continue
        skey = getattr(tr, "structural_key", None)
        if skey is not None:
            key = skey()
            rep_i = canonical.setdefault(key, i)
            if rep_i != i:
                dup_of[i] = rep_i
                continue
        if select_engine(tr.n, engine, scan_cutoff) == "scan":
            by_bucket.setdefault(_pow2_bucket(tr.n), []).append(i)
        else:
            fast_by_bucket.setdefault(_pow2_bucket(tr.n), []).append(i)

    for L, idxs in sorted(by_bucket.items()):
        for chunk in _chunk(idxs, max(1, MAX_BATCH_ELEMS // L)):
            batch = TraceBatch.from_traces([traces[i] for i in chunk], cfg)
            out = _exact_engine_batch(batch.bank, batch.row, batch.lengths,
                                      cfg, dev)
            _record_dispatch(len(chunk), int(batch.lengths.sum()))
            for j, i in enumerate(chunk):
                cycles, hits, misses, conflicts = out[j]
                reports[i] = _channel_report(
                    traces[i], cfg, int(cycles), int(hits),
                    int(misses), int(conflicts),
                )

    # fast traces are bucketed + chunked like scan traces so padding waste
    # stays < 2x and one vectorised pass never allocates unbounded [B, L]
    for L, idxs in sorted(fast_by_bucket.items()):
        for chunk in _chunk(idxs, max(1, MAX_BATCH_ELEMS // L)):
            for i, r in zip(chunk, _simulate_fast_batch(
                    [traces[i] for i in chunk], cfg)):
                reports[i] = r

    for i, rep_i in dup_of.items():
        reports[i] = reports[rep_i]
    return reports  # type: ignore[return-value]


def _timing_key(cfg: DRAMConfig) -> tuple:
    """Everything of a DRAMConfig that determines a single-channel report:
    address mapping, page policy, cycle timings, and the ns/bandwidth scale
    factors.  Two configs with equal keys may share TraceBatch decode and
    dedup'd reports; any controller knob that changes results must be
    here."""
    t = cfg.timing_cycles()
    # mapping.scheme, not the whole AddressMapping: channel_lines only
    # parameterises the pre-split pseudo-channel deal, never the
    # single-channel timing, and keying on it would needlessly split
    # dispatch groups / defeat dedup across granularities
    return (cfg.nbanks, cfg.lines_per_row, cfg.mapping.scheme,
            cfg.page_policy, t["tCL"], t["tRCD"], t["tRP"], t["tRC"],
            t["tBL"], cfg.tCK_ns, cfg.bw_per_channel)


def simulate_many(
    items: Sequence[tuple[Trace, DRAMConfig, str, int]],
    device=None,
) -> list[TimingReport]:
    """Cross-configuration batcher: time ``(trace, cfg, engine,
    scan_cutoff)`` work items from many simulations (e.g. a sweep chunk)
    in one grouped pass — one dispatch per (timing-config, engine,
    length-bucket) group.  Returns reports in input order, identical to
    per-item simulation."""
    dev = resolve_device(device)
    reports: list[TimingReport | None] = [None] * len(items)
    groups: dict[tuple, list[int]] = {}
    for i, (tr, cfg, engine, cutoff) in enumerate(items):
        if tr.n == 0:
            reports[i] = TimingReport.zero()
        else:
            eng = select_engine(tr.n, engine, cutoff)
            groups.setdefault((_timing_key(cfg), eng), []).append(i)
    for (_, eng), idxs in groups.items():
        cfg = items[idxs[0]][1]
        for i, r in zip(idxs, simulate_batch(
                [items[i][0] for i in idxs], cfg, engine=eng, device=dev)):
            reports[i] = r
    return reports  # type: ignore[return-value]


def simulate_dram(
    traces: list[Trace],
    cfg: DRAMConfig,
    engine: str = "auto",
    scan_cutoff: int = SCAN_CUTOFF,
    batched: bool = True,
    device=None,
) -> TimingReport:
    """Simulate one trace per channel; total time = max over channels
    (channels operate independently); stats are summed.

    ``batched=True`` (default) times all channels in one grouped dispatch;
    ``batched=False`` keeps the one-dispatch-per-trace path (the
    equivalence oracle for tests and benchmarks).  Results are identical.

    Under HBM pseudo-channel mode each channel trace is dealt across two
    pseudo-channels (at the mapping's channel-interleave granularity) and
    every pseudo-channel is timed as an independent narrow channel
    (``cfg.pseudo_channel_view()``).
    """
    dev = resolve_device(device)
    assert len(traces) <= cfg.channels, (
        f"{len(traces)} traces for {cfg.channels}-channel {cfg.name}"
    )
    if cfg.pseudo_channels:
        traces = [pc for tr in traces
                  for pc in split_round_robin(tr, 2, cfg.mapping.channel_lines)]
        cfg = cfg.pseudo_channel_view()
    if not traces:
        return TimingReport.zero()
    if batched:
        reports = simulate_batch(traces, cfg, engine=engine,
                                 scan_cutoff=scan_cutoff, device=dev)
    else:
        reports = simulate_sequential(traces, cfg, engine, scan_cutoff, dev)
    time_ns = max(r.time_ns for r in reports)
    tot_bytes = sum(r.bytes_total for r in reports)
    channels_used = sum(tr.n > 0 for tr in traces)
    peak = time_ns * cfg.bw_per_channel * max(channels_used, 1)
    return TimingReport(
        time_ns=time_ns,
        cycles=max(r.cycles for r in reports),
        hits=sum(r.hits for r in reports),
        misses=sum(r.misses for r in reports),
        conflicts=sum(r.conflicts for r in reports),
        bytes_total=tot_bytes,
        bytes_read=sum(r.bytes_read for r in reports),
        bytes_written=sum(r.bytes_written for r in reports),
        requests=sum(r.requests for r in reports),
        channels_used=channels_used,
        bw_utilization=tot_bytes / max(peak, 1e-9),
    )
