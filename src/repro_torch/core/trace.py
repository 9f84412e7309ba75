"""Off-chip request traces and the paper's memory-access abstractions.

A Trace is a struct-of-arrays of cache-line requests in program order:
line addresses (int64 line index, i.e. byte address >> 6) and a write flag.
Traces are assembled host-side in numpy (like the paper's C++ simulation
environment prepares request streams) and handed to the device engine.

The combinators mirror the paper's Sect. 2.2 / 3.2 abstractions:

- ``coalesce``: the *cache line* abstraction — merges adjacent requests to
  the same cache line into one.
- ``filtered`` writes: the *filter* abstraction — unchanged values are never
  written (callers pass only changed indices).
- ``round_robin``: merge streams 1:1 (AccuGraph's value+pointer streams).
- ``proportional_interleave``: merge streams produced concurrently by
  pipeline stages at rates proportional to their lengths (approximates the
  paper's priority merging without cycle-level arbitration; the locality
  disruption from switching streams — the effect under study — is kept).
- ``concat``: sequential phases (e.g. prefetch completes before edge
  reading starts, per the control-flow dependencies in Figs. 4-7).

Two evaluation strategies share one combinator API:

- **Eager** (:class:`Trace`): every combinator materialises its result
  immediately.  This is the historical path and the equivalence oracle.
- **Lazy** (:class:`LazyTrace`, the default): ``seq_read``/``seq_write``
  become O(1) *range* nodes and the combinators become expression nodes; a
  trace is materialised exactly once — by the timing engine, directly into
  the padded ``[B, L]`` batch buffers (``emit_bank_row``) — instead of being
  copied once per combinator level.  Lengths and byte counts are available
  without materialisation, so the accelerator iteration loops never touch
  request arrays.  Lazy and eager composition produce byte-identical
  request streams (the merge orders are computed by shared helpers from
  stream *lengths* only).

``set_lazy`` / ``eager_traces`` switch the strategy; benchmarks use the
eager mode as the host-pipeline baseline.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.core.dram import decode_lines
from repro_torch.kernels._platform import resolve_device

LINE = 64

# Evaluation strategy of the combinators below: True builds LazyTrace
# expression nodes (materialised once, by the engine), False materialises
# every combinator eagerly (the historical oracle path).
_LAZY = True


def lazy_enabled() -> bool:
    return _LAZY


def set_lazy(enabled: bool) -> None:
    global _LAZY
    _LAZY = bool(enabled)


@contextlib.contextmanager
def eager_traces():
    """Run trace assembly with eager (immediately materialised) combinators
    — the equivalence oracle and the pre-lazy-IR benchmark baseline."""
    global _LAZY
    prev = _LAZY
    _LAZY = False
    try:
        yield
    finally:
        _LAZY = prev


@dataclasses.dataclass
class Trace:
    """Cache-line request trace in program order (one DRAM channel)."""

    lines: np.ndarray  # int64 line indices
    is_write: np.ndarray  # bool

    def __post_init__(self):
        self.lines = np.asarray(self.lines, dtype=np.int64)
        self.is_write = np.asarray(self.is_write, dtype=bool)
        assert self.lines.shape == self.is_write.shape

    @property
    def n(self) -> int:
        return int(self.lines.shape[0])

    @property
    def bytes(self) -> int:
        return self.n * LINE

    @property
    def read_bytes(self) -> int:
        return int((~self.is_write).sum()) * LINE

    @property
    def write_bytes(self) -> int:
        return int(self.is_write.sum()) * LINE

    @staticmethod
    def empty() -> "Trace":
        return Trace(np.zeros(0, dtype=np.int64), np.zeros(0, dtype=bool))


# ---------------------------------------------------------------------------
# lazy trace IR
# ---------------------------------------------------------------------------


class LazyTrace:
    """A deferred request stream: knows its length and write count in O(1)
    and can emit its lines / write flags into caller-provided buffers in one
    pass.  Duck-types the read-only surface of :class:`Trace` (``n``,
    ``bytes``, ``lines``, ``is_write``) by materialising on demand."""

    __slots__ = ("_n", "_wn", "_mat", "_skey")

    def __init__(self, n: int, wn: int):
        self._n = int(n)
        self._wn = int(wn)
        self._mat: Trace | None = None
        self._skey = None

    def structural_key(self):
        """A hashable key that uniquely determines this node's request
        stream (cached).  Structurally-identical traces — e.g. the static
        streams an accelerator re-emits every iteration — share keys, which
        lets the timing engine simulate each unique (stream, timing-config)
        pair once."""
        if self._skey is None:
            self._skey = self._structural_key()
        return self._skey

    def _structural_key(self):
        raise NotImplementedError

    # ---- O(1) accounting ----
    def _write_count(self) -> int:
        """Number of write requests.  Combinators must use this (not
        ``_wn`` directly): nodes with lazily-resolved write accounting
        (:class:`_SplitLeaf`) override it."""
        return self._wn

    @property
    def n(self) -> int:
        return self._n

    @property
    def bytes(self) -> int:
        return self._n * LINE

    @property
    def read_bytes(self) -> int:
        return (self._n - self._wn) * LINE

    @property
    def write_bytes(self) -> int:
        return self._wn * LINE

    # ---- materialisation (oracle / compat path; the engine uses emit_*) ----
    def materialize(self) -> Trace:
        if self._mat is None:
            lines = np.empty(self._n, dtype=np.int64)
            wr = np.empty(self._n, dtype=bool)
            self.emit_lines(lines)
            self.emit_writes(wr)
            self._mat = Trace(lines, wr)
        return self._mat

    @property
    def lines(self) -> np.ndarray:
        return self.materialize().lines

    @property
    def is_write(self) -> np.ndarray:
        return self.materialize().is_write

    # ---- single-pass emission ----
    def emit_lines(self, out: np.ndarray) -> None:
        raise NotImplementedError

    def emit_writes(self, out: np.ndarray) -> None:
        raise NotImplementedError

    def emit_bank_row(self, bank_out: np.ndarray, row_out: np.ndarray,
                      cfg, scratch: np.ndarray | None = None) -> None:
        """Decode this trace's lines straight into ``[L]`` bank/row buffer
        slices (the fused flatten+pack path of ``TraceBatch``) under the
        :class:`repro_torch.core.dram.DRAMConfig`'s address mapping.  ``scratch``
        is an optional reusable int64 buffer of length >= n."""
        if scratch is None or len(scratch) < self._n:
            scratch = np.empty(self._n, dtype=np.int64)
        lines = scratch[: self._n]
        self.emit_lines(lines)
        decode_lines(lines, cfg, bank_out, row_out)


class _RangeLeaf(LazyTrace):
    """seq_read / seq_write: a contiguous, uniform-kind line range."""

    __slots__ = ("first", "is_write_flag")

    def __init__(self, first: int, count: int, is_write: bool):
        super().__init__(count, count if is_write else 0)
        self.first = int(first)
        self.is_write_flag = bool(is_write)

    def emit_lines(self, out: np.ndarray) -> None:
        out[:] = np.arange(self.first, self.first + self._n, dtype=np.int64)

    def emit_writes(self, out: np.ndarray) -> None:
        out[:] = self.is_write_flag

    def _structural_key(self):
        return ("R", self.first, self._n, self.is_write_flag)


class _EagerLeaf(LazyTrace):
    """An already-materialised trace embedded in a lazy expression (random
    reads/writes, coalesced streams, literal ``Trace`` inputs)."""

    __slots__ = ("trace",)

    def __init__(self, trace: Trace):
        super().__init__(trace.n, int(trace.is_write.sum()))
        self.trace = trace
        self._mat = trace

    def emit_lines(self, out: np.ndarray) -> None:
        out[:] = self.trace.lines

    def emit_writes(self, out: np.ndarray) -> None:
        out[:] = self.trace.is_write

    def _structural_key(self):
        h = hashlib.sha256(self.trace.lines.tobytes())
        h.update(self.trace.is_write.tobytes())
        return ("E", h.digest())


class _Concat(LazyTrace):
    """Sequential composition; nested concats are spliced flat so emission
    is a single walk over leaf blocks."""

    __slots__ = ("children",)

    def __init__(self, children: list):
        flat: list[LazyTrace] = []
        for c in children:
            if isinstance(c, _Concat):
                flat.extend(c.children)
            else:
                flat.append(c)
        super().__init__(sum(c.n for c in flat),
                         sum(c._write_count() for c in flat))
        self.children = flat

    def _emit(self, out: np.ndarray, field: str) -> None:
        at = 0
        for c in self.children:
            getattr(c, field)(out[at : at + c.n])
            at += c.n

    def emit_lines(self, out: np.ndarray) -> None:
        self._emit(out, "emit_lines")

    def emit_writes(self, out: np.ndarray) -> None:
        self._emit(out, "emit_writes")

    def _structural_key(self):
        return ("C", tuple(c.structural_key() for c in self.children))


class _Merge(LazyTrace):
    """round_robin / proportional_interleave: children are emitted into a
    contiguous scratch and gathered through a permutation computed from the
    child *lengths* only (cached across emissions — the same merge node is
    packed once per simulated channel but ordered once)."""

    __slots__ = ("children", "kind", "_order")

    def __init__(self, children: list, kind: str):
        super().__init__(sum(c.n for c in children),
                         sum(c._write_count() for c in children))
        self.children = children
        self.kind = kind  # "rr" | "prop"
        self._order: np.ndarray | None = None

    def order(self) -> np.ndarray:
        if self._order is None:
            lengths = [c.n for c in self.children]
            self._order = (_round_robin_order(lengths) if self.kind == "rr"
                           else _proportional_order(lengths))
        return self._order

    def _emit(self, out: np.ndarray, field: str, dtype) -> None:
        scratch = np.empty(self._n, dtype=dtype)
        at = 0
        for c in self.children:
            getattr(c, field)(scratch[at : at + c.n])
            at += c.n
        np.take(scratch, self.order(), out=out)

    def emit_lines(self, out: np.ndarray) -> None:
        self._emit(out, "emit_lines", np.int64)

    def emit_writes(self, out: np.ndarray) -> None:
        self._emit(out, "emit_writes", bool)

    def _structural_key(self):
        return ("M", self.kind,
                tuple(c.structural_key() for c in self.children))


def _split_len(n: int, k: int, index: int, granularity: int) -> int:
    """Requests channel ``index`` receives when ``n`` requests are dealt
    round-robin across ``k`` channels in ``granularity``-request blocks."""
    g = granularity
    full, rem = divmod(n, g * k)
    return full * g + min(max(rem - index * g, 0), g)


def _split_positions(n: int, k: int, index: int, granularity: int) -> np.ndarray:
    """Parent positions of channel ``index``'s share, in parent order."""
    g = granularity
    j = np.arange(_split_len(n, k, index, g), dtype=np.int64)
    return (j // g) * (g * k) + index * g + (j % g)


class _SplitLeaf(LazyTrace):
    """One channel's share of a round-robin channel deal: every k-th
    ``granularity``-block of the parent stream, starting at block
    ``index``.  The parent materialises once (cached) and is shared by all
    k children; each child gathers its strided share on emission, straight
    into the engine's batch buffers.  Write accounting is resolved lazily
    (it needs the parent's write flags, unlike the O(1) length)."""

    __slots__ = ("parent", "k", "index", "granularity", "_wn_known")

    def __init__(self, parent: LazyTrace, k: int, index: int,
                 granularity: int = 1):
        super().__init__(_split_len(parent.n, k, index, granularity), 0)
        self.parent = parent
        self.k = int(k)
        self.index = int(index)
        self.granularity = int(granularity)
        self._wn_known = False

    def _take(self, arr: np.ndarray, out: np.ndarray) -> None:
        if self.granularity == 1:
            out[:] = arr[self.index :: self.k]
        else:
            np.take(arr, _split_positions(self.parent.n, self.k, self.index,
                                          self.granularity), out=out)

    def emit_lines(self, out: np.ndarray) -> None:
        self._take(self.parent.lines, out)

    def emit_writes(self, out: np.ndarray) -> None:
        self._take(self.parent.is_write, out)

    def _write_count(self) -> int:
        if not self._wn_known:
            if self._n:
                wr = np.empty(self._n, dtype=bool)
                self.emit_writes(wr)
                self._wn = int(wr.sum())
            self._wn_known = True
        return self._wn

    @property
    def read_bytes(self) -> int:
        return (self._n - self._write_count()) * LINE

    @property
    def write_bytes(self) -> int:
        return self._write_count() * LINE

    def _structural_key(self):
        return ("S", self.parent.structural_key(), self.k, self.index,
                self.granularity)


def _as_lazy(t) -> LazyTrace:
    return t if isinstance(t, LazyTrace) else _EagerLeaf(t)


def materialize(t) -> Trace:
    """Eager view of any trace (identity on :class:`Trace`)."""
    return t.materialize() if isinstance(t, LazyTrace) else t


# ---------------------------------------------------------------------------
# merge-order helpers (shared by the eager and lazy paths, so both produce
# byte-identical streams by construction)
# ---------------------------------------------------------------------------


def _round_robin_order(lengths: list[int]) -> np.ndarray:
    """Positions of a 1:1 merge: stream i's j-th request at virtual time
    j*k + i; requests beyond the shortest stream follow."""
    k = len(lengths)
    pos = np.concatenate(
        [np.arange(n, dtype=np.float64) * k + i for i, n in enumerate(lengths)]
    )
    return np.argsort(pos, kind="stable")


def _proportional_order(lengths: list[int]) -> np.ndarray:
    """Positions of a rate-proportional merge: stream i's j-th request at
    virtual time (j + 0.5) / len_i, ties broken by stream index via
    ``np.lexsort`` (exact — the previous ``i * 1e-12`` float tie-break
    reordered long streams once position gaps fell below the epsilon)."""
    pos = np.concatenate(
        [(np.arange(n, dtype=np.float64) + 0.5) / n for n in lengths]
    )
    sub = np.concatenate(
        [np.full(n, i, dtype=np.int32) for i, n in enumerate(lengths)]
    )
    return np.lexsort((sub, pos))


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------


def _lines_for_span(base: int, nbytes: int) -> np.ndarray:
    """Cache lines touched by a sequential [base, base+nbytes) access."""
    if nbytes <= 0:
        return np.zeros(0, dtype=np.int64)
    first = base // LINE
    last = (base + nbytes - 1) // LINE
    return np.arange(first, last + 1, dtype=np.int64)


def _span_range(base: int, nbytes: int) -> tuple[int, int]:
    if nbytes <= 0:
        return 0, 0
    first = base // LINE
    last = (base + nbytes - 1) // LINE
    return first, last - first + 1


def seq_read(base: int, nbytes: int):
    if _LAZY:
        first, count = _span_range(base, nbytes)
        return _RangeLeaf(first, count, False)
    lines = _lines_for_span(base, nbytes)
    return Trace(lines, np.zeros(len(lines), dtype=bool))


def seq_write(base: int, nbytes: int):
    if _LAZY:
        first, count = _span_range(base, nbytes)
        return _RangeLeaf(first, count, True)
    lines = _lines_for_span(base, nbytes)
    return Trace(lines, np.ones(len(lines), dtype=bool))


def _random_lines(base: int, indices: np.ndarray, width: int) -> np.ndarray:
    addr = base + indices.astype(np.int64) * width
    return addr // LINE


def random_read(base: int, indices: np.ndarray, width: int, coalesced: bool = True):
    lines = _random_lines(base, indices, width)
    t = Trace(lines, np.zeros(len(lines), dtype=bool))
    t = _coalesce_eager(t) if coalesced else t
    return _EagerLeaf(t) if _LAZY else t


def random_write(base: int, indices: np.ndarray, width: int, coalesced: bool = True):
    lines = _random_lines(base, indices, width)
    t = Trace(lines, np.ones(len(lines), dtype=bool))
    t = _coalesce_eager(t) if coalesced else t
    return _EagerLeaf(t) if _LAZY else t


# ---------------------------------------------------------------------------
# combinators
# ---------------------------------------------------------------------------


def _coalesce_eager(t: Trace) -> Trace:
    if t.n == 0:
        return t
    keep = np.ones(t.n, dtype=bool)
    same = (t.lines[1:] == t.lines[:-1]) & (t.is_write[1:] == t.is_write[:-1])
    keep[1:] = ~same
    return Trace(t.lines[keep], t.is_write[keep])


def coalesce(t):
    """Cache-line abstraction: merge *adjacent* requests to the same line."""
    if isinstance(t, LazyTrace):
        return _EagerLeaf(_coalesce_eager(t.materialize()))
    return _coalesce_eager(t)


def concat(*traces):
    traces = [t for t in traces if t.n > 0]
    if not traces:
        return Trace.empty()
    if _LAZY:
        if len(traces) == 1:
            return _as_lazy(traces[0])
        return _Concat([_as_lazy(t) for t in traces])
    traces = [materialize(t) for t in traces]
    return Trace(
        np.concatenate([t.lines for t in traces]),
        np.concatenate([t.is_write for t in traces]),
    )


def _merge(traces, kind: str):
    traces = [t for t in traces if t.n > 0]
    if not traces:
        return Trace.empty()
    if len(traces) == 1:
        # a single stream merges to itself — identical in both modes
        return _as_lazy(traces[0]) if _LAZY else materialize(traces[0])
    if _LAZY:
        return _Merge([_as_lazy(t) for t in traces], kind)
    traces = [materialize(t) for t in traces]
    order = (_round_robin_order([t.n for t in traces]) if kind == "rr"
             else _proportional_order([t.n for t in traces]))
    lines = np.concatenate([t.lines for t in traces])
    wr = np.concatenate([t.is_write for t in traces])
    return Trace(lines[order], wr[order])


def round_robin(*traces):
    """Merge streams 1:1 (requests beyond the shortest stream follow)."""
    return _merge(traces, "rr")


def proportional_interleave(*traces):
    """Merge concurrently-produced streams at rates proportional to length.

    Stream i's j-th request is placed at virtual time j / len_i, so all
    streams start and finish together — the steady-state behaviour of the
    paper's pipelined producers with priority arbitration.  Ties are broken
    by stream index (exactly, via lexsort)."""
    return _merge(traces, "prop")


def split_round_robin(t, k: int, granularity: int = 1) -> list:
    """Deal a trace across k channels in ``granularity``-line blocks
    (round-robin share; granularity 1 is the classic line-by-line deal).

    A lazy trace yields lazy strided-split nodes — the parent stream
    materialises once and each channel's share decodes straight into the
    engine's padded batch buffers; an eager trace yields eager slices
    (the oracle path)."""
    if granularity < 1:
        raise ValueError(f"granularity must be >= 1, got {granularity}")
    if isinstance(t, LazyTrace):
        return [_SplitLeaf(t, k, i, granularity) for i in range(k)]
    if granularity == 1:
        return [Trace(t.lines[i::k], t.is_write[i::k]) for i in range(k)]
    return [
        Trace(t.lines[pos], t.is_write[pos])
        for i in range(k)
        for pos in (_split_positions(t.n, k, i, granularity),)
    ]


def trace_stream_hash(traces) -> str:
    """sha256 over the materialised request streams (lines + is_write
    bytes), in order — THE byte-identity fingerprint the golden-hash
    checks compare (bench_host, bench_partition, tests/test_layout.py all
    hash through here so they can never drift apart)."""
    h = hashlib.sha256()
    for tr in traces:
        m = materialize(tr)
        h.update(m.lines.tobytes())
        h.update(m.is_write.tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# device-side decode (the semexec boundary's trace half)
# ---------------------------------------------------------------------------


def decode_lines_device(lines: torch.Tensor, mask: torch.Tensor, cfg):
    """Torch twin of :func:`repro_torch.core.dram.decode_lines`: int64 line
    -> int32 (bank, row) under ``cfg.mapping``, in integer ops on the
    tensors' device, over any shape.  ``mask`` marks real requests; padding
    decodes to the engines' no-op convention (bank -1, row 0).  Lines are
    non-negative, so torch's floor division and remainder equal numpy's and
    the result is bit-equal to the numpy decode."""
    lpr = cfg.lines_per_row
    nb = cfg.nbanks
    scheme = cfg.mapping.scheme
    if scheme == "bank_xor" and nb & (nb - 1):
        raise ValueError(
            f"bank_xor mapping requires a power-of-two bank count, "
            f"got {nb} ({cfg.name})")
    if scheme == "row":
        bank = (lines // lpr) % nb
        row = lines // (lpr * nb)
    elif scheme == "bank":
        bank = lines % nb
        row = lines // (nb * lpr)
    else:  # bank_xor
        row = lines // (lpr * nb)
        bank = ((lines // lpr) ^ row) % nb
    bank = torch.where(mask, bank.to(torch.int32), -1)
    row = torch.where(mask, row.to(torch.int32), 0)
    return bank, row


def emit_bank_row_device(traces, cfg, min_len: int = 256, device=None):
    """Pack many traces into padded ``[B, L]`` bank/row tensors on
    ``device`` (``None``: the CUDA card), with the address decode run there
    in one pass.

    Line streams are gathered host-side (the lazy IR computes merge orders
    from eager lengths, so line emission stays a host pass), but the
    per-request decode arithmetic -- the O(total requests) part -- runs on
    the device and the result stays there, in exactly the layout the timing
    kernel consumes.  Bit-identical to ``engine.TraceBatch.from_traces`` with
    ``pad_batch=False``.

    Returns ``(bank, row, lengths)``: int32 ``[B, L]`` tensors (bank padded
    with -1, the engines' no-op) and host int64 lengths."""
    dev = resolve_device(device)
    lengths = np.array([t.n for t in traces], dtype=np.int64)
    longest = int(lengths.max()) if len(traces) else 0
    L = min_len
    while L < longest:
        L *= 2
    B = max(len(traces), 1)
    lines = np.zeros((B, L), dtype=np.int64)
    mask = np.zeros((B, L), dtype=bool)
    for i, t in enumerate(traces):
        if not t.n:
            continue
        _as_lazy(t).emit_lines(lines[i, : t.n])
        mask[i, : t.n] = True
    return (*decode_lines_device(torch.from_numpy(lines).to(dev),
                                 torch.from_numpy(mask).to(dev), cfg), lengths)
