"""DRAM device models: DDR3, DDR4 and HBM (paper Tab. 3).

The timing model is a deliberately simplified (cycle-approximate) re-design
of Ramulator's per-bank state machines, keeping exactly the effects the
paper studies:

- row-buffer locality: a request is a *hit* (row open), *miss* (bank
  precharged/idle: +activate) or *conflict* (different row open: +precharge
  +activate), with the paper's example latencies (11ns serve, +11ns
  activate, +11ns precharge, >=28ns between row switches in a bank);
- bank-level parallelism: bank latencies overlap, the shared per-channel
  data bus serialises line transfers (64-byte lines, 8n prefetch; HBM: 4n
  with a 128-bit bus — also 64B lines, but half the row-buffer size);
- channel-level parallelism: channels are fully independent.

All timing is carried in integer memory-clock cycles (tCK = 2000/data_rate
ns) so the engine can run in int32 on device.

The *memory controller* is configurable per device (the axes the
predecessor study arXiv 2010.13619 and ReGraph arXiv 2203.02676 show shift
accelerator rankings):

- :class:`AddressMapping` — how a line address is decoded into
  (bank, row, column): ``row`` keeps consecutive lines in one row buffer
  (row:bank:col, the classic open-page-friendly layout and the historical
  default), ``bank`` interleaves consecutive lines across banks
  (bank-level-parallelism-friendly), ``bank_xor`` keeps the row layout but
  permutes the bank index by XOR with the row bits (Zhang et al.'s
  permutation-based page interleaving, which breaks conflict resonance
  between strided streams).  ``channel_lines`` sets the granularity (in
  64B lines) at which one stream is dealt across HBM pseudo-channels.
- ``page_policy`` — ``open`` leaves the row buffer open after an access
  (hits possible, conflicts cost a precharge), ``closed`` auto-precharges
  after every access (every request activates; no conflicts).
- ``pseudo_channels`` — HBM pseudo-channel mode: each legacy channel
  splits into two pseudo-channels with half the bus width and half the
  banks each (:meth:`DRAMConfig.pseudo_channel_view`).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

MAPPING_SCHEMES = ("row", "bank", "bank_xor")
PAGE_POLICIES = ("open", "closed")


@dataclasses.dataclass(frozen=True)
class AddressMapping:
    """Line-address decode scheme of the memory controller.

    scheme: ``row`` (row:bank:col — consecutive lines fill a row buffer,
      then move to the next bank; the historical default), ``bank``
      (bank:col — consecutive lines round-robin across banks), or
      ``bank_xor`` (row layout with bank = bank XOR row low bits —
      Zhang et al.'s permutation-based page interleaving).
    channel_lines: channel-interleave granularity in 64B lines — the unit
      in which a stream is dealt across HBM pseudo-channels (1 =
      line-interleaved; e.g. 32 = 2KB coarse blocks).  Only meaningful
      with pseudo-channels (or explicit ``split_round_robin`` calls).
    """

    scheme: str = "row"
    channel_lines: int = 1

    def __post_init__(self):
        if self.scheme not in MAPPING_SCHEMES:
            raise ValueError(
                f"unknown address-mapping scheme {self.scheme!r} "
                f"(use one of {', '.join(MAPPING_SCHEMES)})")
        if self.channel_lines < 1:
            raise ValueError(
                f"channel_lines must be >= 1, got {self.channel_lines}")

    @property
    def label(self) -> str:
        """Short axis token for scenario ids / result rows."""
        if self.channel_lines == 1:
            return self.scheme
        return f"{self.scheme}@{self.channel_lines}"


def decode_lines(
    lines: np.ndarray,
    cfg: "DRAMConfig",
    bank_out: np.ndarray | None = None,
    row_out: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorised line -> (bank, row) decode under ``cfg.mapping``.

    ``bank_out`` / ``row_out`` (int32) let the caller decode straight into
    pre-allocated buffers (the lazy trace IR's fused emit path); both must
    be given together, ``lines`` is treated as scratch (clobbered in
    place).  Returns the (bank, row) arrays either way.
    """
    lpr = cfg.lines_per_row
    nb = cfg.nbanks
    scheme = cfg.mapping.scheme
    if scheme == "bank_xor" and nb & (nb - 1):
        raise ValueError(
            f"bank_xor mapping requires a power-of-two bank count, "
            f"got {nb} ({cfg.name})")
    if bank_out is None:
        if scheme == "row":
            return (((lines // lpr) % nb).astype(np.int32),
                    (lines // (lpr * nb)).astype(np.int32))
        if scheme == "bank":
            return ((lines % nb).astype(np.int32),
                    (lines // (nb * lpr)).astype(np.int32))
        row = lines // (lpr * nb)
        return ((((lines // lpr) ^ row) % nb).astype(np.int32),
                row.astype(np.int32))
    # fused path: minimal temporaries, lines reused as scratch
    if scheme == "row":
        q = lines // lpr
        np.remainder(q, nb, out=q)
        bank_out[:] = q
        np.floor_divide(lines, lpr * nb, out=lines)
        row_out[:] = lines
    elif scheme == "bank":
        q = lines % nb
        bank_out[:] = q
        np.floor_divide(lines, nb * lpr, out=lines)
        row_out[:] = lines
    else:  # bank_xor
        q = lines // lpr
        np.floor_divide(lines, lpr * nb, out=lines)  # lines := row
        row_out[:] = lines
        np.bitwise_xor(q, lines, out=q)
        np.remainder(q, nb, out=q)
        bank_out[:] = q
    return bank_out, row_out


def decode_line_scalar(line: int, cfg: "DRAMConfig") -> tuple[int, int, int]:
    """Scalar reference decode: line -> (bank, row, col) in plain Python
    ints.  The property tests check the vectorised :func:`decode_lines`
    against this, and that every mapping is a bijection on the line space."""
    lpr = cfg.lines_per_row
    nb = cfg.nbanks
    scheme = cfg.mapping.scheme
    if scheme == "row":
        return (line // lpr) % nb, line // (lpr * nb), line % lpr
    if scheme == "bank":
        return line % nb, line // (nb * lpr), (line // nb) % lpr
    if nb & (nb - 1):  # same precondition as the vectorised decode:
        raise ValueError(  # XOR-then-mod only permutes for pow2 moduli
            f"bank_xor mapping requires a power-of-two bank count, "
            f"got {nb} ({cfg.name})")
    row = line // (lpr * nb)
    return ((line // lpr) ^ row) % nb, row, line % lpr


@dataclasses.dataclass(frozen=True)
class DRAMConfig:
    name: str
    standard: str  # DDR3 | DDR4 | HBM
    channels: int
    ranks: int
    banks_per_rank: int  # DDR3: 8, DDR4: 16 (4 groups x 4), HBM: 16
    data_rate: int  # MT/s
    bw_per_channel: float  # GB/s
    size_mbit: int
    row_buffer_bytes: int
    line_bytes: int = 64
    # timing in ns (paper's reference numbers)
    tCL_ns: float = 11.0
    tRCD_ns: float = 11.0
    tRP_ns: float = 11.0
    tRC_ns: float = 28.0  # min latency between row switches (activates)
    # memory-controller configuration (the sweepable axes)
    mapping: AddressMapping = AddressMapping()
    page_policy: str = "open"  # open | closed
    pseudo_channels: bool = False  # HBM pseudo-channel mode

    def __post_init__(self):
        if self.page_policy not in PAGE_POLICIES:
            raise ValueError(
                f"unknown page policy {self.page_policy!r} "
                f"(use one of {', '.join(PAGE_POLICIES)})")
        if self.pseudo_channels:
            if self.standard != "HBM":
                raise ValueError(
                    f"pseudo-channel mode is an HBM feature "
                    f"({self.name} is {self.standard})")
            if self.banks_per_rank % 2:
                raise ValueError(
                    "pseudo-channel mode needs an even bank count to split")

    @property
    def tCK_ns(self) -> float:
        return 2000.0 / self.data_rate

    def ns_to_cycles(self, ns: float) -> int:
        # Explicit round-half-up: Python's round() uses banker's rounding
        # (round(2.5) == 2), which would let cycle counts silently change
        # between configs that land on exact .5 cycle boundaries.
        return max(1, math.floor(ns / self.tCK_ns + 0.5))

    @property
    def tCL(self) -> int:
        return self.ns_to_cycles(self.tCL_ns)

    @property
    def tRCD(self) -> int:
        return self.ns_to_cycles(self.tRCD_ns)

    @property
    def tRP(self) -> int:
        return self.ns_to_cycles(self.tRP_ns)

    @property
    def tRC(self) -> int:
        return self.ns_to_cycles(self.tRC_ns)

    @property
    def tBL(self) -> int:
        """Cycles the data bus is occupied by one 64B line transfer."""
        ns = self.line_bytes / self.bw_per_channel  # GB/s == B/ns
        return self.ns_to_cycles(ns)

    @property
    def nbanks(self) -> int:
        """Total independently-schedulable banks per channel."""
        return self.ranks * self.banks_per_rank

    @property
    def page_open(self) -> bool:
        return self.page_policy == "open"

    @property
    def lines_per_row(self) -> int:
        return self.row_buffer_bytes // self.line_bytes

    def timing_cycles(self) -> dict[str, int]:
        return dict(tCL=self.tCL, tRCD=self.tRCD, tRP=self.tRP, tRC=self.tRC, tBL=self.tBL)

    def pseudo_channel_view(self) -> "DRAMConfig":
        """The per-pseudo-channel device this config describes when
        ``pseudo_channels`` is on: 2x channels, each with half the bus
        width (tBL doubles) and half the banks; timing parameters and the
        per-bank row buffer are unchanged.  Identity when the mode is off.
        """
        if not self.pseudo_channels:
            return self
        return dataclasses.replace(
            self,
            pseudo_channels=False,
            channels=self.channels * 2,
            banks_per_rank=self.banks_per_rank // 2,
            bw_per_channel=self.bw_per_channel / 2,
        )


def _ddr4(name: str, channels: int, size_mbit: int) -> DRAMConfig:
    return DRAMConfig(
        name=name, standard="DDR4", channels=channels, ranks=1, banks_per_rank=16,
        data_rate=2400, bw_per_channel=19.2, size_mbit=size_mbit, row_buffer_bytes=8192,
    )


# Tab. 3 of the paper.
DRAM_CONFIGS: dict[str, DRAMConfig] = {
    "accugraph": _ddr4("accugraph", 1, 2048),
    "foregraph": _ddr4("foregraph", 1, 4096),
    "hitgraph": DRAMConfig(
        name="hitgraph", standard="DDR3", channels=4, ranks=2, banks_per_rank=8,
        data_rate=1600, bw_per_channel=12.8, size_mbit=8192, row_buffer_bytes=8192,
    ),
    "thundergp": _ddr4("thundergp", 4, 16384),
    "default": _ddr4("default", 1, 16384),
    "ddr3": DRAMConfig(
        name="ddr3", standard="DDR3", channels=1, ranks=1, banks_per_rank=8,
        data_rate=2133, bw_per_channel=17.1, size_mbit=8192, row_buffer_bytes=8192,
    ),
    "hbm": DRAMConfig(
        name="hbm", standard="HBM", channels=1, ranks=1, banks_per_rank=16,
        data_rate=1000, bw_per_channel=16.0, size_mbit=4096, row_buffer_bytes=2048,
    ),
}


def dram_config(
    name: str,
    channels: int | None = None,
    *,
    mapping: AddressMapping | str | None = None,
    page_policy: str | None = None,
    pseudo_channels: bool | None = None,
) -> DRAMConfig:
    """Resolve a preset, optionally overriding the channel count and the
    memory-controller axes (``mapping`` accepts a scheme name or a full
    :class:`AddressMapping`)."""
    cfg = DRAM_CONFIGS[name]
    kw: dict = {}
    if channels is not None:
        kw["channels"] = channels
    if mapping is not None:
        kw["mapping"] = (AddressMapping(mapping) if isinstance(mapping, str)
                         else mapping)
    if page_policy is not None:
        kw["page_policy"] = page_policy
    if pseudo_channels is not None:
        kw["pseudo_channels"] = pseudo_channels
    return dataclasses.replace(cfg, **kw) if kw else cfg
