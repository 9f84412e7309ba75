"""Declarative scenario sweeps over the simulation environment's axes.

A :class:`SweepSpec` names the performance dimensions the paper sweeps —
accelerator x problem x graph x memory technology x configuration — and
``expand()`` resolves the cross-product into fully-typed :class:`Scenario`
records.  Invalid combinations (a weighted problem on an accelerator without
weight support, multi-channel DRAM on a single-channel design, an interval
size the model rejects) are filtered into :class:`Skipped` records instead of
crashing mid-sweep.

Expansion is *indexable*: the cross-product is a mixed-radix space of
``n_points`` raw points (``axis_shape`` gives the per-axis radices in
nesting order), and ``point_at(i)`` decodes any single point into its
:class:`Scenario` — or the :class:`Skipped` record explaining why the
combination is invalid — without touching any other point.  ``expand()``
is a plain traversal of ``iter_points()``, so grid sweeps keep their
historical, byte-identical ordering while an adaptive search
(:mod:`repro_torch.sweep.search`) can draw candidate pools of 10^4-10^5 combinations without
materializing the full list.

Scenarios are frozen, hashable and picklable: they are the unit of work of
``repro_torch.sweep.runner`` and the input of the content-addressed result
cache (``repro_torch.sweep.cache``).

The expansion is the reference's (``repro/sweep/spec.py``), point for
point: the same axes, order, skip reasons and scenario ids.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator

from repro_torch.configs.graphsim import default_config
from repro_torch.core import semexec
from repro_torch.core.accelerators import ACCELERATORS
from repro_torch.core.accelerators.base import AccelConfig
from repro_torch.core.dram import (
    DRAM_CONFIGS,
    DRAMConfig,
    MAPPING_SCHEMES,
    PAGE_POLICIES,
    AddressMapping,
    dram_config,
)
from repro_torch.graph.generators import PAPER_GRAPHS, GraphSpec
from repro_torch.graph.layout import REORDERS, validate_interval_scale
from repro_torch.graph.problems import PROBLEMS


@dataclasses.dataclass(frozen=True)
class ConfigOverride:
    """One point of a configuration axis (e.g. an ablation): the fields set
    here replace the accelerator's default :class:`AccelConfig` fields."""

    label: str = ""
    interval_size: int | None = None
    n_pes: int | None = None
    optimizations: frozenset | None = None
    engine: str | None = None

    def apply(self, cfg: AccelConfig) -> AccelConfig:
        kw = {
            f: getattr(self, f)
            for f in ("interval_size", "n_pes", "optimizations", "engine")
            if getattr(self, f) is not None
        }
        return dataclasses.replace(cfg, **kw) if kw else cfg


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One fully-resolved simulation point: everything ``run_accelerator``
    needs, with no late binding — hashable, picklable, cacheable."""

    graph: GraphSpec
    accelerator: str
    problem: str
    dram: DRAMConfig
    config: AccelConfig
    root: int = 0
    label: str = ""  # ConfigOverride label (e.g. ablation name)

    @property
    def scenario_id(self) -> str:
        """Human-readable identity for progress lines and error reports.
        Memory-controller and layout axes appear only when non-default, so
        historical ids are unchanged."""
        dram = f"{self.dram.name}x{self.dram.channels}"
        if self.dram.pseudo_channels:
            dram += "-pc"
        parts = [self.graph.name, self.accelerator, self.problem, dram]
        m = self.dram.mapping
        if m.scheme != "row" or m.channel_lines != 1:
            parts.append(m.label)
        if self.dram.page_policy != "open":
            parts.append(self.dram.page_policy)
        if self.config.reorder != "identity":
            parts.append(self.config.reorder)
        if self.config.interval_scale != 1:
            parts.append(f"ivx{self.config.interval_scale}")
        if self.config.semexec != "numpy":
            parts.append(self.config.semexec)
        if self.label:
            parts.append(self.label)
        return "/".join(parts)


@dataclasses.dataclass(frozen=True)
class Skipped:
    """An invalid axis combination, recorded instead of executed."""

    graph: str
    accelerator: str
    problem: str
    dram: str
    label: str
    reason: str


def _as_graph_spec(g: str | GraphSpec) -> GraphSpec:
    return PAPER_GRAPHS[g] if isinstance(g, str) else g


def _as_dram_axis(d) -> tuple[str, int | None]:
    return d if isinstance(d, tuple) else (d, None)


def _as_mapping(m: str | AddressMapping) -> AddressMapping:
    """Parse a mapping-axis token: an :class:`AddressMapping`, a scheme
    name (``row`` | ``bank`` | ``bank_xor``), or ``scheme@lines`` with an
    explicit channel-interleave granularity (e.g. ``row@32``)."""
    if isinstance(m, AddressMapping):
        return m
    scheme, _, g = str(m).partition("@")
    try:
        lines = int(g) if g else 1
    except ValueError:
        raise ValueError(f"bad channel-interleave granularity in {m!r}")
    return AddressMapping(scheme, lines)


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """Cross-product sweep definition.

    Axes:
      accelerators: model names from ``ACCELERATORS``.
      graphs: ``PAPER_GRAPHS`` keys or inline :class:`GraphSpec` recipes.
      problems: ``PROBLEMS`` keys.
      drams: DRAM preset names, or ``(name, channels)`` pairs; an explicit
        channel count also sets ``n_pes`` on accelerators that pair PEs with
        memory channels (HitGraph, ThunderGP — the paper's Tab. 7 setup).
      mappings: memory-controller address mappings — scheme names
        (``row`` | ``bank`` | ``bank_xor``), ``scheme@lines`` tokens with an
        explicit channel-interleave granularity, or
        :class:`repro_torch.core.dram.AddressMapping` instances.
      page_policies: row-buffer page policies (``open`` | ``closed``).
      pseudo_channels: HBM pseudo-channel mode on/off; ``True`` is filtered
        to :class:`Skipped` on non-HBM presets.
      overrides: :class:`ConfigOverride` axis (ablations, interval sizes...).
      reorders: graph-layout vertex reorderings applied before partitioning
        (``identity`` | ``degree`` | ``random`` | ``bfs`` —
        ``repro_torch.graph.layout.REORDERS``); semantics are layout-invariant,
        only partition shapes and traces move.
      interval_scales: power-of-two multipliers on each accelerator's
        ``interval_size`` (partition granularity axis); combinations a
        model rejects (ForeGraph past the 65,536 cap) are filtered to
        :class:`Skipped`.
      engines: semantic execution engines (``numpy`` | ``device`` —
        ``repro_torch.core.semexec.ENGINES``); a requested ``device`` engine
        falls back to numpy (with a warning) on accelerator/problem pairs
        without a device path, and the result rows record the engine that
        actually ran.

    Expansion order is graphs, accelerators, problems, drams, mappings,
    page policies, pseudo-channels, overrides, reorders, interval scales,
    engines — stable, so result rows are deterministic regardless of
    execution order.
    """

    name: str
    accelerators: tuple[str, ...]
    graphs: tuple[str | GraphSpec, ...]
    problems: tuple[str, ...] = ("bfs",)
    drams: tuple[str | tuple[str, int | None], ...] = ("default",)
    mappings: tuple[str | AddressMapping, ...] = ("row",)
    page_policies: tuple[str, ...] = ("open",)
    pseudo_channels: tuple[bool, ...] = (False,)
    overrides: tuple[ConfigOverride, ...] = (ConfigOverride(),)
    reorders: tuple[str, ...] = ("identity",)
    interval_scales: tuple[int, ...] = (1,)
    engines: tuple[str, ...] = ("numpy",)

    def _validate(self) -> None:
        """Clean errors for unknown axis names (instead of a KeyError deep
        in the expansion)."""
        def check(kind, names, known):
            unknown = sorted(set(names) - set(known))
            if unknown:
                raise ValueError(
                    f"unknown {kind} {', '.join(map(repr, unknown))}; "
                    f"available: {', '.join(known)}"
                )

        check("accelerator(s)", self.accelerators, ACCELERATORS)
        check("problem(s)", self.problems, PROBLEMS)
        check("graph(s)", [g for g in self.graphs if isinstance(g, str)], PAPER_GRAPHS)
        check("DRAM preset(s)", [_as_dram_axis(d)[0] for d in self.drams], DRAM_CONFIGS)
        bad = [c for _, c in map(_as_dram_axis, self.drams)
               if c is not None and c < 1]
        if bad:
            raise ValueError(f"channel counts must be >= 1, got {bad}")
        check("address-mapping scheme(s)",
              [m.scheme if isinstance(m, AddressMapping)
               else str(m).partition("@")[0] for m in self.mappings],
              MAPPING_SCHEMES)
        check("page polic(ies)", self.page_policies, PAGE_POLICIES)
        bad_pc = [p for p in self.pseudo_channels if not isinstance(p, bool)]
        if bad_pc:
            raise ValueError(f"pseudo_channels must be booleans, got {bad_pc}")
        check("reorder(s)", self.reorders, REORDERS)
        for scale in self.interval_scales:
            validate_interval_scale(scale)
        check("engine(s)", self.engines, semexec.ENGINES)

    def _ensure_valid(self) -> None:
        """Validate once per instance (the spec is frozen, so the outcome
        cannot change); indexed accessors call this on every lookup."""
        if not getattr(self, "_axes_valid", False):
            self._validate()
            object.__setattr__(self, "_axes_valid", True)

    # ---- indexable expansion ----------------------------------------------
    #
    # The cross-product is a mixed-radix number system over the axes in
    # their historical nesting order; point i decodes to one axis-coordinate
    # tuple, and every point is independent of every other.

    @property
    def axis_shape(self) -> tuple[int, ...]:
        """Per-axis radices in nesting order: graphs, accelerators,
        problems, drams, mappings, page_policies, pseudo_channels,
        overrides, reorders, interval_scales, engines."""
        return (len(self.graphs), len(self.accelerators), len(self.problems),
                len(self.drams), len(self.mappings), len(self.page_policies),
                len(self.pseudo_channels), len(self.overrides),
                len(self.reorders), len(self.interval_scales),
                len(self.engines))

    @property
    def n_points(self) -> int:
        """Raw cross-product size (valid scenarios + filtered combos)."""
        return math.prod(self.axis_shape)

    def point_at(self, i: int) -> Scenario | Skipped:
        """Decode raw point ``i`` into its :class:`Scenario`, or the
        :class:`Skipped` record explaining why the combination is filtered.
        O(1) in the grid size — nothing else is expanded."""
        self._ensure_valid()
        shape = self.axis_shape
        if not 0 <= i < math.prod(shape):
            raise IndexError(f"point {i} out of range [0, {math.prod(shape)})")
        coords = []
        for radix in reversed(shape):
            i, c = divmod(i, radix)
            coords.append(c)
        (gi, ai, pi, di, mi, ppi, pci, oi, ri, si, ei) = reversed(coords)

        gspec = _as_graph_spec(self.graphs[gi])
        accel = self.accelerators[ai]
        cls = ACCELERATORS[accel]
        prob = self.problems[pi]
        problem = PROBLEMS[prob]
        dname, channels = _as_dram_axis(self.drams[di])
        base_dram = DRAM_CONFIGS[dname]

        def skip(reason: str, label: str = "") -> Skipped:
            return Skipped(graph=gspec.name, accelerator=accel, problem=prob,
                           dram=dname, label=label, reason=reason)

        # axis-independent incompatibilities (the whole dram block shares
        # one reason; expand() dedups the repeats into one record)
        if problem.needs_weights and not cls.supports_weights:
            return skip(f"{accel} does not support weighted problems")
        if channels and channels > 1 and not cls.supports_multichannel:
            return skip(f"{accel} does not support multi-channel memory")

        mapping = _as_mapping(self.mappings[mi])
        policy = self.page_policies[ppi]
        pc = self.pseudo_channels[pci]
        if pc and base_dram.standard != "HBM":
            return skip(f"pseudo-channels require HBM "
                        f"({dname} is {base_dram.standard})")
        if mapping.channel_lines != 1 and not pc:
            return skip(f"channel-interleave granularity "
                        f"({mapping.label}) only acts on the "
                        f"pseudo-channel deal")
        if (mapping.scheme == "bank_xor"
                and base_dram.nbanks & (base_dram.nbanks - 1)):
            return skip(f"bank_xor needs a power-of-two bank "
                        f"count ({dname} has {base_dram.nbanks})")

        ov = self.overrides[oi]
        base_cfg = default_config(accel)
        if channels and cls.supports_multichannel:
            base_cfg = dataclasses.replace(base_cfg, n_pes=channels)
        base_cfg = ov.apply(base_cfg)
        try:
            cfg = dataclasses.replace(
                base_cfg, reorder=self.reorders[ri],
                interval_scale=self.interval_scales[si],
                semexec=self.engines[ei])
            cls(cfg)  # model-side validation
        except ValueError as e:
            return skip(str(e), ov.label)
        return Scenario(
            graph=gspec,
            accelerator=accel,
            problem=prob,
            dram=dram_config(dname, channels=channels, mapping=mapping,
                             page_policy=policy, pseudo_channels=pc),
            config=cfg,
            root=gspec.root,
            label=ov.label,
        )

    def scenario_at(self, i: int) -> Scenario | None:
        """The scenario at raw point ``i``, or ``None`` for a filtered
        combination — the accessor a sampler draws from."""
        out = self.point_at(i)
        return out if isinstance(out, Scenario) else None

    def iter_points(self) -> Iterator[Scenario | Skipped]:
        """Stream every raw point in expansion order without holding the
        list; ``expand()`` is this plus skip-record dedup."""
        for i in range(self.n_points):
            yield self.point_at(i)

    def expand(self) -> tuple[list[Scenario], list[Skipped]]:
        self._validate()
        scenarios: list[Scenario] = []
        skipped: list[Skipped] = []
        # dedup skips per (graph, accel, problem, dram) block: the same
        # incompatibility recurring across memory-axis x override x layout
        # combinations is one record, not one per combination
        shape = self.axis_shape
        block = math.prod(shape[4:])  # points per dram block
        seen: set[tuple] = set()
        for i, out in enumerate(self.iter_points()):
            if isinstance(out, Scenario):
                scenarios.append(out)
                continue
            key = (i // block, out.reason, out.label)
            if key not in seen:
                seen.add(key)
                skipped.append(out)
        return scenarios, skipped

    def scenarios(self) -> list[Scenario]:
        return self.expand()[0]
