"""Scenario -> design-vector encoding for the sweep surrogates.

The design space is almost entirely categorical (accelerator, mapping
scheme, page policy, reorder...), with a few ordered numeric axes
(channel count, interval scale).  The encoder works in two passes so a
candidate pool can be *streamed* out of ``SweepSpec.scenario_at`` without
holding the Scenario objects:

1. ``raw(scenario)`` reduces a scenario to a small tuple of plain axis
   values (strings and ints) — this is all that is retained per candidate;
2. ``fit(raws)`` builds the per-field vocabularies from the pool, and
   ``matrix(raws)`` renders the pool as a dense float64 design matrix —
   one-hot columns for categorical fields (only those with more than one
   observed value), standardised numeric columns for ordered fields.

Vocabularies come from the observed pool, not the spec axes, so derived
values (a DRAM preset crossed with channel counts, a ForeGraph-clamped
interval) encode exactly as they ran.  Encoding is deterministic: fields
in fixed order, vocabularies sorted.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.sweep.spec import Scenario

# (name, extractor, is_numeric) in fixed order — the raw-tuple layout.
_FIELDS: list[tuple[str, object, bool]] = [
    ("graph", lambda s: s.graph.name, False),
    ("accelerator", lambda s: s.accelerator, False),
    ("problem", lambda s: s.problem, False),
    ("dram", lambda s: s.dram.name, False),
    ("channels", lambda s: s.dram.channels, True),
    ("address_mapping", lambda s: s.dram.mapping.label, False),
    ("page_policy", lambda s: s.dram.page_policy, False),
    ("pseudo_channels", lambda s: int(s.dram.pseudo_channels), True),
    ("label", lambda s: s.label, False),
    ("reorder", lambda s: s.config.reorder, False),
    ("interval_scale", lambda s: int(math.log2(s.config.interval_scale)),
     True),
    ("engine", lambda s: s.config.semexec, False),
]

FIELD_NAMES: tuple[str, ...] = tuple(name for name, _, _ in _FIELDS)


def raw_features(scenario: Scenario) -> tuple:
    """The retained per-candidate tuple (axis values in ``FIELD_NAMES``
    order); also the identity the frontier query groups contexts by."""
    return tuple(fn(scenario) for _, fn, _ in _FIELDS)


class FeatureEncoder:
    """Raw axis tuples -> dense design matrix (see module docstring)."""

    def __init__(self) -> None:
        self._columns: list[tuple[int, str, object]] = []
        self.feature_names: list[str] = []
        self.fitted = False

    def fit(self, raws: list[tuple]) -> "FeatureEncoder":
        self._columns = []
        self.feature_names = []
        for fi, (name, _, numeric) in enumerate(_FIELDS):
            values = sorted({r[fi] for r in raws}, key=str)
            if len(values) < 2:
                continue  # a constant axis carries no design information
            if numeric:
                lo, hi = float(min(values)), float(max(values))
                self._columns.append((fi, "num", (lo, hi - lo)))
                self.feature_names.append(name)
            else:
                self._columns.append((fi, "cat", values))
                self.feature_names.extend(f"{name}={v}" for v in values)
        self.fitted = True
        return self

    @property
    def dim(self) -> int:
        return len(self.feature_names)

    def matrix(self, raws: list[tuple]) -> np.ndarray:
        """[n, dim] float64 design matrix for a list of raw tuples."""
        assert self.fitted, "fit() before matrix()"
        X = np.zeros((len(raws), self.dim))
        col = 0
        for fi, kind, meta in self._columns:
            if kind == "num":
                lo, span = meta
                vals = np.array([float(r[fi]) for r in raws])
                X[:, col] = (vals - lo) / (span or 1.0)
                col += 1
            else:
                index = {v: j for j, v in enumerate(meta)}
                for i, r in enumerate(raws):
                    j = index.get(r[fi])
                    if j is not None:  # unseen value: all-zero block
                        X[i, col + j] = 1.0
                col += len(meta)
        return X

    def describe(self, raw: tuple, skip: tuple[str, ...] = ()) -> dict:
        """Human-readable axis dict for one raw tuple (varying fields
        only), e.g. for frontier-context reporting."""
        out = {}
        varying = {self._columns[i][0] for i in range(len(self._columns))}
        for fi, (name, _, _) in enumerate(_FIELDS):
            if fi in varying and name not in skip:
                out[name] = raw[fi]
        return out
