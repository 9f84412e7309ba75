"""Adaptive sweep search: answer design-space queries on a fraction of
the grid.

The package splits into four layers (each its own module):

- :mod:`~repro_torch.sweep.search.encoder` — Scenario axes -> raw tuples ->
  dense design matrix;
- :mod:`~repro_torch.sweep.search.surrogate` — pluggable numpy-pure
  surrogates (bootstrap forest, GP-lite) with predictive uncertainty;
- :mod:`~repro_torch.sweep.search.acquisition` — EI/UCB scoring and
  epsilon-greedy batch proposal (pure seeded random at tiny budgets);
- :mod:`~repro_torch.sweep.search.loop` — the propose/execute/observe loop:
  warm start from the content-addressed cache, objective and frontier
  query modes, probes byte-identical to grid sweeps.

It is the reference's ``repro.sweep.search`` module for module: the
encoder, surrogates and acquisition are the same numpy (same seeded
generators, bit-equal results), and the loop's probes run through the
port's runner on one device (``device=None``: the CUDA card, raising
without one).
"""
from repro_torch.sweep.search.acquisition import (
    expected_improvement,
    norm_cdf,
    norm_pdf,
    propose,
    ucb,
)
from repro_torch.sweep.search.encoder import FIELD_NAMES, FeatureEncoder, raw_features
from repro_torch.sweep.search.loop import (
    ACQUISITIONS,
    MODES,
    RunnerExecutor,
    SearchAborted,
    SearchResult,
    SearchSpec,
    run_search,
)
from repro_torch.sweep.search.surrogate import (
    SURROGATES,
    ForestSurrogate,
    GPSurrogate,
    make_surrogate,
)

__all__ = [
    "ACQUISITIONS",
    "FIELD_NAMES",
    "MODES",
    "SURROGATES",
    "FeatureEncoder",
    "ForestSurrogate",
    "GPSurrogate",
    "RunnerExecutor",
    "SearchAborted",
    "SearchResult",
    "SearchSpec",
    "expected_improvement",
    "make_surrogate",
    "norm_cdf",
    "norm_pdf",
    "propose",
    "raw_features",
    "run_search",
    "ucb",
]
