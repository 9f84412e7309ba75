"""Semantic-execution engine selection (the ``semexec`` axis).

The reference offers two engines for the per-iteration graph semantics:
``numpy`` (host-side, the accelerator models' own code) and ``device``
(fused device steps over the edge-update and SpMV kernels).  This package
runs the ``numpy`` engine; ``device`` is rejected with
``NotImplementedError`` rather than silently falling back, so a run never
reports an engine it did not use.
"""
from __future__ import annotations

ENGINES = ("numpy", "device")


def validate_engine(engine: str) -> None:
    if engine not in ENGINES:
        raise ValueError(
            f"unknown semantic engine {engine!r}; expected one of {ENGINES}")
    if engine == "device":
        raise NotImplementedError(
            "semexec='device' is ported in a later slice")


def resolve_engine(accel: str, problem_name: str, requested: str) -> str:
    """Effective engine for (accelerator, problem): always ``numpy``."""
    validate_engine(requested)
    return "numpy"
