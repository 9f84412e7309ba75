"""Discrete acquisition over a finite candidate pool.

Everything here scores *minimization* internally (the loop negates
maximization objectives), ranks candidates, and composes a proposal
batch:

- ``expected_improvement`` — EI against the incumbent; the workhorse once
  the surrogate has signal.
- ``ucb`` — lower-confidence-bound score (named UCB by convention).
- ``propose`` — top-k by score with epsilon-greedy exploration: each
  batch slot independently flips a seeded coin and, on exploration, takes
  a uniformly random unprobed candidate instead of the next-ranked one.
  With few observations the surrogate is noise, so the loop's bandit
  fallback calls ``propose`` with ``epsilon=1.0`` — pure seeded random
  sampling — which is also the tiny-budget degenerate mode.

The normal CDF uses the Abramowitz-Stegun rational approximation (7.1.26,
|err| < 1.5e-7) so the module stays numpy-pure.
"""
from __future__ import annotations

import numpy as np


def _erf(x: np.ndarray) -> np.ndarray:
    a1, a2, a3, a4, a5 = (0.254829592, -0.284496736, 1.421413741,
                          -1.453152027, 1.061405429)
    p = 0.3275911
    sign = np.sign(x)
    ax = np.abs(x)
    t = 1.0 / (1.0 + p * ax)
    poly = ((((a5 * t + a4) * t + a3) * t + a2) * t + a1) * t
    return sign * (1.0 - poly * np.exp(-ax * ax))


def norm_cdf(z: np.ndarray) -> np.ndarray:
    return 0.5 * (1.0 + _erf(np.asarray(z, dtype=float) / np.sqrt(2.0)))


def norm_pdf(z: np.ndarray) -> np.ndarray:
    z = np.asarray(z, dtype=float)
    return np.exp(-0.5 * z * z) / np.sqrt(2.0 * np.pi)


def expected_improvement(mean: np.ndarray, std: np.ndarray,
                         best: float) -> np.ndarray:
    """EI of each candidate vs the incumbent ``best`` (minimization)."""
    std = np.maximum(np.asarray(std, dtype=float), 1e-12)
    imp = best - np.asarray(mean, dtype=float)
    z = imp / std
    return imp * norm_cdf(z) + std * norm_pdf(z)


def ucb(mean: np.ndarray, std: np.ndarray, kappa: float = 1.6) -> np.ndarray:
    """Optimism score: higher is more worth probing (minimization)."""
    return -(np.asarray(mean, dtype=float)
             - kappa * np.asarray(std, dtype=float))


def propose(scores: np.ndarray, k: int, rng: np.random.Generator,
            epsilon: float = 0.0) -> list[int]:
    """Pick ``k`` distinct positions from ``scores`` (higher = better):
    greedy by rank, each slot epsilon-replaced by a uniform unpicked
    candidate.  Ties break on position, so proposals are deterministic
    under the generator state."""
    n = len(scores)
    k = min(k, n)
    if k <= 0:
        return []
    order = np.argsort(-scores, kind="stable")
    chosen: list[int] = []
    taken = np.zeros(n, dtype=bool)
    rank = 0
    for _ in range(k):
        explore = epsilon > 0.0 and rng.random() < epsilon
        if explore:
            free = np.flatnonzero(~taken)
            pick = int(free[rng.integers(0, len(free))])
        else:
            while taken[order[rank]]:
                rank += 1
            pick = int(order[rank])
        taken[pick] = True
        chosen.append(pick)
    return chosen
