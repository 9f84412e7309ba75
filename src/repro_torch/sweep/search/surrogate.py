"""Pluggable surrogates over the design space — pure numpy, no new deps.

Both surrogates map an observed design matrix to a predictive mean *and*
uncertainty (the acquisition functions need both):

- :class:`ForestSurrogate` — a bootstrap ensemble of depth-limited
  regression trees with random feature subsets (random-forest-style).
  The ensemble spread is the uncertainty.  Robust on the one-hot,
  interaction-heavy sweep axes (page policy flips the objective by 5x on
  some accelerators and barely moves it on others), needs no kernel
  tuning, and fits hundreds of observations in milliseconds.
- :class:`GPSurrogate` — GP-lite: an RBF-kernel Gaussian process with a
  median-distance lengthscale heuristic and a jitter nugget.  Smoother
  extrapolation on small observation sets; O(n^3) in observations, which
  is irrelevant at search budgets.

Everything is deterministic under the caller's ``numpy.random.Generator``
— tree bootstraps, feature subsets — so a seeded search replays exactly.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class _Tree:
    """Array-coded regression tree: ``feature[i] < 0`` marks a leaf."""

    feature: np.ndarray
    threshold: np.ndarray
    left: np.ndarray
    right: np.ndarray
    value: np.ndarray
    depth: int

    def predict(self, X: np.ndarray) -> np.ndarray:
        node = np.zeros(len(X), dtype=np.int64)
        for _ in range(self.depth + 1):
            f = self.feature[node]
            internal = f >= 0
            if not internal.any():
                break
            fx = X[np.arange(len(X)), np.maximum(f, 0)]
            go_left = fx <= self.threshold[node]
            node = np.where(internal,
                            np.where(go_left, self.left[node],
                                     self.right[node]),
                            node)
        return self.value[node]


def _grow_tree(X: np.ndarray, y: np.ndarray, rng: np.random.Generator,
               max_depth: int, min_leaf: int,
               feature_frac: float) -> _Tree:
    feature, threshold, left, right, value = [], [], [], [], []
    d = X.shape[1]
    n_try = max(1, int(round(d * feature_frac)))

    def leaf(idx) -> int:
        feature.append(-1)
        threshold.append(0.0)
        left.append(0)
        right.append(0)
        value.append(float(y[idx].mean()))
        return len(feature) - 1

    def build(idx: np.ndarray, depth: int) -> int:
        ys = y[idx]
        if (depth >= max_depth or len(idx) < 2 * min_leaf
                or ys.max() - ys.min() <= 0):
            return leaf(idx)
        best = None  # (sse, feature, threshold, mask)
        for f in rng.choice(d, size=n_try, replace=False):
            xs = X[idx, f]
            cuts = np.unique(xs)
            if len(cuts) < 2:
                continue
            for t in (cuts[:-1] + cuts[1:]) / 2.0:
                m = xs <= t
                nl = int(m.sum())
                if nl < min_leaf or len(idx) - nl < min_leaf:
                    continue
                yl, yr = ys[m], ys[~m]
                sse = (((yl - yl.mean()) ** 2).sum()
                       + ((yr - yr.mean()) ** 2).sum())
                if best is None or sse < best[0]:
                    best = (sse, int(f), float(t), m)
        if best is None:
            return leaf(idx)
        _, f, t, m = best
        node = leaf(idx)  # placeholder; overwrite as internal
        feature[node] = f
        threshold[node] = t
        left[node] = build(idx[m], depth + 1)
        right[node] = build(idx[~m], depth + 1)
        return node

    build(np.arange(len(y)), 0)
    return _Tree(np.array(feature), np.array(threshold),
                 np.array(left), np.array(right), np.array(value),
                 max_depth)


class ForestSurrogate:
    """Bootstrap ensemble of regression trees; spread = uncertainty."""

    def __init__(self, n_trees: int = 24, max_depth: int = 8,
                 min_leaf: int = 2, feature_frac: float = 0.8):
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.min_leaf = min_leaf
        self.feature_frac = feature_frac
        self._trees: list[_Tree] = []
        self._y_std = 1.0

    def fit(self, X: np.ndarray, y: np.ndarray,
            rng: np.random.Generator) -> "ForestSurrogate":
        n = len(y)
        self._y_std = float(y.std()) or 1.0
        self._trees = []
        for _ in range(self.n_trees):
            boot = rng.integers(0, n, size=n)
            self._trees.append(_grow_tree(X[boot], y[boot], rng,
                                          self.max_depth, self.min_leaf,
                                          self.feature_frac))
        return self

    def predict(self, X: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        preds = np.stack([t.predict(X) for t in self._trees])
        # floor the spread: a pool point all trees agree on is still not
        # a certainty — the ensemble only saw bootstraps of the probes
        return preds.mean(axis=0), np.maximum(preds.std(axis=0),
                                              1e-3 * self._y_std)


class GPSurrogate:
    """RBF-kernel GP with median-distance lengthscale and jitter nugget."""

    def __init__(self, lengthscale: float | None = None,
                 noise: float = 1e-3):
        self.lengthscale = lengthscale
        self.noise = noise
        self._X: np.ndarray | None = None

    @staticmethod
    def _sqdist(A: np.ndarray, B: np.ndarray) -> np.ndarray:
        return np.maximum(
            (A * A).sum(1)[:, None] + (B * B).sum(1)[None, :]
            - 2.0 * (A @ B.T), 0.0)

    def fit(self, X: np.ndarray, y: np.ndarray,
            rng: np.random.Generator) -> "GPSurrogate":
        self._X = X
        self._y_mean = float(y.mean())
        self._y_std = float(y.std()) or 1.0
        yn = (y - self._y_mean) / self._y_std
        d2 = self._sqdist(X, X)
        if self.lengthscale is None:
            off = d2[np.triu_indices(len(X), k=1)]
            med = float(np.median(off[off > 0])) if (off > 0).any() else 1.0
            self._ls2 = med
        else:
            self._ls2 = self.lengthscale ** 2
        K = np.exp(-0.5 * d2 / self._ls2)
        K[np.diag_indices_from(K)] += self.noise + 1e-8
        self._chol = np.linalg.cholesky(K)
        self._alpha = np.linalg.solve(
            self._chol.T, np.linalg.solve(self._chol, yn))
        return self

    def predict(self, X: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        Ks = np.exp(-0.5 * self._sqdist(X, self._X) / self._ls2)
        mean = Ks @ self._alpha
        v = np.linalg.solve(self._chol, Ks.T)
        var = np.maximum(1.0 - (v * v).sum(axis=0), 1e-9)
        return (mean * self._y_std + self._y_mean,
                np.sqrt(var) * self._y_std)


SURROGATES = {
    "forest": ForestSurrogate,
    "gp": GPSurrogate,
}


def make_surrogate(name: str):
    try:
        return SURROGATES[name]()
    except KeyError:
        raise ValueError(f"unknown surrogate {name!r} "
                         f"(available: {', '.join(SURROGATES)})")
