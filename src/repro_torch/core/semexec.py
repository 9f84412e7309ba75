"""Device-resident semantic execution (the ``semexec`` axis).

The accelerator models' semantic halves -- the per-iteration edge
processing that decides values, update counts and changed sets -- run
host-side in numpy by default.  This module provides the ``device``
engine: the same semantics as PyTorch steps on an explicit
``torch.device``, built on the port's kernels
(``kernels.edge_update.scatter_min``, ``kernels.spmv.spmv_edges``), with
graph state (value vectors, frontier bitmaps) resident on the device across
iterations.  Per iteration only small products cross to the host -- a
changed bitmap, per-partition update counts, per-interval dirty flags --
exactly what trace assembly (which stays host-side: the lazy trace IR needs
eager lengths for merge orders) and the termination logic consume.

Byte identity contract (tests/test_torch_semexec.py, and ``chip_smoke.py``
on the card):

- min problems (bfs/wcc/sssp) use f32 min-propagation, which is
  order-independent and exact, and the per-edge candidate arithmetic is
  the same IEEE op sequence -- so values, iteration counts, changed sets and
  therefore request traces are *bit-identical* to the numpy engine.
- acc problems (pr/spmv) have value-independent traces in all four models
  (update counts and changed destination sets are static for a single
  accumulation iteration), so traces stay byte-identical while values
  match to float tolerance (the sums associate differently from
  ``np.add.at``).

Kernel selection follows the tensors' device.  On CUDA the min steps of
HitGraph, ThunderGP and ForeGraph launch the edge-update kernel (B2) and
every accumulation step launches the ELL SpMV kernel (B3) over an ELL
layout built with the step's layout; on the CPU the same calls take the
kernels' plain versions (``scatter_reduce``/``index_add_``).  AccuGraph's
Gauss-Seidel segment ops and the HitGraph/ForeGraph counts and flags are
plain torch ops on either device, as they are XLA ops outside any Pallas
kernel in the reference.

The reference's reduce plans (scatter-free gather tables for XLA's serial
CPU scatter) and its power-of-two / edge-block padding (jit shape classes,
the Pallas block) have no counterpart here: torch's CPU scatters are not
serial, PyTorch runs eagerly, and the CUDA kernels take any m and n.

``resolve_engine`` maps a requested engine to the effective one: pairs
without a device formulation fall back to numpy with a one-time warning.
Per-graph device layouts are built once and cached in
``hostcache.ARTIFACTS`` keyed on the graph fingerprint and the device.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from repro_torch.core.hostcache import ARTIFACTS
from repro_torch.kernels.edge_update.ops import scatter_min
from repro_torch.kernels.spmv.ops import spmv_edges
from repro_torch.kernels.spmv.spmv import to_ell

ENGINES = ("numpy", "device")

# (accelerator -> problems) with a device formulation.  Everything a model
# supports is covered except weighted problems on models that don't take
# weights (those raise before engine resolution anyway).
SUPPORTED: dict[str, frozenset] = {
    "hitgraph": frozenset({"bfs", "wcc", "sssp", "pr", "spmv"}),
    "thundergp": frozenset({"bfs", "wcc", "sssp", "pr", "spmv"}),
    "accugraph": frozenset({"bfs", "wcc", "pr"}),
    "foregraph": frozenset({"bfs", "wcc", "pr"}),
}

_FALLBACK_WARNED: set[tuple[str, str]] = set()

F32 = torch.float32
I64 = torch.int64


def validate_engine(engine: str) -> None:
    if engine not in ENGINES:
        raise ValueError(
            f"unknown semantic engine {engine!r}; expected one of {ENGINES}")


def resolve_engine(accel: str, problem_name: str, requested: str) -> str:
    """Effective engine for (accelerator, problem): ``device`` when a
    device formulation exists, else ``numpy`` with a one-time warning."""
    validate_engine(requested)
    if requested == "numpy":
        return "numpy"
    if problem_name in SUPPORTED.get(accel, frozenset()):
        return "device"
    key = (accel, problem_name)
    if key not in _FALLBACK_WARNED:
        _FALLBACK_WARNED.add(key)
        warnings.warn(
            f"semexec: no device formulation for {accel}/{problem_name}; "
            f"falling back to the numpy engine", UserWarning, stacklevel=2)
    return "numpy"


# ---------------------------------------------------------------------------
# layout helpers (host-side, one-time per graph layout)
# ---------------------------------------------------------------------------


def _pad_to(a: np.ndarray, length: int, fill, dtype) -> np.ndarray:
    out = np.full(length, fill, dtype=dtype)
    out[: len(a)] = a
    return out


def _on(a: np.ndarray, device: torch.device, dtype=None) -> torch.Tensor:
    """A copy of ``a`` on ``device`` (never a view of the numpy buffer, so
    a cached layout cannot alias host arrays)."""
    return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)


def _min_delta(problem_name: str, w: np.ndarray | None, m: int) -> np.ndarray:
    """Additive per-edge delta of the min problems (cand = v[src] + delta)."""
    if problem_name == "bfs":
        return np.ones(m, dtype=np.float32)
    if problem_name == "wcc":
        return np.zeros(m, dtype=np.float32)
    if problem_name == "sssp":
        return np.asarray(w, dtype=np.float32)
    raise ValueError(problem_name)


def _acc_weight(problem_name: str, src: np.ndarray,
                w: np.ndarray | None, deg_out: np.ndarray) -> np.ndarray:
    """Multiplicative per-edge weight of the acc problems
    (cand = v[src] * w_eff)."""
    if problem_name == "pr":
        inv = (1.0 / np.maximum(deg_out, 1.0)).astype(np.float32)
        return inv[src]
    if problem_name == "spmv":
        return np.asarray(w, dtype=np.float32)
    raise ValueError(problem_name)


def _acc_layout(src: np.ndarray, dst: np.ndarray, w_eff: np.ndarray, n: int,
                device: torch.device) -> dict:
    """COO arrays of an accumulation step, plus the ELL layout the SpMV
    kernel reads on CUDA (the CPU's plain path sums the COO arrays)."""
    ell = None
    if device.type == "cuda":
        idx, val = to_ell(src, dst, w_eff, n)
        ell = (_on(idx, device), _on(val, device))
    return dict(src=_on(src, device, torch.int32), dst=_on(dst, device, torch.int32),
                w=_on(w_eff, device, F32), ell=ell)


def _acc_consts(problem, n: int) -> tuple[float, float]:
    """(base, scale) of ``new = base + scale * A @ values``, rounded to f32
    like the reference's ``jnp.float32`` constants."""
    if problem.name == "pr":
        return float(np.float32((1.0 - 0.85) / n)), float(np.float32(0.85))
    return 0.0, 1.0


# ---------------------------------------------------------------------------
# per-iteration steps
# ---------------------------------------------------------------------------


def _hitgraph_min_step(values, active, proc, lay, *, use_filter, use_skip,
                       combine, k):
    """One HitGraph scatter+gather iteration: global masked scatter-min plus
    the per-destination-partition update counts the trace assembly needs.
    ``kept`` reproduces the model's update-filtering (active-source bitmap)
    and partition-skipping masks; with update combining the count per
    partition j is the number of (source partition, destination) runs
    containing a kept edge -- dst is sorted within each routed block, so
    runs == unique destinations."""
    kept = torch.ones_like(lay["src_idx"], dtype=torch.bool)
    if use_skip:
        kept &= proc[lay["part"]]
    if use_filter:
        kept &= active[lay["src_idx"]]
    acc = scatter_min(lay["src"], lay["dst"], lay["delta"], values, mask=kept)
    changed = acc < values
    new = torch.minimum(values, acc)
    ki = kept.to(I64)
    nupd = torch.zeros(k, dtype=I64, device=values.device)
    if combine:
        run_has = torch.zeros(lay["runs"], dtype=I64, device=values.device)
        run_has.scatter_reduce_(0, lay["run_id"], ki, "amax")  # in place
        nupd.index_add_(0, lay["run_j"], run_has)
    else:
        nupd.index_add_(0, lay["jid"], ki)
    return new, changed, nupd


def _jacobi_min_step(values, lay):
    """ThunderGP's synchronous iteration: the per-(partition, chunk)
    partial accumulations combine to exactly the global scatter-min
    (disjoint destination intervals, Jacobi source snapshot)."""
    acc = scatter_min(lay["src"], lay["dst"], lay["delta"], values)
    return torch.minimum(values, acc), (acc < values).any()


def _acc_step(values, lay, base: float, scale: float):
    """Shared accumulation iteration: new = base + scale * A @ values,
    with A[dst, src] = w_eff."""
    y = spmv_edges(lay["src"], lay["dst"], lay["w"], values, values.shape[0],
                   ell=lay["ell"])
    return y.mul_(scale).add_(base)  # in place on the fresh product


def _gs_min_step(values, lay_p, delta: float):
    """One AccuGraph partition under Gauss-Seidel (live values): segment
    min over the partition's unique destinations, applied to ``values`` in
    place (``ud`` holds each destination once)."""
    cand = values[lay_p["esrc"]] + delta
    acc = torch.full((lay_p["ud"].shape[0],), float("inf"), dtype=F32,
                     device=values.device)
    acc.scatter_reduce_(0, lay_p["einv"], cand, "amin")
    old = values[lay_p["ud"]]
    values[lay_p["ud"]] = torch.minimum(old, acc)
    return values, acc < old


def _gs_acc_step(values, snapshot, lay_p, scale: float):
    """One AccuGraph partition of an accumulation iteration: reads the
    pre-iteration snapshot and adds into the base-initialised ``values`` in
    place."""
    cand = snapshot[lay_p["esrc"]] * lay_p["ew"]
    acc = torch.zeros(lay_p["ud"].shape[0], dtype=F32, device=values.device)
    acc.index_add_(0, lay_p["einv"], cand)
    return values.index_add_(0, lay_p["ud"], acc.mul_(scale))


def _fg_min_step(values, shards, q: int, interval: int):
    """One ForeGraph source-interval visit as three sequential scatter-mins
    that reproduce the shard-order Gauss-Seidel exactly: shards (i, j<i)
    read the still-pristine source interval i and write disjoint intervals;
    shard (i, i) reads pre-state and writes interval i; shards (i, j>i) read
    the post-(i,i) interval i.  Returns the values and per-interval changed
    flags (the dirty bits)."""
    n = values.shape[0]
    hit = torch.zeros(q * interval, dtype=torch.bool, device=values.device)
    for src, dst, delta in shards:
        if src.shape[0] == 0:
            continue
        acc = scatter_min(src, dst, delta, values)
        hit[:n] |= acc < values  # in place on the view
        values = torch.minimum(values, acc)
    return values, hit.view(q, interval).any(1)


# ---------------------------------------------------------------------------
# HitGraph
# ---------------------------------------------------------------------------


def _build_hitgraph_min(g, problem, prep, k: int, ivl: int,
                        device: torch.device) -> dict:
    srcs, dsts, dls, ps = [], [], [], []
    for i in range(k):
        pi = prep[i]
        r = pi["route"]
        srcs.append(pi["src"][r])
        dsts.append(pi["dst"][r])
        ps.append(np.full(len(r), i, dtype=np.int32))
        if problem.name == "sssp":
            dls.append(pi["w"][r])
    gsrc = np.concatenate(srcs).astype(np.int32)
    gdst = np.concatenate(dsts).astype(np.int32)
    gpart = np.concatenate(ps)
    m = len(gsrc)
    delta = (np.concatenate(dls).astype(np.float32) if dls
             else _min_delta(problem.name, None, m))
    gjid = (gdst // ivl).astype(np.int32)
    # runs of equal (source partition, destination) in routed order -- the
    # unit update combining collapses to (dst is ascending within each
    # routed block when edge sorting is on, which combining requires)
    if m:
        change = np.empty(m, dtype=bool)
        change[0] = True
        change[1:] = (gdst[1:] != gdst[:-1]) | (gpart[1:] != gpart[:-1])
        run_id = np.cumsum(change) - 1
        runs = int(run_id[-1]) + 1
        run_j = gjid[change]
    else:
        run_id = np.zeros(0, dtype=np.int64)
        runs = 1
        run_j = np.zeros(0, dtype=np.int32)
    return dict(
        src=_on(gsrc, device),
        src_idx=_on(gsrc, device, I64),
        dst=_on(gdst, device),
        delta=_on(delta, device, F32),
        part=_on(gpart, device, I64),
        jid=_on(gjid, device, I64),
        run_id=_on(run_id, device, I64),
        # an empty edge list still has one (empty) run, counted into j = 0
        run_j=_on(_pad_to(run_j, runs, 0, np.int64), device),
        runs=runs,
    )


def _build_hitgraph_acc(g, problem, parts, k: int, ivl: int,
                        device: torch.device) -> dict:
    w_eff = _acc_weight(problem.name, g.src, g.weights, g.degrees_out)
    # static trace products: update counts and changed (written) vertex
    # sets per destination partition -- value-independent for a single
    # accumulation iteration
    nupd_plain = np.bincount(g.dst // ivl, minlength=k).astype(np.int64)
    pd = (g.src.astype(np.int64) // ivl) * g.n + g.dst
    u = np.unique(pd)
    nupd_combine = np.bincount((u % g.n) // ivl, minlength=k).astype(np.int64)
    ud_all = np.unique(g.dst)
    bounds = [parts.interval(j)[0] for j in range(k)] + [g.n]
    cuts = np.searchsorted(ud_all, bounds)
    changed_j = [ud_all[cuts[j]: cuts[j + 1]] for j in range(k)]
    return dict(
        **_acc_layout(g.src, g.dst, w_eff, g.n, device),
        nupd_plain=nupd_plain,
        nupd_combine=nupd_combine,
        changed_j=changed_j,
    )


class HitGraphDevice:
    """Device state + per-iteration steps for the HitGraph model."""

    def __init__(self, g, problem, prep, parts, k: int, ivl: int,
                 sort_opt: bool, weighted: bool,
                 filter_opt: bool, skip_opt: bool, combine_opt: bool,
                 device: torch.device):
        self.k = k
        self.device = device
        self.filter_opt = filter_opt
        self.skip_opt = skip_opt
        self.combine_opt = combine_opt
        key = (g.fingerprint, "semexec.hitgraph", ivl, sort_opt, weighted,
               problem.name, str(device))
        if problem.kind == "min":
            self.lay = ARTIFACTS.get_or_build(
                key, lambda: _build_hitgraph_min(g, problem, prep, k, ivl, device))
        else:
            self.base, self.scale = _acc_consts(problem, g.n)
            self.lay = ARTIFACTS.get_or_build(
                key, lambda: _build_hitgraph_acc(g, problem, parts, k, ivl, device))

    def min_step(self, values_dev, active: np.ndarray, proc: np.ndarray):
        new, changed, nupd = _hitgraph_min_step(
            values_dev, _on(active, self.device), _on(proc, self.device), self.lay,
            use_filter=self.filter_opt, use_skip=self.skip_opt,
            combine=self.combine_opt, k=self.k)
        return new, changed.cpu().numpy(), nupd.cpu().numpy()

    def acc_step(self, values_dev):
        return _acc_step(values_dev, self.lay, self.base, self.scale)

    def nupd_static(self) -> np.ndarray:
        return self.lay["nupd_combine" if self.combine_opt else "nupd_plain"]

    def changed_static(self, j: int) -> np.ndarray:
        return self.lay["changed_j"][j]


# ---------------------------------------------------------------------------
# AccuGraph
# ---------------------------------------------------------------------------


def _build_accugraph(g, problem, part_edges, k: int,
                     device: torch.device) -> dict:
    parts, ud_host = [], []
    for p in range(k):
        src, _dst, udp, inv = part_edges[p]
        lay_p = dict(esrc=_on(src, device, I64), einv=_on(inv, device, I64),
                     ud=_on(udp, device, I64))
        if problem.kind == "acc":
            w_eff = _acc_weight(problem.name, src, None, g.degrees_out)
            lay_p["ew"] = _on(w_eff, device, F32)
        parts.append(lay_p)
        ud_host.append(np.asarray(udp))
    return dict(parts=parts, ud_host=ud_host)


class AccuGraphDevice:
    """Device state + per-partition Gauss-Seidel steps for AccuGraph."""

    def __init__(self, g, problem, part_edges, k: int, ivl: int,
                 device: torch.device):
        self.lay = ARTIFACTS.get_or_build(
            (g.fingerprint, "semexec.accugraph", ivl, problem.name, str(device)),
            lambda: _build_accugraph(g, problem, part_edges, k, device),
        )
        if problem.kind == "min":
            self.delta = 1.0 if problem.name == "bfs" else 0.0
        else:
            self.scale = _acc_consts(problem, g.n)[1]

    def ud_host(self, p: int) -> np.ndarray:
        return self.lay["ud_host"][p]

    def min_step(self, values_dev, p: int):
        if len(self.lay["ud_host"][p]) == 0:
            return values_dev, np.zeros(0, dtype=bool)
        new, changed = _gs_min_step(values_dev, self.lay["parts"][p], self.delta)
        return new, changed.cpu().numpy()

    def acc_step(self, values_dev, snapshot_dev, p: int):
        if len(self.lay["ud_host"][p]) == 0:
            return values_dev
        return _gs_acc_step(values_dev, snapshot_dev, self.lay["parts"][p],
                            self.scale)


# ---------------------------------------------------------------------------
# ThunderGP
# ---------------------------------------------------------------------------


def _build_thundergp(g, problem, prep, k: int, p: int,
                     device: torch.device) -> dict:
    srcs = [prep[i][c]["src"] for i in range(k) for c in range(p)]
    dsts = [prep[i][c]["dst"] for i in range(k) for c in range(p)]
    gsrc = np.concatenate(srcs).astype(np.int32)
    gdst = np.concatenate(dsts).astype(np.int32)
    m = len(gsrc)
    w = None
    if problem.needs_weights:
        w = np.concatenate([prep[i][c]["w"] for i in range(k) for c in range(p)])
    if problem.kind == "min":
        return dict(src=_on(gsrc, device), dst=_on(gdst, device),
                    delta=_on(_min_delta(problem.name, w, m), device, F32))
    w_eff = _acc_weight(problem.name, gsrc, w, g.degrees_out)
    return _acc_layout(gsrc, gdst, w_eff, g.n, device)


class ThunderGPDevice:
    """Device state + synchronous iteration steps for ThunderGP."""

    def __init__(self, g, problem, prep, k: int, p: int, ivl: int,
                 weighted: bool, device: torch.device):
        self.lay = ARTIFACTS.get_or_build(
            (g.fingerprint, "semexec.thundergp", ivl, p, weighted,
             problem.name, str(device)),
            lambda: _build_thundergp(g, problem, prep, k, p, device),
        )
        if problem.kind == "acc":
            self.base, self.scale = _acc_consts(problem, g.n)

    def min_step(self, values_dev):
        new, anyc = _jacobi_min_step(values_dev, self.lay)
        return new, bool(anyc)

    def acc_step(self, values_dev):
        return _acc_step(values_dev, self.lay, self.base, self.scale)


# ---------------------------------------------------------------------------
# ForeGraph
# ---------------------------------------------------------------------------


def _build_foregraph(g, problem, sizes, shard_edges, interval: int, q: int,
                     device: torch.device) -> dict:
    def cat(pairs, which: int) -> np.ndarray:
        return (np.concatenate([e[which] for e in pairs]).astype(np.int32)
                if pairs else np.zeros(0, dtype=np.int32))

    if problem.kind == "acc":
        pairs = [shard_edges[(i, j)] for i in range(q) for j in range(q)
                 if sizes[i, j]]
        gsrc, gdst = cat(pairs, 0), cat(pairs, 1)
        w_eff = _acc_weight(problem.name, gsrc, None, g.degrees_out)
        return _acc_layout(gsrc, gdst, w_eff, g.n, device)

    if q * interval < g.n:
        raise ValueError(f"{q} intervals of {interval} do not cover {g.n} vertices")
    delta = 1.0 if problem.name == "bfs" else 0.0

    def pack(i: int, js: range):
        es = [shard_edges[(i, j)] for j in js if sizes[i, j]]
        src, dst = cat(es, 0), cat(es, 1)
        return (_on(src, device), _on(dst, device),
                torch.full((len(src),), delta, dtype=F32, device=device))

    # per source interval i: shards (i, j<i), (i, i), (i, j>i)
    abc = [(pack(i, range(i)), pack(i, range(i, i + 1)), pack(i, range(i + 1, q)))
           for i in range(q)]
    return dict(abc=abc)


class ForeGraphDevice:
    """Device state + per-source-interval steps for ForeGraph.

    ``min_step`` must be dispatched interval-by-interval with a host sync:
    a later interval's shard-skip decision reads dirty flags that earlier
    intervals of the *same* iteration may have set (immediate
    propagation)."""

    def __init__(self, g, problem, sizes, shard_edges, interval: int,
                 q: int, device: torch.device):
        self.q = q
        self.interval = interval
        self.lay = ARTIFACTS.get_or_build(
            (g.fingerprint, "semexec.foregraph", interval, problem.name,
             str(device)),
            lambda: _build_foregraph(g, problem, sizes, shard_edges,
                                     interval, q, device),
        )
        if problem.kind == "acc":
            self.base, self.scale = _acc_consts(problem, g.n)

    def min_step(self, values_dev, i: int):
        new, flags = _fg_min_step(values_dev, self.lay["abc"][i], self.q,
                                  self.interval)
        return new, flags.cpu().numpy()

    def acc_step(self, values_dev):
        return _acc_step(values_dev, self.lay, self.base, self.scale)
