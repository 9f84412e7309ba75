"""The adaptive search loop: answer sweep queries on a fraction of the grid.

``run_search`` drives rounds of *propose -> execute -> observe* over a
:class:`~repro_torch.sweep.spec.SweepSpec` candidate space:

1. The space is streamed through ``SweepSpec.scenario_at`` into a
   candidate pool (raw axis tuples + content hashes; the Scenario objects
   are not retained), subsampled deterministically if it exceeds
   ``max_pool``.
2. The pool is warm-started from the content-addressed result cache in
   one bulk probe — every previously executed scenario (grid sweeps,
   served jobs, earlier searches) is a free observation, so repeated
   searches converge toward zero executions.
3. Each round fits the surrogate on the observations, scores the
   unprobed candidates with the acquisition function (epsilon-greedy
   random sampling until there is enough signal to fit), and proposes the
   next batch.
4. Proposals execute through the *grid* runner path
   (:func:`~repro_torch.sweep.runner.plan_scenarios` +
   :func:`~repro_torch.sweep.runner.execute_chunk`), so every probe's result
   row is byte-identical to the grid-sweep row for the same scenario hash
   and lands in the same cache.

Two query modes:

- ``objective`` — minimize/maximize a result-row column, optionally per
  ``group_by`` group ("best memory config per workload");
- ``frontier`` — the paper's headline question: find the axis settings
  where the ``rank_over`` ranking (which accelerator wins?) *flips*.
  Contexts — candidate subsets identical in everything but the
  ``rank_over`` axis — are scored by the probability that their
  predicted winner is wrong, and the most ambiguous contexts get probed
  first.

The loop is deterministic under ``SearchSpec.seed``: pool subsampling,
surrogate bootstraps and epsilon-exploration all draw from one seeded
generator, and executions are the runner's (deterministic by
construction).

``run_search`` takes ``device=None``: the CUDA card, raising when there is
none (``repro_torch.kernels._platform.resolve_device``), ``"cpu"`` for the
kernels' plain versions.  The device is resolved once, before the pool is
streamed, so a search without its device fails before it proposes
anything; every proposal batch executes on it.  The device is not part of
a cache key, as in the runner: a probe cached on one device is a warm
observation on every other.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

import numpy as np

from repro_torch.kernels._platform import resolve_device
from repro_torch.sweep.cache import ResultCache, scenario_hash
from repro_torch.sweep.results import scenario_row
from repro_torch.sweep.runner import ExecutionPolicy, execute_chunk, plan_scenarios
from repro_torch.sweep.search.acquisition import (
    expected_improvement,
    norm_cdf,
    norm_pdf,
    propose,
    ucb,
)
from repro_torch.sweep.search.encoder import FIELD_NAMES, FeatureEncoder, raw_features
from repro_torch.sweep.search.surrogate import SURROGATES, make_surrogate
from repro_torch.sweep.spec import Scenario, SweepSpec

MODES = ("objective", "frontier")
ACQUISITIONS = ("ei", "ucb")


class SearchAborted(RuntimeError):
    """Raised by an executor to stop a search (cancel/drain on the serve
    path); the loop does not catch it."""


@dataclasses.dataclass(frozen=True)
class SearchSpec:
    """One adaptive search query over a sweep space."""

    space: SweepSpec
    objective: str = "runtime_s"
    direction: str = "min"           # min | max
    mode: str = "objective"          # objective | frontier
    group_by: tuple[str, ...] = ()   # objective mode: best per group
    rank_over: str = "accelerator"   # frontier mode: whose ranking flips
    budget: int = 0                  # max executions; 0 -> budget_frac
    budget_frac: float = 0.25        # fraction of the pool when budget=0
    batch: int = 8                   # proposals per round
    init: int = 0                    # random probes before fitting; 0=auto
    surrogate: str = "forest"
    acquisition: str = "ei"
    epsilon: float = 0.1             # exploration share of each batch
    seed: int = 0
    max_pool: int = 100_000          # candidate-pool cap (seeded subsample)
    patience: int = 0                # objective: stop after N stale rounds

    def __post_init__(self):
        if self.direction not in ("min", "max"):
            raise ValueError(f"direction must be min|max, got {self.direction!r}")
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        if self.acquisition not in ACQUISITIONS:
            raise ValueError(f"acquisition must be one of {ACQUISITIONS}, "
                             f"got {self.acquisition!r}")
        if self.surrogate not in SURROGATES:
            raise ValueError(f"unknown surrogate {self.surrogate!r} "
                             f"(available: {', '.join(SURROGATES)})")
        for f in self.group_by + (self.rank_over,):
            if f not in FIELD_NAMES:
                raise ValueError(f"unknown axis field {f!r} "
                                 f"(available: {', '.join(FIELD_NAMES)})")
        if self.budget < 0 or self.batch < 1 or self.max_pool < 1:
            raise ValueError("budget >= 0, batch >= 1, max_pool >= 1 required")
        if not 0.0 < self.budget_frac <= 1.0:
            raise ValueError(f"budget_frac must be in (0, 1], "
                             f"got {self.budget_frac}")
        if not 0.0 <= self.epsilon <= 1.0:
            raise ValueError(f"epsilon must be in [0, 1], got {self.epsilon}")


@dataclasses.dataclass
class SearchResult:
    """What a search answered, and what it cost."""

    mode: str
    objective: str
    direction: str
    pool: int                 # valid candidates considered
    raw_points: int           # raw cross-product size of the space
    budget: int
    rounds: int
    executed: int             # scenarios actually simulated by this search
    cached: int               # proposals served from the cache mid-search
    warm: int                 # observations inherited at warm-start
    errors: int
    best: dict | None         # objective mode: the winning probe
    groups: dict | None       # objective mode with group_by
    frontier: dict | None     # frontier mode report
    history: list[dict]       # per-round progress (regret-curve substrate)
    probes: list[dict]        # every probed candidate, in probe order
    wall_s: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def summary(self) -> str:
        head = (f"search[{self.mode}]: {self.executed} executed "
                f"(+{self.cached} cached, +{self.warm} warm) of "
                f"{self.pool} candidates in {self.rounds} rounds")
        if self.best is not None:
            head += (f"; best {self.objective}={self.best['value']:.6g} "
                     f"@ {self.best['scenario_id']}")
        if self.frontier is not None:
            head += (f"; {len(self.frontier['flips'])} ranking flips over "
                     f"{self.frontier['contexts']} contexts")
        return head


class RunnerExecutor:
    """Default executor: proposals ride the grid runner path — cache
    short-circuit via :func:`plan_scenarios`, execution via
    :func:`execute_chunk` — so probe rows are byte-identical to grid rows
    and every ok record becomes a reusable cached row.  ``device`` is
    resolved here, once (``None``: the CUDA card, raising without one)."""

    def __init__(self, cache: ResultCache, mode: str = "batch",
                 policy: ExecutionPolicy | None = None,
                 with_trace_hash: bool = False, device=None):
        self.cache = cache
        self.mode = mode
        self.policy = policy
        self.with_trace_hash = with_trace_hash
        self.device = resolve_device(device)

    def __call__(self, scenarios: list[Scenario]) -> list[tuple[dict, str]]:
        plan = plan_scenarios(scenarios, self.cache)
        out: list[tuple[dict, str] | None] = [None] * len(scenarios)
        for i, rec in plan.cached:
            out[i] = (rec, "cached")
        pending = plan.unique_pending
        if pending:
            records = execute_chunk(
                [scenarios[plan.pending_by_hash[h][0]] for h in pending],
                mode=self.mode, policy=self.policy,
                with_trace_hash=self.with_trace_hash, device=self.device)
            for h, rec in zip(pending, records):
                if rec["status"] == "ok":
                    self.cache.put(h, rec)
                for i in plan.pending_by_hash[h]:
                    out[i] = (rec, rec["status"])
        return out  # type: ignore[return-value]


class _Search:
    """One search run's state (see module docstring for the loop)."""

    def __init__(self, sspec: SearchSpec, cache: ResultCache,
                 executor: Callable, progress: Callable[[str], None],
                 on_proposal: Callable[[int, list[str]], None] | None = None):
        self.s = sspec
        self.cache = cache
        self.executor = executor
        self.say = progress
        self.on_proposal = on_proposal
        self.rng = np.random.default_rng(sspec.seed)
        self.sign = 1.0 if sspec.direction == "min" else -1.0

        # ---- candidate pool (streamed; scenarios not retained) ----------
        space = sspec.space
        n_raw = space.n_points
        if n_raw > sspec.max_pool:
            points = np.sort(self.rng.choice(
                n_raw, size=sspec.max_pool, replace=False))
        else:
            points = np.arange(n_raw)
        self.points: list[int] = []
        self.raws: list[tuple] = []
        self.hashes: list[str] = []
        for p in points:
            sc = space.scenario_at(int(p))
            if sc is None:
                continue
            self.points.append(int(p))
            self.raws.append(raw_features(sc))
            self.hashes.append(scenario_hash(sc))
        self.n = len(self.points)
        self.raw_points = n_raw
        if self.n == 0:
            raise ValueError("search space expands to zero valid scenarios")

        self.enc = FeatureEncoder().fit(self.raws)
        self.X = self.enc.matrix(self.raws)

        # ---- observation state -----------------------------------------
        self.probed = np.zeros(self.n, dtype=bool)
        self.y = np.full(self.n, np.nan)  # sign-adjusted objective
        self.value = np.full(self.n, np.nan)  # raw objective
        self.rows: dict[int, dict | None] = {}
        self.probes: list[dict] = []
        self.executed = 0
        self.cached = 0
        self.warm = 0
        self.errors = 0
        self.history: list[dict] = []

        gb = [FIELD_NAMES.index(f) for f in sspec.group_by]
        self.group_key = ([tuple(r[i] for i in gb) for r in self.raws]
                          if gb else None)
        self.rank_field = FIELD_NAMES.index(sspec.rank_over)

    # ---- observation bookkeeping ----------------------------------------

    def _scenario(self, pos: int) -> Scenario:
        sc = self.s.space.scenario_at(self.points[pos])
        assert sc is not None  # pool positions decoded as valid once already
        return sc

    def _observe(self, pos: int, scenario: Scenario, record: dict,
                 status: str, warm: bool = False) -> None:
        self.probed[pos] = True
        row = (scenario_row(scenario, record)
               if "report" in record or "error" in record else None)
        self.rows[pos] = row
        v = None
        if row is not None and row.get(self.s.objective) is not None:
            v = row[self.s.objective]
        elif self.s.objective in record:  # synthetic/test executors
            v = record[self.s.objective]
        if isinstance(v, (int, float)) and math.isfinite(v):
            self.value[pos] = float(v)
            self.y[pos] = self.sign * float(v)
        elif status != "cached":
            self.errors += 1
        if warm:
            self.warm += 1
        elif status == "cached":
            self.cached += 1
        self.probes.append(dict(
            hash=self.hashes[pos], point=self.points[pos],
            scenario_id=scenario.scenario_id, status=status,
            value=(None if math.isnan(self.value[pos])
                   else float(self.value[pos])),
            warm=warm, row=row))

    def warm_start(self) -> None:
        if not self.cache.enabled:
            return
        found = self.cache.lookup_many(self.hashes)
        for pos, h in enumerate(self.hashes):
            rec = found.get(h)
            if rec is not None and rec.get("status") == "ok":
                self._observe(pos, self._scenario(pos), rec, "cached",
                              warm=True)
        if self.warm:
            self.say(f"[search] warm start: {self.warm}/{self.n} candidates "
                     f"already cached")

    # ---- incumbents ------------------------------------------------------

    def _obs_mask(self) -> np.ndarray:
        return self.probed & np.isfinite(self.y)

    def _best_pos(self, mask: np.ndarray) -> int | None:
        idx = np.flatnonzero(mask)
        if not len(idx):
            return None
        return int(idx[np.argmin(self.y[idx])])

    def _group_incumbents(self) -> dict[tuple, float]:
        out: dict[tuple, float] = {}
        for pos in np.flatnonzero(self._obs_mask()):
            k = self.group_key[pos]
            v = self.y[pos]
            if k not in out or v < out[k]:
                out[k] = v
        return out

    # ---- proposals -------------------------------------------------------

    def _propose_random(self, unprobed: np.ndarray, k: int) -> np.ndarray:
        sel = propose(np.zeros(len(unprobed)), k, self.rng, epsilon=1.0)
        return unprobed[sel]

    def _propose_objective(self, unprobed: np.ndarray, k: int) -> np.ndarray:
        obs = self._obs_mask()
        n_obs = int(obs.sum())
        init = self.s.init or min(self.budget, max(4, self.s.batch))
        if n_obs < max(2, init):
            return self._propose_random(unprobed, k)  # bandit warm-up
        model = make_surrogate(self.s.surrogate)
        model.fit(self.X[obs], self.y[obs], self.rng)
        mean, std = model.predict(self.X[unprobed])
        if self.group_key is not None:
            incumbents = self._group_incumbents()
            global_best = float(np.min(self.y[obs]))
            ref = np.array([incumbents.get(self.group_key[p], global_best)
                            for p in unprobed])
            # EI against each candidate's *own group* incumbent: same
            # formula, vectorized with a per-candidate reference
            std_f = np.maximum(std, 1e-12)
            imp = ref - mean
            z = imp / std_f
            scores = imp * norm_cdf(z) + std_f * norm_pdf(z)
            return self._allocate_groups(unprobed, scores, k)
        best = float(np.min(self.y[obs]))
        if self.s.acquisition == "ei":
            scores = expected_improvement(mean, std, best)
        else:
            scores = ucb(mean, std)
        sel = propose(scores, k, self.rng, epsilon=self.s.epsilon)
        return unprobed[sel]

    def _allocate_groups(self, unprobed: np.ndarray, scores: np.ndarray,
                         k: int) -> np.ndarray:
        """Round-robin the batch across groups (each group's candidates
        ranked by score, groups ordered by their top score) so a
        best-per-group query keeps probing every group, not just the
        globally loudest one."""
        per_group: dict[tuple, list[int]] = {}
        for i, pos in enumerate(unprobed):
            per_group.setdefault(self.group_key[pos], []).append(i)
        ranked = []
        for key, idxs in per_group.items():
            order = sorted(idxs, key=lambda i: (-scores[i], i))
            ranked.append((max(scores[i] for i in idxs), order))
        ranked.sort(key=lambda t: -t[0])
        chosen: list[int] = []
        depth = 0
        while len(chosen) < k:
            advanced = False
            for _, order in ranked:
                if depth < len(order):
                    advanced = True
                    if self.s.epsilon and self.rng.random() < self.s.epsilon:
                        free = [i for i in range(len(unprobed))
                                if i not in chosen]
                        if not free:
                            break
                        chosen.append(int(free[self.rng.integers(
                            0, len(free))]))
                    elif order[depth] not in chosen:
                        chosen.append(order[depth])
                    if len(chosen) >= k:
                        break
            if not advanced:
                break
            depth += 1
        return unprobed[np.array(chosen[:k], dtype=int)]

    # ---- frontier mode ---------------------------------------------------

    def _contexts(self) -> dict[tuple, list[int]]:
        """Candidate positions grouped by everything-but-rank_over."""
        out: dict[tuple, list[int]] = {}
        rf = self.rank_field
        for pos, raw in enumerate(self.raws):
            ctx = raw[:rf] + raw[rf + 1:]
            out.setdefault(ctx, []).append(pos)
        return out

    def _context_view(self, members: list[int], mean: np.ndarray | None,
                      std: np.ndarray | None) -> tuple | None:
        """Per-option (value, uncertainty) for one context: observed values
        where probed, surrogate predictions elsewhere.  None if the
        context cannot be assessed yet (no model, nothing observed)."""
        vals, uncs = [], []
        for pos in members:
            if np.isfinite(self.y[pos]):
                vals.append(float(self.y[pos]))
                uncs.append(0.0)
            elif mean is not None:
                vals.append(float(mean[pos]))
                uncs.append(float(std[pos]))
            else:
                return None
        return np.array(vals), np.array(uncs)

    def _propose_frontier(self, unprobed: np.ndarray, k: int) -> np.ndarray:
        obs = self._obs_mask()
        n_obs = int(obs.sum())
        init = self.s.init or min(self.budget, max(4, self.s.batch))
        if n_obs < max(2, init):
            # warm-up on whole random contexts: a ranking needs at least
            # one full column of the rank_over axis to mean anything
            ctxs = list(self._contexts().values())
            order = self.rng.permutation(len(ctxs))
            chosen: list[int] = []
            for ci in order:
                for pos in ctxs[ci]:
                    if not self.probed[pos] and pos not in chosen:
                        chosen.append(pos)
                    if len(chosen) >= k:
                        return np.array(chosen, dtype=int)
            return np.array(chosen, dtype=int)
        model = make_surrogate(self.s.surrogate)
        model.fit(self.X[obs], self.y[obs], self.rng)
        mean, std = model.predict(self.X)
        scored = []
        for ctx, members in self._contexts().items():
            if not any(not self.probed[p] for p in members):
                continue  # fully resolved
            view = self._context_view(members, mean, std)
            if view is None:
                continue
            vals, uncs = view
            order = np.argsort(vals, kind="stable")
            if len(order) < 2:
                continue
            b1, b2 = order[0], order[1]
            s = math.sqrt(uncs[b1] ** 2 + uncs[b2] ** 2) or 1e-12
            p_flip = 1.0 - float(norm_cdf(
                np.array([(vals[b2] - vals[b1]) / s]))[0])
            # probe the contenders first, then the rest
            todo = [members[i] for i in order
                    if not self.probed[members[i]]]
            scored.append((p_flip, todo))
        scored.sort(key=lambda t: -t[0])
        chosen = []
        for _, todo in scored:
            for pos in todo:
                if pos not in chosen:
                    chosen.append(pos)
                if len(chosen) >= k:
                    break
            if len(chosen) >= k:
                break
        if len(chosen) < k:  # everything ambiguous exhausted: explore
            rest = [int(p) for p in unprobed if p not in chosen]
            extra = propose(np.zeros(len(rest)), k - len(chosen), self.rng,
                            epsilon=1.0)
            chosen.extend(rest[i] for i in extra)
        return np.array(chosen[:k], dtype=int)

    def _frontier_report(self) -> dict:
        obs = self._obs_mask()
        model = None
        mean = std = None
        if int(obs.sum()) >= 2:
            model = make_surrogate(self.s.surrogate)
            model.fit(self.X[obs], self.y[obs], self.rng)
            mean, std = model.predict(self.X)
        rf = self.rank_field
        contexts = self._contexts()
        winners: list[tuple[tuple, object, float, bool, float]] = []
        for ctx, members in contexts.items():
            view = self._context_view(members, mean, std)
            if view is None:
                continue
            vals, uncs = view
            order = np.argsort(vals, kind="stable")
            b1 = order[0]
            resolved = all(self.probed[p] and np.isfinite(self.y[p])
                           for p in members)
            margin = (float((vals[order[1]] - vals[b1])
                            / abs(vals[order[1]]))
                      if len(order) > 1 and vals[order[1]] else 0.0)
            if len(order) > 1:
                s = math.sqrt(uncs[b1] ** 2 + uncs[order[1]] ** 2) or 1e-12
                p_flip = 1.0 - float(norm_cdf(np.array(
                    [(vals[order[1]] - vals[b1]) / s]))[0])
            else:
                p_flip = 0.0
            winners.append((ctx, self.raws[members[b1]][rf], margin,
                            resolved, p_flip, members[b1],
                            members[order[1]] if len(order) > 1 else None))
        if not winners:
            return dict(rank_over=self.s.rank_over, contexts=0, resolved=0,
                        baseline_winner=None, flips=[])
        counts: dict = {}
        for _, w, *_ in winners:
            counts[w] = counts.get(w, 0) + 1
        baseline = max(counts, key=lambda w: (counts[w], str(w)))
        flips = []
        for ctx, w, margin, resolved, p_flip, bpos, rpos in winners:
            if w == baseline:
                continue
            flips.append(dict(
                context=self.enc.describe(self.raws[bpos],
                                          skip=(self.s.rank_over,)),
                winner=w,
                runner_up=(self.raws[rpos][rf] if rpos is not None else None),
                margin=round(margin, 4),
                resolved=resolved,
                flip_probability=round(p_flip, 4),
            ))
        return dict(
            rank_over=self.s.rank_over,
            contexts=len(winners),
            resolved=sum(1 for w in winners if w[3]),
            baseline_winner=baseline,
            flips=flips,
        )

    # ---- main loop -------------------------------------------------------

    def run(self) -> SearchResult:
        t0 = time.time()
        self.budget = self.s.budget or max(
            1, math.ceil(self.s.budget_frac * self.n))
        self.say(f"[search] pool={self.n} candidates "
                 f"(raw space {self.raw_points}), budget={self.budget} "
                 f"executions, mode={self.s.mode}")
        self.warm_start()
        rounds = 0
        stale = 0
        last_best = math.inf
        while self.executed < self.budget:
            unprobed = np.flatnonzero(~self.probed)
            if not len(unprobed):
                break
            k = min(self.s.batch, self.budget - self.executed,
                    len(unprobed))
            if self.s.mode == "frontier":
                proposal = self._propose_frontier(unprobed, k)
            else:
                proposal = self._propose_objective(unprobed, k)
            if not len(proposal):
                break
            scens = [self._scenario(int(p)) for p in proposal]
            if self.on_proposal is not None:
                self.on_proposal(rounds,
                                 [self.hashes[int(p)] for p in proposal])
            results = self.executor(scens)
            exec_hashes = set()
            for pos, sc, (record, status) in zip(proposal, scens, results):
                self._observe(int(pos), sc, record, status)
                if status != "cached":
                    exec_hashes.add(self.hashes[int(pos)])
            self.executed += len(exec_hashes)
            rounds += 1
            obs = self._obs_mask()
            best = float(np.min(self.y[obs])) if obs.any() else math.inf
            self.history.append(dict(
                round=rounds, proposed=len(proposal),
                executed=self.executed, cached=self.cached,
                best=(None if math.isinf(best) else self.sign * best)))
            self.say(f"[search] round {rounds}: {len(proposal)} proposed, "
                     f"{self.executed}/{self.budget} executed, "
                     f"best={self.history[-1]['best']}")
            if self.s.mode == "objective" and self.s.patience:
                if best < last_best - 1e-12:
                    stale = 0
                    last_best = best
                else:
                    stale += 1
                    if stale >= self.s.patience:
                        self.say(f"[search] converged: no improvement in "
                                 f"{stale} rounds")
                        break
        return self._result(rounds, time.time() - t0)

    def _best_dict(self, pos: int) -> dict:
        return dict(
            scenario_id=self._scenario(pos).scenario_id,
            hash=self.hashes[pos],
            point=self.points[pos],
            value=float(self.value[pos]),
            row=self.rows.get(pos),
        )

    def _result(self, rounds: int, wall: float) -> SearchResult:
        best = groups = frontier = None
        if self.s.mode == "objective":
            bpos = self._best_pos(self._obs_mask())
            best = self._best_dict(bpos) if bpos is not None else None
            if self.group_key is not None:
                groups = {}
                per: dict[tuple, int] = {}
                for pos in np.flatnonzero(self._obs_mask()):
                    k = self.group_key[pos]
                    if k not in per or self.y[pos] < self.y[per[k]]:
                        per[k] = pos
                groups = {"/".join(map(str, k)): self._best_dict(p)
                          for k, p in per.items()}
        else:
            frontier = self._frontier_report()
        return SearchResult(
            mode=self.s.mode, objective=self.s.objective,
            direction=self.s.direction, pool=self.n,
            raw_points=self.raw_points, budget=self.budget, rounds=rounds,
            executed=self.executed, cached=self.cached, warm=self.warm,
            errors=self.errors, best=best, groups=groups, frontier=frontier,
            history=self.history, probes=self.probes,
            wall_s=round(wall, 3))


def run_search(
    sspec: SearchSpec,
    cache_dir: str | None = None,
    cache: ResultCache | None = None,
    executor: Callable | None = None,
    progress: Callable[[str], None] | None = None,
    policy: ExecutionPolicy | None = None,
    exec_mode: str = "batch",
    on_proposal: Callable[[int, list[str]], None] | None = None,
    device=None,
) -> SearchResult:
    """Run one adaptive search on ``device`` (see module docstring).

    ``executor`` overrides how proposal batches run — the serve scheduler
    routes them through its worker pool, tests through synthetic response
    surfaces; the default is the in-process grid runner path on
    ``device``.  ``on_proposal`` observes each round's proposed hashes
    before they execute (the serve path streams them to the client)."""
    dev = resolve_device(device)  # before any proposal: no device, no search
    if cache is None:
        # the loop re-probes the pool every warm start and re-reads probe
        # records; the memo makes those reads free
        cache = ResultCache(cache_dir, memo_capacity=4096)
    if executor is None:
        executor = RunnerExecutor(cache, mode=exec_mode, policy=policy,
                                  device=dev)
    say = progress or (lambda msg: None)
    return _Search(sspec, cache, executor, say, on_proposal).run()
