"""The port's adaptive search (``repro_torch.sweep.search``) against the
reference's (``repro.sweep.search``): the encoder, surrogates and
acquisition on the same seeded numpy inputs, the search loop in objective,
group-by and frontier modes, probes executed through the port's runner,
the search CLI, the tiny golden trace hashes, and search jobs on the port's
sweep scheduler.  Everything runs on the CPU (``device="cpu"``).

Tolerance: exact equality everywhere.  Left out of each comparison are the
wall-clock fields (``wall_s``) and the content hashes, which differ by
design between the packages (the port's cache keys carry
``backend="repro_torch"``); scenario ids and pool points stand in for them.
"""
from __future__ import annotations

import json
import threading
import time
from concurrent.futures import Future
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

import repro.sweep as ref_sweep  # noqa: E402
import repro.sweep.search as ref_search  # noqa: E402
import repro.sweep.search.cli as ref_search_cli  # noqa: E402
import repro_torch.sweep as sweep  # noqa: E402
import repro_torch.sweep.__main__ as cli  # noqa: E402
import repro_torch.sweep.search as search  # noqa: E402
from repro.graph.generators import GraphSpec as RefGraphSpec  # noqa: E402
from repro_torch.graph.generators import GraphSpec  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    TERMINAL_EVENTS,
    ProtocolError,
    SweepScheduler,
    search_from_wire,
    search_to_wire,
)
from repro_torch.sweep.cache import canonical_json  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TINY_GOLDEN = ROOT / "benchmarks" / "golden_hashes_tiny.json"
TINY_ARGS = ("tiny", "uniform", 256, 1024, True, 1, 0)
ACCELS = ("accugraph", "hitgraph", "foregraph", "thundergp")


class Side:
    """One package's sweep and search API, so a test builds the same space
    in both: ``Side(ref=True)`` is the JAX reference, ``Side()`` the port."""

    def __init__(self, ref: bool = False):
        self.ref = ref
        self.sweep = ref_sweep if ref else sweep
        self.search = ref_search if ref else search
        self.tiny = (RefGraphSpec if ref else GraphSpec)(*TINY_ARGS)

    def space(self, **kw):
        """The reference tests' 4x2x3x2x2 design space (~50 valid points)."""
        axes = dict(name="srch", accelerators=ACCELS, graphs=(self.tiny,),
                    problems=("bfs", "pr"), drams=("default", ("hbm", 4), ("hbm", 8)),
                    mappings=("row", "bank_xor@32"), page_policies=("open", "closed"))
        axes.update(kw)
        return self.sweep.SweepSpec(**axes)

    def run_search(self, sspec_kw: dict, space_kw: dict | None = None, **kw):
        sspec = self.search.SearchSpec(space=self.space(**(space_kw or {})), **sspec_kw)
        if not self.ref:
            kw.setdefault("device", "cpu")
        proposals = []
        names = {self.sweep.scenario_hash(s): s.scenario_id
                 for s in sspec.space.scenarios()}
        res = self.search.run_search(
            sspec, on_proposal=lambda rnd, hs: proposals.append(
                (rnd, [names[h] for h in hs])), **kw)
        return res, proposals


REF, PORT = Side(ref=True), Side()


def surface(s) -> float:
    """The reference tests' synthetic response, with axis interactions."""
    v = {"accugraph": 1.0, "hitgraph": 0.8, "foregraph": 1.3,
         "thundergp": 1.1}[s.accelerator]
    v *= {"bfs": 1.0, "pr": 2.0}[s.problem]
    v *= {1: 1.0, 4: 0.6, 8: 0.45}[s.dram.channels]
    v *= 0.9 if s.dram.mapping.label.startswith("bank_xor") else 1.0
    v *= 0.95 if s.dram.page_policy == "open" else 1.0
    if s.accelerator == "hitgraph" and s.dram.page_policy == "closed":
        v *= 1.8
    return v


def synthetic_executor(calls=None, fail=()):
    def executor(scenarios):
        out = []
        for s in scenarios:
            if calls is not None:
                calls.append(s.scenario_id)
            if s.accelerator in fail:
                out.append((dict(status="error", error="boom"), "error"))
            else:
                out.append((dict(status="ok", runtime_s=surface(s)), "ok"))
        return out
    return executor


def strip(obj):
    """A result dict without its wall-clock and content-hash fields."""
    if isinstance(obj, dict):
        return {k: strip(v) for k, v in obj.items() if k not in ("wall_s", "hash")}
    if isinstance(obj, list):
        return [strip(v) for v in obj]
    return obj


# ---- encoder, surrogates, acquisition: bit-equal ----------------------------


@pytest.mark.parametrize("space_kw", [
    {},
    dict(accelerators=("accugraph", "hitgraph"), problems=("bfs",)),
    dict(engines=("numpy", "device"), problems=("bfs", "pr", "wcc"),
         pseudo_channels=(False, True), drams=("hbm", ("hbm", 8))),
    dict(reorders=("identity", "degree"), interval_scales=(1, 2, 4)),
])
def test_encoder_equals_reference(space_kw):
    raws = [search.raw_features(s) for s in PORT.space(**space_kw).scenarios()]
    ref_raws = [ref_search.raw_features(s) for s in REF.space(**space_kw).scenarios()]
    assert raws == ref_raws and search.FIELD_NAMES == ref_search.FIELD_NAMES
    enc = search.FeatureEncoder().fit(raws)
    ref_enc = ref_search.FeatureEncoder().fit(ref_raws)
    assert enc.feature_names == ref_enc.feature_names
    X, ref_X = enc.matrix(raws), ref_enc.matrix(ref_raws)
    assert X.dtype == ref_X.dtype and np.array_equal(X, ref_X)
    assert enc.describe(raws[-1], skip=("accelerator",)) == \
        ref_enc.describe(ref_raws[-1], skip=("accelerator",))
    # constant axes carry no columns; numeric ones are single [0, 1] columns
    assert not any(n.startswith("graph=") for n in enc.feature_names)
    assert len({tuple(r) for r in X}) == len(raws)


@pytest.mark.parametrize("name", ["forest", "gp"])
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_surrogate_equals_reference(name, seed):
    """The reference tests' linear target, and a one-hot design like the
    encoder's: predictions bit-equal under the same generator."""
    rng = np.random.default_rng(seed)
    w = np.array([3.0, -2.0, 0.5, 0.0, 1.0])
    X = rng.random((40, 5))
    y = X @ w + 0.01 * rng.random(40)
    Xq = rng.random((10, 5))
    onehot = (rng.random((30, 8)) < 0.5).astype(float)
    for X_, y_, Xq_ in ((X, y, Xq), (onehot, onehot @ rng.normal(size=8), onehot[::3])):
        mean, std = search.make_surrogate(name).fit(
            X_, y_, np.random.default_rng(seed + 1)).predict(Xq_)
        ref_mean, ref_std = ref_search.make_surrogate(name).fit(
            X_, y_, np.random.default_rng(seed + 1)).predict(Xq_)
        assert np.array_equal(mean, ref_mean) and np.array_equal(std, ref_std)
        assert np.all(np.isfinite(mean)) and np.all(std > 0)
    mean, _ = search.make_surrogate(name).fit(X, y, np.random.default_rng(7)).predict(Xq)
    truth = Xq @ w  # tracks the target better than the mean baseline
    assert np.abs(mean - truth).mean() < np.abs(truth.mean() - truth).mean()


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_acquisition_equals_reference(seed):
    rng = np.random.default_rng(seed)
    mean, std = rng.normal(size=64), rng.random(64) + 1e-3
    std[:3] = 0.0  # the floor at 1e-12
    z = np.linspace(-6, 6, 101)
    assert np.array_equal(search.norm_cdf(z), ref_search.norm_cdf(z))
    assert np.array_equal(search.norm_pdf(z), ref_search.norm_pdf(z))
    ei = search.expected_improvement(mean, std, 0.1)
    assert np.array_equal(ei, ref_search.expected_improvement(mean, std, 0.1))
    assert np.array_equal(search.ucb(mean, std), ref_search.ucb(mean, std))
    for eps in (0.0, 0.3, 1.0):
        assert search.propose(ei, 9, np.random.default_rng(seed), epsilon=eps) == \
            ref_search.propose(ei, 9, np.random.default_rng(seed), epsilon=eps)
    # ranks, no duplicates, ties on position
    scores = np.array([0.1, 0.9, 0.5, 0.7])
    assert search.propose(scores, 4, np.random.default_rng(0)) == [1, 3, 2, 0]
    assert search.propose(np.zeros(3), 5, np.random.default_rng(0)) == [0, 1, 2]


# ---- the loop: the reference's proposals, history and answer ----------------

LOOP_CASES = {
    "objective": (dict(budget=12, batch=4, seed=0), {}),
    "objective_seed": (dict(budget=10, batch=3, seed=11), {}),
    "ucb_gp": (dict(budget=14, batch=3, seed=2, acquisition="ucb", surrogate="gp"), {}),
    "max": (dict(budget=9, batch=3, seed=4, direction="max", epsilon=0.0), {}),
    "group_by": (dict(budget=30, batch=6, seed=0, group_by=("problem",)), {}),
    "group_by_two": (dict(budget=20, batch=5, seed=3, group_by=("accelerator", "problem"),
                          epsilon=0.3), {}),
    "patience": (dict(budget=40, batch=4, seed=0, patience=2), {}),
    "max_pool": (dict(budget=5, batch=5, seed=3, max_pool=16), {}),
    "budget_frac": (dict(budget_frac=0.5, batch=4, seed=1, init=6), {}),
    "frontier": (dict(mode="frontier", budget=30, batch=2, seed=0),
                 dict(accelerators=("accugraph", "hitgraph"), problems=("bfs",),
                      drams=("default",), mappings=("row",))),
    "frontier_wide": (dict(mode="frontier", budget=18, batch=4, seed=7), {}),
    "frontier_gp": (dict(mode="frontier", budget=12, batch=3, seed=1, surrogate="gp",
                         rank_over="page_policy"), {}),
}


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_run_search_equals_reference(case):
    sspec_kw, space_kw = LOOP_CASES[case]
    calls, ref_calls = [], []
    res, props = PORT.run_search(sspec_kw, space_kw, cache=sweep.ResultCache(None),
                                 executor=synthetic_executor(calls))
    ref_res, ref_props = REF.run_search(sspec_kw, space_kw,
                                        cache=ref_sweep.ResultCache(None),
                                        executor=synthetic_executor(ref_calls))
    assert props == ref_props and calls == ref_calls
    assert strip(res.to_dict()) == strip(ref_res.to_dict())
    assert res.executed <= res.budget and res.history
    assert res.summary() == ref_res.summary()


def test_run_search_with_error_records_equals_reference():
    kw = dict(budget=20, batch=5, seed=1)
    res, _ = PORT.run_search(kw, cache=sweep.ResultCache(None),
                             executor=synthetic_executor(fail=("foregraph",)))
    ref_res, _ = REF.run_search(kw, cache=ref_sweep.ResultCache(None),
                                executor=synthetic_executor(fail=("foregraph",)))
    assert strip(res.to_dict()) == strip(ref_res.to_dict())
    assert res.errors > 0
    assert all(p["value"] is None for p in res.probes if p["status"] == "error")
    assert res.best is not None and res.best["value"] > 0


def test_search_finds_optimum_with_quarter_budget():
    space = PORT.space()
    pool = len(space.scenarios())
    res, _ = PORT.run_search(dict(budget=pool // 4, batch=4, seed=0),
                             cache=sweep.ResultCache(None), executor=synthetic_executor())
    assert res.executed <= pool // 4
    assert res.best["value"] <= min(surface(s) for s in space.scenarios()) * 1.05
    assert [h["round"] for h in res.history] == list(range(1, len(res.history) + 1))
    assert res.history[-1]["best"] == res.best["value"]


def test_frontier_detects_the_ranking_flip():
    res, _ = PORT.run_search(*LOOP_CASES["frontier"], cache=sweep.ResultCache(None),
                             executor=synthetic_executor())
    fr = res.frontier
    assert fr["contexts"] == 2 and fr["resolved"] == 2 and len(fr["flips"]) == 1
    flip = fr["flips"][0]
    assert flip["resolved"] is True
    assert {flip["winner"], flip["runner_up"]} == {"accugraph", "hitgraph"}


def test_warm_start_converges_to_zero_executions(tmp_path):
    space = PORT.space()
    cache = sweep.ResultCache(str(tmp_path / "c"))
    for s in space.scenarios():
        cache.put(sweep.scenario_hash(s), dict(status="ok", runtime_s=surface(s)))
    calls = []
    res, _ = PORT.run_search(dict(budget=8, batch=4, seed=2), cache=cache,
                             executor=synthetic_executor(calls=calls))
    assert res.executed == 0 and not calls and res.warm == res.pool
    assert res.best["value"] == min(surface(s) for s in space.scenarios())


@pytest.mark.parametrize("bad,match", [
    (dict(direction="sideways"), "direction"),
    (dict(surrogate="oracle"), "surrogate"),
    (dict(group_by=("flux",)), "axis field"),
    (dict(budget_frac=0.0), "budget_frac"),
    (dict(mode="pareto"), "mode"),
    (dict(acquisition="pi"), "acquisition"),
    (dict(epsilon=1.5), "epsilon"),
    (dict(batch=0), "batch"),
])
def test_search_spec_validation_equals_reference(bad, match):
    with pytest.raises(ValueError, match=match) as port_err:
        search.SearchSpec(space=PORT.space(), **bad)
    with pytest.raises(ValueError) as ref_err:
        ref_search.SearchSpec(space=REF.space(), **bad)
    assert str(port_err.value) == str(ref_err.value)


# ---- real execution through the port's runner --------------------------------


def small_space(side: Side):
    return side.sweep.SweepSpec(name="bi", accelerators=("accugraph", "hitgraph"),
                                graphs=(side.tiny,), problems=("bfs", "pr"),
                                drams=("default", ("hbm", 4)))


@pytest.mark.parametrize("mode", ["objective", "frontier"])
def test_runner_probes_equal_reference_and_grid_rows(tmp_path, mode):
    """Probes execute through the port's runner on the CPU: the same
    proposals, history, best and rows as the reference's search, rows
    byte-identical to the port's grid rows; a re-search is all warm."""
    kw = dict(budget=6, batch=2, seed=5, mode=mode)
    res = search.run_search(search.SearchSpec(space=small_space(PORT), **kw),
                            cache_dir=str(tmp_path / "c"), device="cpu")
    ref_res = ref_search.run_search(ref_search.SearchSpec(space=small_space(REF), **kw),
                                    cache_dir=str(tmp_path / "rc"))
    assert strip(res.to_dict()) == strip(ref_res.to_dict())
    assert res.executed == 6 and not res.errors
    grid = sweep.run_sweep(small_space(PORT), cache_dir=str(tmp_path / "g"), device="cpu")
    by_hash = {sr.hash: row for sr, row in zip(grid.results, sweep.result_rows(grid))}
    for p in res.probes:
        assert canonical_json(p["row"]) == canonical_json(by_hash[p["hash"]])
    again = search.run_search(search.SearchSpec(space=small_space(PORT), **kw),
                              cache_dir=str(tmp_path / "c"), device="cpu")
    assert again.executed == 0 and again.warm == 6


def test_tiny_golden_trace_hashes_hold_through_search(tmp_path):
    """``bench_search --tiny`` through the port: an exhaustive search over
    the 8-scenario tiny grid with trace hashes on matches the golden
    hashes, its rows equal the grid's, and a warm re-search executes 0."""
    space = sweep.SweepSpec(name="search-tiny",
                            accelerators=("accugraph", "foregraph", "hitgraph", "thundergp"),
                            graphs=(PORT.tiny,), problems=("bfs",), drams=("default", "hbm"))
    golden = json.loads(TINY_GOLDEN.read_text())
    cache = sweep.ResultCache(str(tmp_path / "c"), memo_capacity=256)
    res = search.run_search(
        search.SearchSpec(space=space, budget=8, batch=2, seed=0), cache=cache,
        executor=search.RunnerExecutor(cache, with_trace_hash=True, device="cpu"),
        device="cpu")
    assert res.executed == 8 and not res.errors
    names = {sweep.scenario_hash(s): s.scenario_id for s in space.scenarios()}
    got = {names[p["hash"]]: cache.get(p["hash"])["trace_hash"] for p in res.probes}
    assert got == {sid: golden[sid] for sid in got} and len(got) == 8
    grid = sweep.run_sweep(space, cache_dir=str(tmp_path / "g"), device="cpu")
    by_hash = {sr.hash: row for sr, row in zip(grid.results, sweep.result_rows(grid))}
    assert all(p["row"] == by_hash[p["hash"]] for p in res.probes)
    res2 = search.run_search(search.SearchSpec(space=space, budget=8, batch=2, seed=3),
                             cache=cache, device="cpu")
    assert res2.executed == 0 and res2.warm == 8
    assert res2.best["value"] == res.best["value"]


# ---- the CLI ----------------------------------------------------------------

CLI_AXES = ["--accels", "accugraph,hitgraph", "--graphs", "sd", "--problems", "bfs",
            "--drams", "default,hbm", "--budget", "3", "--batch", "2", "--seed", "0"]


@pytest.mark.parametrize("extra", [[], ["--frontier"], ["--group-by", "dram"]])
def test_cli_writes_the_reference_s_report_and_probes(tmp_path, capsys, extra):
    argv = CLI_AXES + extra
    assert ref_search_cli.main(argv + ["--cache", str(tmp_path / "rc"),
                                       "--out", str(tmp_path / "ro")]) == 0
    ref_out = capsys.readouterr().out
    assert cli.main(["search", *argv, "--device", "cpu", "--cache", str(tmp_path / "c"),
                     "--out", str(tmp_path / "o")]) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[-1] == ref_out.splitlines()[-1]  # the summary
    report = json.loads((tmp_path / "o" / "sweep_search.json").read_text())
    ref_report = json.loads((tmp_path / "ro" / "sweep_search.json").read_text())
    assert strip(report) == strip(ref_report)
    assert (tmp_path / "o" / "sweep_probes.csv").read_bytes() == \
        (tmp_path / "ro" / "sweep_probes.csv").read_bytes()
    # a second search over the same cache starts warm from the 3 probes
    assert cli.main(["search", *argv, "--device", "cpu", "--cache", str(tmp_path / "c"),
                     "--out", str(tmp_path / "o2")]) == 0
    assert "1 executed (+0 cached, +3 warm) of 4" in capsys.readouterr().out


def test_cli_clean_errors(capsys, monkeypatch):
    assert cli.main(["search", "--accels", "bogus", "--device", "cpu"]) == 2
    assert "unknown accelerator" in capsys.readouterr().err
    assert cli.main(["search", "--group-by", "flux", "--device", "cpu"]) == 2
    assert "axis field" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["search", "--graphs", "sd", "--cache", ""]) == 2
    assert "error: no CUDA device" in capsys.readouterr().err


# ---- the device policy ------------------------------------------------------


def test_default_device_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    sspec = search.SearchSpec(space=small_space(PORT), budget=2)
    for call in (lambda: search.run_search(sspec, cache_dir=str(tmp_path)),
                 lambda: search.run_search(sspec, executor=synthetic_executor(calls)),
                 lambda: search.run_search(sspec, device="cuda"),
                 lambda: search.RunnerExecutor(sweep.ResultCache(None)),
                 lambda: SweepScheduler(cache_dir=str(tmp_path), pool_factory=GatedPool),
                 lambda: SweepScheduler(cache_dir=None, device="cuda:0",
                                        pool_factory=GatedPool)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not calls and not list(tmp_path.rglob("*.json"))  # nothing proposed or run


# ---- wire format ------------------------------------------------------------


def test_search_wire_roundtrip_equals_reference():
    kw = dict(objective="mteps", direction="max", mode="frontier", budget=12, batch=3,
              group_by=("graph",), seed=42, surrogate="gp", epsilon=0.25)
    space_kw = dict(engines=("numpy", "device"), pseudo_channels=(False, True))
    sspec = search.SearchSpec(space=PORT.space(**space_kw), **kw)
    wire = search_to_wire(sspec)
    back = search_from_wire(json.loads(json.dumps(wire)))
    assert back == sspec
    assert back.space.expand() == sspec.space.expand()
    from repro.serve.protocol import search_to_wire as ref_search_to_wire

    ref_wire = ref_search_to_wire(ref_search.SearchSpec(space=REF.space(**space_kw), **kw))
    # the graphs differ only by package: inline GraphSpec dicts are equal
    assert json.dumps(wire, sort_keys=True) == json.dumps(ref_wire, sort_keys=True)


def test_search_wire_rejects_unknown_fields():
    wire = search_to_wire(search.SearchSpec(space=PORT.space()))
    wire["temperature"] = 0.7
    with pytest.raises(ProtocolError, match="temperature"):
        search_from_wire(wire)
    with pytest.raises(ProtocolError, match="space"):
        search_from_wire({"budget": 3})


# ---- serve-side search jobs -------------------------------------------------


class GatedPool:
    """In-process WorkerPool stand-in (threads, real execution); optional
    per-chunk gates make dispatch timing deterministic."""

    def __init__(self, size=2, gates=None):
        self.size = size
        self.gates = gates
        self.chunks = []
        self._threads = []

    def submit(self, fn, *args):
        fut = Future()
        n = len(self.chunks)
        self.chunks.append(list(args[0]))
        gate = self.gates[n] if self.gates and n < len(self.gates) else None

        def run():
            if gate is not None:
                gate.wait(timeout=60)
            try:
                fut.set_result(fn(*args))
            except BaseException as e:
                fut.set_exception(e)

        t = threading.Thread(target=run, daemon=True)
        self._threads.append(t)
        t.start()
        return fut

    def shutdown(self, wait=True, cancel_pending=False):
        if self.gates:
            for g in self.gates:
                g.set()
        if wait:
            for t in self._threads:
                t.join(timeout=60)

    def stats(self):
        return dict(size=self.size, busy=0, chunks_submitted=len(self.chunks),
                    utilization=0.0)


def collect_events(job, timeout=120.0):
    events = []
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            ev = job.events.get(timeout=1.0)
        except Exception:
            continue
        events.append(ev)
        if ev["type"] in TERMINAL_EVENTS:
            return events
    pytest.fail(f"job {job.id} produced no terminal event in {timeout}s")


def wait_for(cond, timeout=30.0, what="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.02)
    pytest.fail(f"timed out waiting for {what}")


def serve_space():
    return sweep.SweepSpec(name="ss", accelerators=("accugraph", "hitgraph"),
                           graphs=(PORT.tiny,), problems=("bfs",), drams=("default",))


def scheduler(tmp_path, pool_factory=GatedPool):
    return SweepScheduler(cache_dir=str(tmp_path / "c"), pool_factory=pool_factory,
                          device="cpu")


def test_serve_search_lifecycle_and_row_identity(tmp_path):
    sched = scheduler(tmp_path)
    try:
        spec = serve_space()
        pool = len(spec.scenarios())
        sspec = search.SearchSpec(space=spec, budget=pool, batch=1, seed=0)
        job = sched.submit_search(sspec)
        events = collect_events(job)
        types = [e["type"] for e in events]
        assert types[0] == "job" and events[0]["kind"] == "search"
        assert types[-2:] == ["search_result", "done"] and "proposal" in types
        rows = [e for e in events if e["type"] == "row"]
        assert len(rows) == pool and all(e["status"] == "ok" for e in rows)
        result = events[-2]["result"]
        assert result["executed"] == pool and result["best"] is not None
        # the served search answers as the in-process search does
        local = search.run_search(sspec, cache_dir=str(tmp_path / "local"), device="cpu")
        assert strip(result) == strip(local.to_dict())
        # a grid submission of the same space is now fully cached, and its
        # rows are byte-identical to the search's probe rows
        grid_job = sched.submit(spec)
        grid_events = collect_events(grid_job)
        grid_rows = {grid_job.hashes[e["index"]]: e["row"]
                     for e in grid_events if e["type"] == "row"}
        assert all(e["status"] == "cached" for e in grid_events if e["type"] == "row")
        for e in rows:
            assert canonical_json(e["row"]) == \
                canonical_json(grid_rows[job.hashes[e["index"]]])
    finally:
        sched.close()


def test_serve_search_cancel_unblocks_loop(tmp_path):
    gate = threading.Event()  # the first chunk parks until released
    sched = scheduler(tmp_path, lambda: GatedPool(gates=[gate]))
    try:
        job = sched.submit_search(search.SearchSpec(space=serve_space(), budget=2,
                                                    batch=2, seed=0))
        wait_for(lambda: sched.pool.chunks, what="first dispatch")
        assert sched.cancel(job.id)
        assert collect_events(job, timeout=30.0)[-1]["type"] == "cancelled"
        gate.set()
        wait_for(lambda: not any(t.name == f"search-{job.id}" and t.is_alive()
                                 for t in threading.enumerate()),
                 what="search thread exit")
    finally:
        sched.close()


def test_serve_search_journal_resume(tmp_path):
    gate = threading.Event()
    sched1 = scheduler(tmp_path, lambda: GatedPool(gates=[gate]))
    spec = serve_space()
    pool = len(spec.scenarios())
    job = sched1.submit_search(search.SearchSpec(space=spec, budget=pool, batch=1, seed=0))
    wait_for(lambda: sched1.pool.chunks, what="first dispatch")
    sched1.drain(timeout=30.0)
    assert collect_events(job, timeout=30.0)[-1]["type"] == "interrupted"
    open_ops = sched1.journal.load_open()
    assert open_ops and open_ops[0]["kind"] == "search"

    sched2 = scheduler(tmp_path)
    try:
        resumed = sched2.get_job(job.id)
        assert resumed is not None and resumed.kind == "search"
        events2 = collect_events(resumed)
        assert events2[-1]["type"] == "done"
        r = next(e for e in events2 if e["type"] == "search_result")["result"]
        assert r["executed"] + r["warm"] + r["cached"] >= pool
        assert r["warm"] + r["cached"] >= 1  # the pre-drain probe was reused
        assert sched2.journal.load_open() == []
    finally:
        sched2.close()


def test_serve_search_rejected_while_draining(tmp_path):
    sched = scheduler(tmp_path)
    sched.drain(timeout=5.0)
    with pytest.raises(RuntimeError, match="draining"):
        sched.submit_search(search.SearchSpec(space=serve_space(), budget=1))
