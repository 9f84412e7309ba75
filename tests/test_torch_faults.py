"""The port's fault-injection harness (``repro_torch.distributed.faults``)
against the reference's (``repro.distributed.faults``): the same seeds and
rules give the same schedule, plans round-trip through JSON and pickling,
and a fault plan drives the port's policied execution (retries, backoff,
audit trail, timeouts) exactly as it drives the reference's."""
from __future__ import annotations

import pickle
import signal
import threading
import time

import pytest

pytest.importorskip("jax")

import repro.distributed.faults as ref_faults  # noqa: E402
import repro.sweep as ref_sweep  # noqa: E402
import repro_torch.distributed as distributed  # noqa: E402
import repro_torch.distributed.faults as faults  # noqa: E402
import repro_torch.sweep as sweep  # noqa: E402
from repro.graph.generators import GraphSpec as RefGraphSpec  # noqa: E402
from repro_torch.graph.generators import GraphSpec  # noqa: E402
from repro_torch.sweep import runner  # noqa: E402

TINY = ("tiny", "uniform", 256, 1024, True, 1, 0)
BROKEN = ("broken", "no-such-generator", 64, 128, True, 1, 0)

# rules as plain dicts, so each package builds its own FaultRule from them
PLANS = {
    "at": (0, [dict(site="worker.chunk", kind="crash", at=(1, 3)),
               dict(site="scenario", kind="error", at=(0, 2))]),
    "match_times": (0, [dict(site="scenario", kind="error", match="hitgraph", times=1),
                        dict(site="worker.chunk", kind="hang", match="poison")]),
    "prob": (3, [dict(site="worker.chunk", kind="crash", prob=0.5)]),
    "prob_other_seed": (4, [dict(site="worker.chunk", kind="crash", prob=0.5)]),
    "layered": (11, [dict(site="scenario", kind="delay", at=(5,), delay_s=0.2),
                     dict(site="scenario", kind="error", prob=0.3, times=4),
                     dict(site="remote", kind="drop", prob=0.25),
                     dict(site="remote", kind="disconnect", match="lj", times=2),
                     dict(site="worker.chunk", kind="corrupt", exitcode=7),
                     dict(site="worker.chunk", kind="stall", at=(9,))]),
}
# occurrences consulted in order: (site, index, keys)
QUERIES = [(site, i, keys) for i in range(24)
           for site in ("worker.chunk", "scenario", "remote", "nowhere")
           for keys in ((), ("tiny/hitgraph/bfs",), ("lj/accugraph/pr", "poison/x"))]


def plans(name: str):
    seed, rules = PLANS[name]
    return (faults.FaultPlan(seed, tuple(faults.FaultRule(**r) for r in rules)),
            ref_faults.FaultPlan(seed, tuple(ref_faults.FaultRule(**r) for r in rules)))


def _action(a) -> tuple | None:
    return None if a is None else (a.site, a.kind, a.delay_s, a.exitcode, a.note)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_action_sequence_equals_reference(name):
    port, ref = plans(name)
    got = [_action(port.action(s, index=i, keys=k)) for s, i, k in QUERIES]
    want = [_action(ref.action(s, index=i, keys=k)) for s, i, k in QUERIES]
    assert got == want
    assert any(a is not None for a in got)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_json_equals_reference_and_round_trips(name):
    port, ref = plans(name)
    text = faults.plan_to_json(port)
    assert text == ref_faults.plan_to_json(ref)
    assert faults.plan_from_json(text) == port
    assert faults.plan_from_json(ref_faults.plan_to_json(ref)) == port
    # a plan pickles with its schedule and without its firing counters
    port.action("scenario", index=0, keys=("tiny/hitgraph/bfs",))
    clone = pickle.loads(pickle.dumps(port))
    assert clone == port and clone._fired == {}


def test_plan_prob_is_seeded_and_moves_with_the_seed():
    fired = {name: [plans(name)[0].action("worker.chunk", index=i) is not None
                    for i in range(64)] for name in ("prob", "prob_other_seed")}
    assert 0 < sum(fired["prob"]) < 64
    assert fired["prob"] != fired["prob_other_seed"]


@pytest.mark.parametrize("bad", [
    lambda: faults.FaultRule("worker.chunk", "explode"),
    lambda: faults.FaultRule("worker.chunk", "crash", prob=1.5),
    lambda: faults.plan_from_json('{"rules": [{"site": "x", "kind": "nope"}]}'),
    lambda: faults.plan_from_json("[1, 2]"),
    lambda: faults.plan_from_json('{"rules": [{"site": "x"}]}'),
])
def test_plan_rejects_garbage(bad):
    with pytest.raises(ValueError):
        bad()


def test_corrupt_records_and_delay_match_reference():
    recs = [dict(status="ok", report={"a": 1}, wall_s=0.5),
            dict(status="error", error="boom", wall_s=0.1)]
    assert faults.corrupt_records(recs) == ref_faults.corrupt_records(recs)
    t0 = time.monotonic()
    out = faults.probe(faults.FaultAction("scenario", "delay", delay_s=0.05), value=3)
    assert time.monotonic() - t0 >= 0.05 and out["value"] == 3
    faults.apply_pre(None)


def test_package_exports_only_what_resolves():
    from repro_torch.distributed import remote, sharding, workpool

    assert sorted(distributed.__all__) == sorted([
        "FaultPlan", "FaultRule", "RemoteWorkerPool", "WorkerHostAgent", "WorkerLost",
        "WorkerPool", "parse_address", "run_worker_host",
        "batch_axes", "batch_specs", "cache_specs", "param_specs", "shardings"])
    assert distributed.FaultPlan is faults.FaultPlan
    assert distributed.FaultRule is faults.FaultRule
    assert distributed.WorkerPool is workpool.WorkerPool
    assert distributed.WorkerLost is workpool.WorkerLost
    for name in ("RemoteWorkerPool", "WorkerHostAgent", "parse_address", "run_worker_host"):
        assert getattr(distributed, name) is getattr(remote, name)
    # the sharding rules, ported with the mesh half of training and serving
    for name in ("batch_axes", "batch_specs", "cache_specs", "param_specs", "shardings"):
        assert getattr(distributed, name) is getattr(sharding, name)
    with pytest.raises(AttributeError):
        distributed.no_such_export


# ---- policied execution through a fault plan ---------------------------------


def scenario(spec_args=TINY, accel="accugraph"):
    """The same one-scenario spec in both packages."""
    port = sweep.SweepSpec(name="t", accelerators=(accel,),
                           graphs=(GraphSpec(*spec_args),)).scenarios()
    ref = ref_sweep.SweepSpec(name="t", accelerators=(accel,),
                              graphs=(RefGraphSpec(*spec_args),)).scenarios()
    return port[0], ref[0]


def _audit(rec: dict) -> tuple:
    return (rec["status"], rec["attempts"], rec.get("last_error"),
            rec.get("injected"), rec.get("timed_out"))


@pytest.mark.parametrize("rules,retries", [
    ([dict(site="scenario", kind="error", at=(0,))], 1),          # retry runs clean
    ([dict(site="scenario", kind="error")], 1),                   # retries exhausted
    ([dict(site="scenario", kind="error", at=(0, 1))], 3),
    ([dict(site="scenario", kind="error", match="hitgraph")], 2),  # no match: clean
    ([dict(site="scenario", kind="delay", at=(0,), delay_s=0.01)], 0),
    ([dict(site="scenario", kind="error", prob=0.5)], 4),
])
def test_policied_retry_through_injected_fault_equals_reference(rules, retries):
    port_scn, ref_scn = scenario()
    port_plan = faults.FaultPlan(5, tuple(faults.FaultRule(**r) for r in rules))
    ref_plan = ref_faults.FaultPlan(5, tuple(ref_faults.FaultRule(**r) for r in rules))
    got = sweep.execute_scenario_policied(
        port_scn, sweep.ExecutionPolicy(retries=retries, backoff_s=0.0,
                                        fault_plan=port_plan), device="cpu")
    want = ref_sweep.execute_scenario_policied(
        ref_scn, ref_sweep.ExecutionPolicy(retries=retries, backoff_s=0.0,
                                           fault_plan=ref_plan))
    assert _audit(got) == _audit(want)
    if got["status"] == "ok":
        assert got["report"] == want["report"]
    row = sweep.scenario_row(port_scn, got)
    assert row == ref_sweep.scenario_row(ref_scn, want)


def test_error_rows_carry_attempts_and_last_error():
    port_scn, ref_scn = scenario(BROKEN)
    got = sweep.execute_scenario_policied(
        port_scn, sweep.ExecutionPolicy(retries=2, backoff_s=0.0), device="cpu")
    want = ref_sweep.execute_scenario_policied(
        ref_scn, ref_sweep.ExecutionPolicy(retries=2, backoff_s=0.0))
    assert _audit(got) == _audit(want) and got["attempts"] == 3
    assert sweep.scenario_row(port_scn, got) == ref_sweep.scenario_row(ref_scn, want)


@pytest.mark.parametrize("retries", [1, 2])
def test_batch_chunk_retries_only_its_failed_scenarios(retries):
    (port_ok, ref_ok), (port_bad, ref_bad) = scenario(), scenario(BROKEN)
    got = sweep.execute_chunk([port_ok, port_bad], "batch",
                              sweep.ExecutionPolicy(retries=retries, backoff_s=0.0),
                              device="cpu")
    want = ref_sweep.execute_chunk([ref_ok, ref_bad], "batch",
                                   ref_sweep.ExecutionPolicy(retries=retries, backoff_s=0.0))
    assert [r["status"] for r in got] == ["ok", "error"]
    assert got[1]["attempts"] == retries + 1 and "no-such-generator" in got[1]["error"]
    assert [sweep.scenario_row(s, r) for s, r in zip((port_ok, port_bad), got)] == \
        [ref_sweep.scenario_row(s, r) for s, r in zip((ref_ok, ref_bad), want)]


def test_backoff_schedule_equals_reference():
    port = sweep.ExecutionPolicy(retries=3, backoff_s=0.2)
    ref = ref_sweep.ExecutionPolicy(retries=3, backoff_s=0.2)
    for attempt in (1, 2, 3):
        for key in ("tiny/accugraph/bfs", "a", "b"):
            assert port.backoff_for(attempt, key) == ref.backoff_for(attempt, key)
    for bad in (dict(timeout_s=0), dict(retries=-1), dict(backoff_s=-1)):
        with pytest.raises(ValueError):
            sweep.ExecutionPolicy(**bad)


def test_timeout_bounds_a_scenario_and_restores_the_outer_timer(monkeypatch):
    """A scenario past its bound becomes a timed-out error record, retried
    under the policy; the timer and handler of the caller survive."""
    scn, _ = scenario()

    def slow(s, with_trace_hash=False, device=None):
        time.sleep(5.0)

    def outer_handler(signum, frame):  # pragma: no cover - must not fire
        pytest.fail("outer alarm fired during the bounded scenario")

    monkeypatch.setattr(runner, "execute_scenario", slow)
    prev = signal.signal(signal.SIGALRM, outer_handler)
    try:
        signal.setitimer(signal.ITIMER_REAL, 120.0)
        rec = sweep.execute_scenario_policied(
            scn, sweep.ExecutionPolicy(timeout_s=0.05, retries=1, backoff_s=0.0),
            device="cpu")
        assert rec["status"] == "error" and rec["timed_out"] and rec["attempts"] == 2
        assert "timed out after 0.05s" in rec["last_error"]
        remaining, _ = signal.getitimer(signal.ITIMER_REAL)
        assert 0 < remaining < 120.0
        assert signal.getsignal(signal.SIGALRM) is outer_handler
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0.0)
        signal.signal(signal.SIGALRM, prev)


def test_timeout_off_main_thread_is_flagged_not_faked():
    scn, _ = scenario()
    out = {}
    t = threading.Thread(target=lambda: out.update(rec=sweep.execute_scenario_policied(
        scn, sweep.ExecutionPolicy(timeout_s=60.0), device="cpu")))
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    assert out["rec"]["status"] == "ok" and out["rec"]["timeout_enforced"] is False
    assert sweep.scenario_row(scn, out["rec"])["timeout_enforced"] is False


def test_fault_plan_rides_a_policy_into_spawn_workers(tmp_path):
    """A pickled plan reaches each spawn worker with its schedule: the
    injected first attempt of every scenario fails, the retry runs clean."""
    plan = faults.FaultPlan(0, (faults.FaultRule("scenario", "error", at=(0,)),))
    spec = sweep.SweepSpec(name="t", accelerators=("accugraph", "hitgraph"),
                           graphs=(GraphSpec(*TINY),))
    result = sweep.run_sweep(spec, workers=2, device="cpu",
                             policy=sweep.ExecutionPolicy(retries=1, backoff_s=0.0,
                                                          fault_plan=plan))
    assert [r.record["attempts"] for r in result.results] == [2, 2]
    assert result.n_errors == 0
