"""The port's supervised worker pool (``repro_torch.distributed.workpool``),
the sweep scheduler's fault tolerance (re-dispatch, poison breaker,
corrupt-record validation, cancel during dispatch, dispatch-indexed fault
injection) and the crash-safe job journal (``repro_torch.serve.journal``):
the reference's tests of ``tests/test_faults.py`` on the port, plus what
the port adds — the worker's initializer opens the device and loads the
kernels or dies, and every chunk reports its kernel launches.

Pool payloads live in the port (``repro_torch.distributed.faults.probe``,
``repro_torch.serve.worker.run_chunk``), so no spawn child imports JAX.
Everything runs on the CPU (``device="cpu"``).  Tolerance: exact equality.
"""
from __future__ import annotations

import inspect
import json
import os
import stat
import time
from concurrent.futures import Future
from pathlib import Path

import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

import repro.sweep as ref_sweep  # noqa: E402
from repro.graph.generators import GraphSpec as RefGraphSpec  # noqa: E402
from repro_torch.distributed import workpool as wp_mod  # noqa: E402
from repro_torch.distributed.faults import (  # noqa: E402
    FaultAction,
    FaultPlan,
    FaultRule,
    corrupt_records,
    probe,
)
from repro_torch.distributed.workpool import WorkerLost, WorkerPool  # noqa: E402
from repro_torch.graph.generators import GraphSpec  # noqa: E402
from repro_torch.kernels import _platform  # noqa: E402
from repro_torch.serve import TERMINAL_EVENTS  # noqa: E402
from repro_torch.serve import worker as worker_mod  # noqa: E402
from repro_torch.serve.journal import JobJournal  # noqa: E402
from repro_torch.serve.scheduler import SweepScheduler  # noqa: E402
from repro_torch.sweep import SweepSpec  # noqa: E402
from repro_torch.sweep.cache import ResultCache, scenario_hash  # noqa: E402

TINY_ARGS = ("tiny", "uniform", 256, 1024, True, 1, 0)
TINY = GraphSpec(*TINY_ARGS)


def tiny_spec(accels=("accugraph",), problems=("bfs",), graphs=(TINY,),
              drams=("default",), **kw):
    return SweepSpec(name="t", accelerators=tuple(accels), graphs=tuple(graphs),
                     problems=tuple(problems), drams=tuple(drams), **kw)


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


# ---- supervised worker pool -------------------------------------------------


def make_pool(**kw):
    kw.setdefault("heartbeat_s", 0.1)
    kw.setdefault("task_deadline_s", 2.0)
    kw.setdefault("stall_deadline_s", 1.0)
    kw.setdefault("max_respawns", 3)
    kw.setdefault("respawn_backoff_s", 0.05)
    return WorkerPool(kw.pop("workers", 1), **kw)


def test_pool_crash_is_workerlost_and_respawns():
    pool = make_pool()
    try:
        first = pool.submit(probe, None, 1).result(timeout=60)
        assert first["value"] == 1
        fut = pool.submit(probe, FaultAction("worker.chunk", "crash"), 2)
        with pytest.raises(WorkerLost) as ei:
            fut.result(timeout=60)
        assert ei.value.reason == "crash" and "13" in ei.value.detail
        r = pool.submit(probe, None, 3).result(timeout=60)
        assert r["value"] == 3 and r["pid"] != first["pid"]  # a new process
        s = pool.stats()
        assert s["workers_lost"] == 1 and s["respawns"] == 1
    finally:
        pool.shutdown(wait=False, cancel_pending=True)


@pytest.mark.parametrize("kind,kw,reason", [
    ("hang", dict(task_deadline_s=1.0), "hang"),
    # SIGSTOP freezes the heartbeat thread too; with no task deadline only
    # heartbeat staleness can catch it
    ("stall", dict(task_deadline_s=None, stall_deadline_s=1.0), "stall"),
])
def test_pool_detects_a_wedged_worker(kind, kw, reason):
    pool = make_pool(**kw)
    try:
        t0 = time.time()
        fut = pool.submit(probe, FaultAction("worker.chunk", kind), 0)
        with pytest.raises(WorkerLost) as ei:
            fut.result(timeout=60)
        assert ei.value.reason == reason
        assert time.time() - t0 < 30  # at its deadline, not at HANG_S
    finally:
        pool.shutdown(wait=False, cancel_pending=True)


def test_pool_retires_slot_and_breaks_after_respawn_budget():
    pool = make_pool(max_respawns=1)
    try:
        for i in range(2):  # the first worker and its one respawn
            with pytest.raises(WorkerLost):
                pool.submit(probe, FaultAction("worker.chunk", "crash"),
                            i).result(timeout=60)
        wait_for(lambda: pool.stats()["retired"] == 1, what="slot retirement")
        with pytest.raises(WorkerLost) as ei:
            pool.submit(probe, None, 9)
        assert ei.value.reason == "broken"
    finally:
        pool.shutdown(wait=False, cancel_pending=True)


def test_pool_shutdown_bounded_with_hung_worker():
    pool = make_pool(task_deadline_s=1.0)
    pool.submit(probe, None, 0).result(timeout=60)  # the worker is ready
    fut = pool.submit(probe, FaultAction("worker.chunk", "hang"), 0)
    time.sleep(0.5)  # the monitor hands the hang to the worker
    t0 = time.time()
    pool.shutdown(wait=True, cancel_pending=True)
    assert time.time() - t0 < 30
    with pytest.raises(WorkerLost):
        fut.result(timeout=1)


def test_supervision_survives_wall_clock_step(monkeypatch):
    """Every supervision deadline is on ``time.monotonic()``: a step of the
    wall clock makes no healthy worker look stale or hung."""
    assert "time.time(" not in inspect.getsource(wp_mod)
    pool = make_pool(stall_deadline_s=0.5)
    try:
        assert pool.submit(probe, None, 1).result(timeout=60)["value"] == 1
        real = time.time
        monkeypatch.setattr(time, "time", lambda: real() + 3600.0)
        time.sleep(1.0)
        assert pool.submit(probe, None, 2).result(timeout=60)["value"] == 2
        s = pool.stats()
        assert s["workers_lost"] == 0 and s["respawns"] == 0
    finally:
        pool.shutdown(wait=False, cancel_pending=True)


def test_pool_is_the_reference_s_supervision():
    """The port's pool is the reference's line for line, docstring aside."""
    from repro.distributed import workpool as ref_wp

    def body(mod):
        src = inspect.getsource(mod)
        return src[src.index('"""', 3) + 3:].replace("repro_torch.", "repro.")

    port = body(wp_mod).replace("# stall checks start at ready",
                                "# init counts against the stall deadline")
    assert port == body(ref_wp)


# ---- the worker: device, kernels, launches -----------------------------------


def test_worker_without_its_device_dies_in_init_and_the_pool_breaks():
    """A worker that cannot get the card dies in its initializer: the pool
    respawns it, retires the seat and fails queued chunks as broken — the
    chunk never runs elsewhere.  (``cuda:64`` is a card no machine has.)"""
    pool = make_pool(max_respawns=1, initializer=worker_mod.init_worker,
                     initargs=("cuda:64",))
    try:
        fut = pool.submit(probe, None, 1)
        with pytest.raises(WorkerLost) as ei:
            fut.result(timeout=120)
        assert ei.value.reason == "broken"
        s = pool.stats()
        assert s["retired"] == 1 and s["workers_lost"] == 2 and s["respawns"] == 1
    finally:
        pool.shutdown(wait=False, cancel_pending=True)


def test_worker_init_raises_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="CUDA"):
            worker_mod.init_worker(device)
    assert capsys.readouterr().err == ""  # no worker_ready without the device
    worker_mod.init_worker("cpu")  # the plain versions need no library
    (line,) = capsys.readouterr().err.splitlines()
    ready = json.loads(line)
    assert ready["event"] == "worker_ready" and ready["device"] == "cpu"
    assert ready["imports_s"] >= 0 and "context_s" not in ready


def test_spawn_worker_runs_chunks_to_the_reference_s_rows():
    """A real spawn worker, initialised on the CPU, runs two chunks: the
    records equal the reference's, the second chunk finds the first's
    host artifacts warm, and each reports its launch delta (none on the
    CPU: the plain versions launch no kernel)."""
    from repro_torch.sweep.results import scenario_row

    spec = tiny_spec(accels=("accugraph", "hitgraph"), drams=("default", "hbm"))
    scenarios = spec.scenarios()
    pool = make_pool(initializer=worker_mod.init_worker, initargs=("cpu",),
                     task_deadline_s=120.0)
    try:
        outs = [pool.submit(worker_mod.run_chunk, chunk, "batch", None, True, None,
                            "cpu").result(timeout=120)
                for chunk in (scenarios[:2], scenarios[2:])]
    finally:
        pool.shutdown(wait=True)
    records = outs[0]["records"] + outs[1]["records"]
    assert [r["status"] for r in records] == ["ok"] * 4
    ref_spec = ref_sweep.SweepSpec(name="t", accelerators=("accugraph", "hitgraph"),
                                   graphs=(RefGraphSpec(*TINY_ARGS),), problems=("bfs",),
                                   drams=("default", "hbm"))
    want = ref_sweep.result_rows(ref_sweep.run_sweep(ref_spec))
    assert [scenario_row(s, r) for s, r in zip(scenarios, records)] == want
    for out in outs:
        assert out["launches"] == dict.fromkeys(_platform.LAUNCHES, 0)
    assert outs[1]["hostcache"]["artifacts"]["hits"] > 0


def test_run_chunk_reports_its_own_launch_delta(monkeypatch):
    """The delta is this chunk's, not the process's running total."""
    def fake_chunk(scenarios, mode, policy, with_trace_hash, device):
        _platform.LAUNCHES["dram_timing"] += 3 * len(scenarios)
        _platform.LAUNCHES["spmv"] += 1
        return [dict(status="ok")] * len(scenarios)

    monkeypatch.setattr(worker_mod, "execute_chunk", fake_chunk)
    _platform.LAUNCHES["dram_timing"] += 100  # earlier chunks of this process
    try:
        out = worker_mod.run_chunk([None, None], "batch", None, False, None, "cpu")
    finally:
        _platform.reset_launches()
    assert out["launches"] == dict(dram_timing=6, edge_update=0, spmv=1, attention=0)


# ---- scheduler: re-dispatch, poison breaker, corrupt records, cancel --------


class ManualPool:
    """Fully test-controlled pool stand-in: every submitted chunk parks as
    a (fn, args, future) triple; the test completes it (``run``), fails it
    with a WorkerLost (``lose``) or corrupts its records (``run_corrupt``)
    at a deterministic point."""

    def __init__(self, size=1):
        self.size = size
        self.calls = []

    def submit(self, fn, *args):
        fut = Future()
        self.calls.append((fn, args, fut))
        return fut

    def run(self, i):
        fn, args, fut = self.calls[i]
        fut.set_result(fn(*args))

    def run_corrupt(self, i):
        fn, args, fut = self.calls[i]
        out = fn(*args)
        out["records"] = corrupt_records(out["records"])
        fut.set_result(out)

    def lose(self, i, reason="crash"):
        _, _, fut = self.calls[i]
        fut.set_exception(WorkerLost(reason, 0, "injected by test"))

    def chunk_sizes(self):
        return [len(args[0]) for _, args, _ in self.calls]

    def shutdown(self, wait=True, cancel_pending=False):
        for _, _, fut in self.calls:
            if not fut.done():
                fut.cancel()

    def stats(self):
        return dict(size=self.size, busy=0, chunks_submitted=len(self.calls),
                    utilization=0.0)


def scheduler(tmp_path, pool, **kw):
    kw.setdefault("chunk_size", 4)
    kw.setdefault("mode", "scenario")
    kw.setdefault("device", "cpu")
    return SweepScheduler(cache_dir=str(tmp_path / "cache"),
                          pool_factory=lambda: pool, **kw)


def test_dispatch_carries_the_device_and_sums_worker_launches(tmp_path, monkeypatch):
    pool = ManualPool()
    sched = scheduler(tmp_path, pool)
    try:
        job = sched.submit(tiny_spec(accels=("accugraph", "hitgraph")))
        wait_for(lambda: len(pool.calls) == 1, what="dispatch")
        fn, args, fut = pool.calls[0]
        assert fn is worker_mod.run_chunk and args[4] is None and args[5] == "cpu"
        out = fn(*args)
        out["launches"] = dict(dram_timing=4, edge_update=2, spmv=0, attention=0)
        fut.set_result(out)
        assert collect_events(job)[-1]["type"] == "done"
        stats = sched.stats()
        assert stats["device"] == "cpu"
        assert stats["launches"] == out["launches"]
    finally:
        sched.close()


def test_lost_chunk_redispatches_scenarios_as_singletons(tmp_path):
    pool = ManualPool()
    sched = scheduler(tmp_path, pool)
    try:
        job = sched.submit(tiny_spec(accels=("accugraph", "hitgraph")))
        wait_for(lambda: len(pool.calls) == 1, what="first dispatch")
        assert pool.chunk_sizes() == [2]
        pool.lose(0, "crash")
        wait_for(lambda: len(pool.calls) == 3, what="singleton re-dispatches")
        assert pool.chunk_sizes() == [2, 1, 1]
        pool.run(1)
        pool.run(2)
        events = collect_events(job)
        assert events[-1]["type"] == "done"
        assert [e["status"] for e in events if e["type"] == "row"] == ["ok", "ok"]
        s = sched.stats()
        assert s["faults"]["chunks_lost"] == 1
        assert s["faults"]["scenarios_redispatched"] == 2
        assert s["faults"]["scenarios_poisoned"] == 0
    finally:
        sched.close()


def test_poison_scenario_trips_circuit_breaker(tmp_path):
    pool = ManualPool()
    sched = scheduler(tmp_path, pool, poison_threshold=2)
    try:
        job = sched.submit(tiny_spec())
        wait_for(lambda: len(pool.calls) == 1, what="dispatch 1")
        pool.lose(0, "crash")
        wait_for(lambda: len(pool.calls) == 2, what="re-dispatch")
        pool.lose(1, "hang")
        events = collect_events(job)
        assert events[-1]["type"] == "done"
        rows = [e for e in events if e["type"] == "row"]
        assert len(rows) == 1 and rows[0]["status"] == "error" and rows[0]["poison"]
        row = rows[0]["row"]
        assert row["poison"] is True and row["attempts"] == 2
        assert "quarantined" in row["error"]
        assert sched.stats()["faults"]["scenarios_poisoned"] == 1
        (scn,), _ = tiny_spec().expand()
        assert ResultCache(str(tmp_path / "cache")).get(scenario_hash(scn)) is None
        job2 = sched.submit(tiny_spec())
        wait_for(lambda: len(pool.calls) == 3, what="post-poison retry")
        pool.run(2)
        assert [e["status"] for e in collect_events(job2) if e["type"] == "row"] == ["ok"]
    finally:
        sched.close()


def test_corrupt_worker_records_requeue_then_recover(tmp_path):
    pool = ManualPool()
    sched = scheduler(tmp_path, pool)
    try:
        job = sched.submit(tiny_spec())
        wait_for(lambda: len(pool.calls) == 1, what="dispatch 1")
        pool.run_corrupt(0)  # status ok, garbage report payload
        wait_for(lambda: len(pool.calls) == 2, what="re-dispatch")
        pool.run(1)
        assert [e["status"] for e in collect_events(job) if e["type"] == "row"] == ["ok"]
        s = sched.stats()
        assert s["counters"]["corrupt_records"] == 1
        assert s["faults"]["scenarios_redispatched"] == 1
    finally:
        sched.close()


def test_chunk_shape_mismatch_treated_as_lost(tmp_path):
    pool = ManualPool()
    sched = scheduler(tmp_path, pool, poison_threshold=99)
    try:
        job = sched.submit(tiny_spec(accels=("accugraph", "hitgraph")))
        wait_for(lambda: len(pool.calls) == 1, what="dispatch 1")
        _, _, fut = pool.calls[0]
        fut.set_result(dict(records=[dict(status="ok")], hostcache={}))
        wait_for(lambda: len(pool.calls) == 3, what="re-dispatches")
        pool.run(1)
        pool.run(2)
        assert [e["status"] for e in collect_events(job) if e["type"] == "row"] == \
            ["ok", "ok"]
    finally:
        sched.close()


def test_cancel_during_dispatch_drops_lost_chunk(tmp_path):
    pool = ManualPool()
    sched = scheduler(tmp_path, pool)
    try:
        job = sched.submit(tiny_spec())
        wait_for(lambda: len(pool.calls) == 1, what="dispatch")
        assert sched.cancel(job.id)
        assert collect_events(job, timeout=10)[-1]["type"] == "cancelled"
        pool.lose(0, "crash")  # the in-flight chunk dies after the cancel
        time.sleep(0.3)
        assert len(pool.calls) == 1  # nobody subscribes: no re-dispatch
        s = sched.stats()
        assert s["faults"]["scenarios_redispatched"] == 0
        assert s["counters"]["scenarios_cancelled"] == 1
        (scn,), _ = tiny_spec().expand()
        assert ResultCache(str(tmp_path / "cache")).get(scenario_hash(scn)) is None
        job2 = sched.submit(tiny_spec())
        wait_for(lambda: len(pool.calls) == 2, what="fresh dispatch")
        pool.run(1)
        assert collect_events(job2)[-1]["type"] == "done"
    finally:
        sched.close()


def test_injected_chunk_faults_are_dispatch_indexed(tmp_path):
    plan = FaultPlan(seed=1, rules=(FaultRule("worker.chunk", "crash", at=(0,)),))
    pool = ManualPool()
    sched = scheduler(tmp_path, pool, fault_plan=plan, poison_threshold=3)
    try:
        job = sched.submit(tiny_spec())
        wait_for(lambda: len(pool.calls) == 1, what="dispatch 0")
        _, args0, _ = pool.calls[0]
        assert args0[4] is not None and args0[4].kind == "crash"
        pool.lose(0, "crash")  # what the real pool would observe
        wait_for(lambda: len(pool.calls) == 2, what="dispatch 1")
        _, args1, _ = pool.calls[1]
        assert args1[4] is None  # at=(0,): the retry dispatch is clean
        pool.run(1)
        assert [e["status"] for e in collect_events(job) if e["type"] == "row"] == ["ok"]
        assert sched.stats()["faults"]["faults_injected"] == 1
    finally:
        sched.close()


def test_crash_fault_through_real_spawn_workers(tmp_path):
    """The scheduler on a real pool of spawn workers (on the CPU): a crash
    injected at dispatch 1 loses that worker, its seat respawns a fresh
    process, and the rows equal a fault-free run's."""
    from repro_torch.sweep.results import result_rows
    from repro_torch.sweep.runner import run_sweep

    spec = tiny_spec(accels=("accugraph", "hitgraph", "thundergp"), drams=("default", "hbm"))
    plan = FaultPlan(seed=0, rules=(FaultRule("worker.chunk", "crash", at=(1,)),))
    sched = SweepScheduler(cache_dir=str(tmp_path / "cache"), workers=2, chunk_size=2,
                           fault_plan=plan, device="cpu")
    try:
        events = collect_events(sched.submit(spec), timeout=180)
        stats = sched.stats()
    finally:
        sched.drain(timeout=30.0)
    rows = sorted((e for e in events if e["type"] == "row"), key=lambda e: e["index"])
    assert [e["status"] for e in rows] == ["ok"] * 6
    assert [e["row"] for e in rows] == result_rows(run_sweep(spec, device="cpu"))
    assert stats["faults"]["chunks_lost"] == 1 and stats["faults"]["faults_injected"] == 1
    assert stats["faults"]["workers_lost"] == 1 and stats["faults"]["worker_respawns"] == 1
    assert stats["launches"] == dict.fromkeys(_platform.LAUNCHES, 0)


# ---- job journal ------------------------------------------------------------


def test_journal_roundtrip_and_torn_line(tmp_path):
    j = JobJournal(tmp_path)
    j.record_job("job-1", "a", dict(name="a"))
    j.record_job("job-2", "b", dict(name="b"))
    j.record_end("job-1", "done")
    assert [op["id"] for op in j.load_open()] == ["job-2"]
    with open(j.path, "a") as f:  # a crash mid-append tears the last line
        f.write('{"op": "end", "id": "job-2", "outc')
    assert [op["id"] for op in j.load_open()] == ["job-2"]
    assert len(j.load()) == 3
    assert j.compact() == 2
    ops = j.load()
    assert len(ops) == 1 and ops[0]["id"] == "job-2"


def test_journal_missing_file_is_empty(tmp_path):
    j = JobJournal(tmp_path / "nope")
    assert j.load() == [] and j.load_open() == [] and j.compact() == 0


def test_journal_equals_the_reference_s_bytes(tmp_path, monkeypatch):
    from repro.serve.journal import JobJournal as RefJournal

    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    for cls, d in ((JobJournal, tmp_path / "p"), (RefJournal, tmp_path / "r")):
        j = cls(d)
        j.record_job("job-1", "a", dict(name="a", accelerators=["accugraph"]))
        j.record_job("job-2", "b", dict(name="b"), kind="search")
        j.record_end("job-1", "done")
        j.compact()
    assert Path(JobJournal(tmp_path / "p").path).read_bytes() == \
        Path(RefJournal(tmp_path / "r").path).read_bytes()


def test_journal_fsyncs_directory_entry(tmp_path, monkeypatch):
    synced_dirs = []
    real_fsync = os.fsync

    def spy(fd):
        if stat.S_ISDIR(os.fstat(fd).st_mode):
            synced_dirs.append(fd)
        return real_fsync(fd)

    monkeypatch.setattr(os, "fsync", spy)
    j = JobJournal(tmp_path)
    j.record_job("job-1", "a", dict(name="a"))
    assert len(synced_dirs) == 1  # creation made durable
    j.record_end("job-1", "done")
    j.record_job("job-2", "b", dict(name="b"))
    assert len(synced_dirs) == 1  # steady-state appends skip the dirfd
    assert j.compact() == 2
    assert len(synced_dirs) == 2  # the compaction rename made durable


def test_scheduler_recovers_open_jobs_from_journal(tmp_path):
    pool = ManualPool()
    sched = scheduler(tmp_path, pool, chunk_size=1)
    job = sched.submit(tiny_spec(accels=("accugraph", "hitgraph")))
    jid = job.id
    wait_for(lambda: len(pool.calls) >= 1, what="first dispatch")
    pool.run(0)
    wait_for(lambda: job.done >= 1, what="first row")
    sched.close()  # hard stop: no drain, no journal end op

    pool2 = ManualPool()
    sched2 = scheduler(tmp_path, pool2, chunk_size=1)
    try:
        rec = sched2.get_job(jid)
        assert rec is not None and rec.recovered
        wait_for(lambda: len(pool2.calls) == 1, what="recovery dispatch")
        assert pool2.chunk_sizes() == [1]
        pool2.run(0)
        wait_for(lambda: rec.finished, what="recovered job finishing")
        assert rec.counts["cached"] == 1 and rec.counts["ok"] == 1
        assert sched2.stats()["jobs"]["recovered"] == 1
        fresh = sched2.submit(tiny_spec(accels=("foregraph",)))
        assert fresh.id != jid
    finally:
        sched2.close()

    sched3 = scheduler(tmp_path, ManualPool())
    try:
        assert sched3.get_job(jid) is None
        open3 = sched3.get_job(fresh.id)
        assert open3 is not None and open3.recovered
        assert sched3.stats()["jobs"]["recovered"] == 1
    finally:
        sched3.close()


@pytest.mark.parametrize("how", ["resume_false", "cancelled"])
def test_jobs_not_recovered(tmp_path, how):
    pool = ManualPool()
    sched = scheduler(tmp_path, pool)
    job = sched.submit(tiny_spec())
    wait_for(lambda: len(pool.calls) == 1, what="dispatch")
    if how == "cancelled":
        sched.cancel(job.id)
    sched.close()
    sched2 = scheduler(tmp_path, ManualPool(), resume=how != "resume_false")
    try:
        assert sched2.get_job(job.id) is None
        assert sched2.stats()["jobs"]["recovered"] == 0
    finally:
        sched2.close()

