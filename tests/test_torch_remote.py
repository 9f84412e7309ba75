"""The port's multi-host sweep serving (``repro_torch.distributed.remote``)
against the reference's (``tests/test_remote.py``, test for test): the
serve wire codec, the RemoteWorkerPool / WorkerHostAgent pair, scheduler
integration (rows equal to the reference's ``run_sweep`` rows and to the
tiny golden trace hashes, chunk re-dispatch on host loss, poison parity),
remote-site fault injection (drop / delay / disconnect), host
re-registration, and the real subprocess topology (server + two
worker-host agents, one SIGKILLed mid-campaign).  Besides, what the port
changes: ``submit`` takes the scheduler's six ``run_chunk`` arguments and
ships five (the scheduler host's device stays behind), a chunk's kernel
launches reach the scheduler's ``/stats``, each host reports its device,
a host of another backend is refused, and a host without its device
exits 2.  Everything runs on the CPU (``device="cpu"``).

Tolerance: exact equality of rows (``wall_s`` is no row column).
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from http.client import HTTPConnection
from pathlib import Path

import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

import repro.sweep as ref_sweep  # noqa: E402
import repro_torch.serve.__main__ as serve_cli  # noqa: E402
from repro.graph.generators import GraphSpec as RefGraphSpec  # noqa: E402
from repro_torch.distributed.faults import FaultPlan, FaultRule  # noqa: E402
from repro_torch.distributed.remote import (  # noqa: E402
    RemoteWorkerPool,
    WorkerHostAgent,
    parse_address,
)
from repro_torch.distributed.workpool import WorkerLost  # noqa: E402
from repro_torch.graph.generators import GraphSpec  # noqa: E402
from repro_torch.serve import TERMINAL_EVENTS, ServeClient  # noqa: E402
from repro_torch.serve import worker as worker_mod  # noqa: E402
from repro_torch.serve.protocol import (  # noqa: E402
    ProtocolError,
    chunk_from_wire,
    chunk_to_wire,
    parse_event,
    policy_from_wire,
    policy_to_wire,
    scenario_from_wire,
    scenario_to_wire,
)
from repro_torch.serve.scheduler import SweepScheduler  # noqa: E402
from repro_torch.sweep import ExecutionPolicy, SweepSpec  # noqa: E402
from repro_torch.sweep.cache import scenario_hash  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
TINY_GOLDEN = ROOT / "benchmarks" / "golden_hashes_tiny.json"
TINY_ARGS = ("tiny", "uniform", 256, 1024, True, 1, 0)
TINY = GraphSpec(*TINY_ARGS)
ACCELS = ("accugraph", "foregraph", "hitgraph", "thundergp")


def tiny_spec(accels=("accugraph",), problems=("bfs",), graphs=(TINY,),
              drams=("default",), **kw):
    return SweepSpec(name="t", accelerators=tuple(accels),
                     graphs=tuple(graphs), problems=tuple(problems),
                     drams=tuple(drams), **kw)


def ref_rows(accels=("accugraph",), problems=("bfs",), drams=("default",)):
    """The reference's ``run_sweep`` rows of the same tiny spec."""
    spec = ref_sweep.SweepSpec(name="t", accelerators=tuple(accels),
                               graphs=(RefGraphSpec(*TINY_ARGS),),
                               problems=tuple(problems), drams=tuple(drams))
    return ref_sweep.result_rows(ref_sweep.run_sweep(spec, cache_dir=None,
                                                     mode="scenario"))


def chunk_args(spec=None):
    """The scheduler's six ``run_chunk`` arguments for one tiny chunk."""
    scenarios, _ = (spec or tiny_spec()).expand()
    return (scenarios, "scenario", None, False, None, "cpu")


def wait_for(cond, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    pytest.fail(f"timed out waiting for {what}")


def collect_events(job, timeout=120.0):
    events = []
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            ev = job.events.get(timeout=1.0)
        except Exception:
            continue
        events.append(ev)
        if ev["type"] in TERMINAL_EVENTS:
            return events
    pytest.fail(f"job {job.id} produced no terminal event in {timeout}s")


def rows_by_index(events) -> list[dict]:
    return [e["row"] for e in sorted((e for e in events if e["type"] == "row"),
                                     key=lambda e: e["index"])]


# ---- wire codec -------------------------------------------------------------


def test_scenario_wire_roundtrip_is_hash_identical():
    spec = tiny_spec(accels=ACCELS, problems=("bfs", "pr"),
                     drams=("default", "hbm"))
    scenarios, _ = spec.expand()
    assert scenarios
    for s in scenarios:
        wire = scenario_to_wire(s)
        # the wire form must actually be JSON, not merely dict-shaped
        back = scenario_from_wire(json.loads(json.dumps(wire)))
        assert back == s
        assert scenario_hash(back) == scenario_hash(s)


def test_policy_wire_roundtrip_carries_fault_plan():
    assert policy_from_wire(policy_to_wire(None)) is None
    plan = FaultPlan(seed=3, rules=(FaultRule("scenario", "error", at=(1,)),))
    p = ExecutionPolicy(timeout_s=2.5, retries=2, backoff_s=0.1,
                        fault_plan=plan)
    back = policy_from_wire(json.loads(json.dumps(policy_to_wire(p))))
    assert (back.timeout_s, back.retries, back.backoff_s) == (2.5, 2, 0.1)
    assert back.fault_plan == plan


def test_chunk_wire_roundtrip():
    scenarios, _ = tiny_spec().expand()
    ev = json.loads(json.dumps(chunk_to_wire(
        7, scenarios, "batch", ExecutionPolicy(retries=1), True, None)))
    chunk_id, back, mode, policy, hashes, inject = chunk_from_wire(ev)
    assert chunk_id == 7 and back == list(scenarios)
    assert mode == "batch" and policy.retries == 1
    assert hashes is True and inject is None
    with pytest.raises(ProtocolError):
        chunk_from_wire(dict(type="chunk", chunk="x"))


def test_parse_address():
    assert parse_address("10.0.0.2:8732") == ("10.0.0.2", 8732)
    assert parse_address(":8732") == ("127.0.0.1", 8732)
    with pytest.raises(ValueError):
        parse_address("no-port")


# ---- in-process remote pool + agent ----------------------------------------


class InlinePool:
    """Agent-side local-pool stand-in: executes chunks on threads in this
    very process — the remote plumbing is exercised end to end without
    paying spawn-worker startup per test."""

    def __init__(self, seats=2):
        self.size = seats
        self._ex = ThreadPoolExecutor(max_workers=seats)

    def submit(self, fn, *args):
        return self._ex.submit(fn, *args)

    def shutdown(self, wait=True, cancel_pending=False, grace_s=None):
        self._ex.shutdown(wait=False)


class LosingPool(InlinePool):
    """Local pool whose first ``fail_first`` chunks die as WorkerLost —
    the host is healthy, its worker wasn't."""

    def __init__(self, seats=1, fail_first=1, reason="crash"):
        super().__init__(seats)
        self.fail_first = fail_first
        self.reason = reason
        self.losses = 0

    def submit(self, fn, *args):
        if self.losses < self.fail_first:
            self.losses += 1
            fut = Future()
            fut.set_exception(WorkerLost(self.reason, -1, "injected locally"))
            return fut
        return super().submit(fn, *args)


class LaunchingPool(InlinePool):
    """Local pool that adds a known kernel-launch delta to every chunk it
    runs (on the CPU a chunk launches nothing), and records the arguments
    each chunk reached the host with."""

    DELTA = {"dram_timing": 3, "edge_update": 5, "spmv": 7}

    def __init__(self, seats=1):
        super().__init__(seats)
        self.calls = []

    def submit(self, fn, *args):
        self.calls.append(args)

        def run():
            out = fn(*args)
            return dict(out, launches={k: out["launches"].get(k, 0) + n
                                       for k, n in self.DELTA.items()})
        return self._ex.submit(run)


def make_remote_pool(**kw):
    kw.setdefault("heartbeat_s", 0.1)
    kw.setdefault("task_deadline_s", 10.0)
    kw.setdefault("stall_deadline_s", 1.0)
    return RemoteWorkerPool(**kw)


def start_agent(address, name, seats=2, pool=None):
    agent = WorkerHostAgent(address, seats=seats, name=name,
                            heartbeat_s=0.1, reconnect_backoff_s=0.05,
                            pool=pool or InlinePool(seats), device="cpu")
    t = threading.Thread(target=agent.run, daemon=True)
    t.start()
    return agent, t


def test_remote_pool_executes_chunks_and_tracks_hosts():
    pool = make_remote_pool()
    agent = None
    try:
        assert pool.size == 0  # no hosts yet: capacity is live, not fixed
        agent, _ = start_agent(pool.address, "h1", seats=2)
        wait_for(lambda: pool.size == 2, what="host registration")
        out = pool.submit(worker_mod.run_chunk, *chunk_args()).result(timeout=120)
        assert [r["status"] for r in out["records"]] == ["ok"]
        s = pool.stats()
        assert s["size"] == 2 and s["alive"] == 1
        assert s["hosts"]["h1"]["chunks_done"] == 1
        assert s["workers_lost"] == 0
    finally:
        if agent:
            agent.stop()
        pool.shutdown(wait=False, cancel_pending=True)


def test_remote_pool_rejects_foreign_callables():
    pool = make_remote_pool()
    try:
        with pytest.raises(TypeError):
            pool.submit(print, "not a chunk")
        # the reference's five-argument shape is not the port's dispatch
        with pytest.raises(TypeError, match="6 arguments"):
            pool.submit(worker_mod.run_chunk, *chunk_args()[:5])
        assert pool.stats()["chunks_submitted"] == 0
    finally:
        pool.shutdown(wait=False, cancel_pending=True)


def test_chunks_queue_until_a_host_arrives():
    """submit() before any host exists must park the chunk, not fail —
    the scheduler dispatches into an empty pool at startup."""
    pool = make_remote_pool()
    agent = None
    try:
        fut = pool.submit(worker_mod.run_chunk, *chunk_args())
        assert pool.stats()["queued"] == 1
        agent, _ = start_agent(pool.address, "late", seats=1)
        out = fut.result(timeout=120)
        assert [r["status"] for r in out["records"]] == ["ok"]
    finally:
        if agent:
            agent.stop()
        pool.shutdown(wait=False, cancel_pending=True)


def test_host_death_fails_inflight_chunks_as_workerlost():
    class BlockingPool(InlinePool):
        def __init__(self):
            super().__init__(1)
            self.started = threading.Event()
            self.release = threading.Event()

        def submit(self, fn, *args):
            def blocked():
                self.started.set()
                self.release.wait(30)
                return fn(*args)
            return self._ex.submit(blocked)

    pool = make_remote_pool()
    local = BlockingPool()
    agent, _ = start_agent(pool.address, "doomed", seats=1, pool=local)
    try:
        wait_for(lambda: pool.size == 1, what="registration")
        fut = pool.submit(worker_mod.run_chunk, *chunk_args())
        assert local.started.wait(30), "chunk never reached the host"
        agent.stop()  # the host vanishes mid-chunk (downlink closes)
        with pytest.raises(WorkerLost) as ei:
            fut.result(timeout=30)
        assert ei.value.reason in ("crash", "stall")
        assert "doomed" in ei.value.detail
        assert pool.stats()["workers_lost"] == 1
    finally:
        local.release.set()
        pool.shutdown(wait=False, cancel_pending=True)


def test_local_worker_loss_is_forwarded_loss_for_loss():
    """A host whose *local* pool loses a worker reports the chunk lost with
    the local reason — the scheduler can't tell a lost host from a lost
    process, so its recovery is identical."""
    pool = make_remote_pool()
    agent, _ = start_agent(pool.address, "flaky", seats=1,
                           pool=LosingPool(fail_first=1, reason="hang"))
    try:
        wait_for(lambda: pool.size == 1, what="registration")
        fut = pool.submit(worker_mod.run_chunk, *chunk_args())
        with pytest.raises(WorkerLost) as ei:
            fut.result(timeout=30)
        assert ei.value.reason == "hang" and "flaky" in ei.value.detail
        # the host itself is fine: the next chunk runs
        out = pool.submit(worker_mod.run_chunk, *chunk_args()).result(timeout=120)
        assert [r["status"] for r in out["records"]] == ["ok"]
    finally:
        agent.stop()
        pool.shutdown(wait=False, cancel_pending=True)


def test_drop_fault_reclaimed_by_liveness_deadline():
    plan = FaultPlan(seed=0, rules=(FaultRule("remote", "drop", at=(0,)),))
    pool = make_remote_pool(task_deadline_s=1.0, fault_plan=plan)
    agent, _ = start_agent(pool.address, "h1", seats=1)
    try:
        wait_for(lambda: pool.size == 1, what="registration")
        t0 = time.monotonic()
        fut = pool.submit(worker_mod.run_chunk, *chunk_args())
        with pytest.raises(WorkerLost) as ei:
            fut.result(timeout=30)
        assert ei.value.reason == "hang"
        assert time.monotonic() - t0 < 20
        assert pool.stats()["workers_lost"] == 1
    finally:
        agent.stop()
        pool.shutdown(wait=False, cancel_pending=True)


def test_disconnect_fault_severs_then_host_reregisters():
    plan = FaultPlan(seed=0,
                     rules=(FaultRule("remote", "disconnect", at=(0,)),))
    pool = make_remote_pool(fault_plan=plan)
    agent, _ = start_agent(pool.address, "h1", seats=1)
    try:
        wait_for(lambda: pool.size == 1, what="registration")
        fut = pool.submit(worker_mod.run_chunk, *chunk_args())
        # assignment 0 delivers the chunk then severs the downlink: the
        # chunk fails as lost and the agent re-registers with backoff
        with pytest.raises(WorkerLost):
            fut.result(timeout=30)
        wait_for(lambda: pool.size == 1, what="re-registration")
        wait_for(lambda: agent.sessions >= 2, what="second session")
        assert pool.stats()["respawns"] >= 1
        # assignment 1 is clean: the re-registered host executes it
        out = pool.submit(worker_mod.run_chunk, *chunk_args()).result(timeout=120)
        assert [r["status"] for r in out["records"]] == ["ok"]
    finally:
        agent.stop()
        pool.shutdown(wait=False, cancel_pending=True)


# ---- what the port changes -----------------------------------------------------


def _register_raw(address: str, **body):
    """Open a /register session by hand; returns (connection, response)."""
    host, port = parse_address(address)
    conn = HTTPConnection(host, port, timeout=10)
    conn.request("POST", "/register", body=json.dumps(body).encode(),
                 headers={"Content-Type": "application/json"})
    return conn, conn.getresponse()


def test_submit_ships_five_arguments_and_keeps_the_device():
    """The scheduler's sixth ``run_chunk`` argument names a card on the
    scheduler's host: it never reaches the wire, and the host runs the
    chunk on its own device."""
    pool = make_remote_pool()
    conn = None
    try:
        scenarios, _ = tiny_spec().expand()
        pool.submit(worker_mod.run_chunk, scenarios, "batch", None, True,
                    None, "cuda:3")
        conn, resp = _register_raw(pool.address, name="raw", seats=1, pid=1,
                                   device="cpu", backend="repro_torch")
        assert resp.status == 200
        events = []
        while not events or events[-1]["type"] != "chunk":
            events.append(parse_event(resp.readline().strip()))
        assert events[0]["type"] == "registered"
        chunk = events[-1]
        assert set(chunk) == {"type", "chunk", "scenarios", "mode", "policy",
                              "trace_hashes", "inject"}
        assert "cuda" not in json.dumps(chunk)
        _, back, mode, policy, hashes, inject = chunk_from_wire(chunk)
        assert (back, mode, policy, hashes, inject) == (list(scenarios),
                                                        "batch", None, True, None)
        assert pool.stats()["hosts"]["raw"]["device"] == "cpu"
    finally:
        if conn is not None:
            conn.close()
        pool.shutdown(wait=False, cancel_pending=True)


def test_hosts_report_their_device_and_run_chunks_on_it():
    pool = make_remote_pool()
    local = LaunchingPool()
    agent, _ = start_agent(pool.address, "h1", seats=1, pool=local)
    try:
        wait_for(lambda: pool.size == 1, what="registration")
        assert pool.stats()["hosts"]["h1"]["device"] == "cpu"
        assert agent.device == "cpu"
        pool.submit(worker_mod.run_chunk, *chunk_args()[:5], "cuda:3"
                    ).result(timeout=120)
        (args,) = local.calls
        assert len(args) == 6 and args[5] == "cpu"  # the host's, not "cuda:3"
    finally:
        agent.stop()
        pool.shutdown(wait=False, cancel_pending=True)


@pytest.mark.parametrize("backend", [None, "repro"])
def test_register_refuses_another_backend(backend):
    """A host of another package (the reference's agent sends no backend)
    is refused with 400 and never gets a seat."""
    pool = make_remote_pool()
    try:
        body = dict(name="jax-host", seats=2, pid=1, device="tpu")
        if backend is not None:
            body["backend"] = backend
        conn, resp = _register_raw(pool.address, **body)
        assert resp.status == 400
        assert "repro_torch" in json.loads(resp.read())["error"]
        conn.close()
        assert pool.size == 0 and pool.stats()["registrations"] == 0
    finally:
        pool.shutdown(wait=False, cancel_pending=True)


def test_remote_launches_reach_scheduler_stats(tmp_path):
    """Each chunk's kernel-launch delta crosses the wire beside its
    records and lands in the scheduler's ``stats()["launches"]``."""
    spec = tiny_spec(accels=("accugraph", "hitgraph"))
    pool = make_remote_pool()
    sched = remote_scheduler(tmp_path, pool, chunk_size=1)
    agent, _ = start_agent(pool.address, "h1", seats=1, pool=LaunchingPool())
    try:
        wait_for(lambda: pool.size == 1, what="registration")
        events = collect_events(sched.submit(spec), timeout=300)
        assert events[-1]["type"] == "done"
        launches = sched.stats()["launches"]
        assert launches == dict({k: 2 * n for k, n in LaunchingPool.DELTA.items()},
                                attention=0, attention_bwd=0, ssm_scan=0)
    finally:
        agent.stop()
        sched.close()


def test_worker_host_without_its_device_exits_2(capsys, monkeypatch):
    """No card and no ``--device``: the agent never starts and never
    serves on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--device", "cuda"]):
        assert serve_cli.main(["worker", "--connect", "127.0.0.1:1"] + extra) == 2
        assert capsys.readouterr().err.startswith("error: ")
    with pytest.raises(RuntimeError, match="CUDA"):
        WorkerHostAgent("127.0.0.1:1", pool=InlinePool(1))


# ---- scheduler integration --------------------------------------------------


def remote_scheduler(tmp_path, pool, **kw):
    kw.setdefault("chunk_size", 2)
    kw.setdefault("mode", "scenario")
    return SweepScheduler(cache_dir=str(tmp_path / "cache"),
                          pool_factory=lambda: pool, device="cpu", **kw)


def test_scheduler_rows_byte_identical_across_two_hosts(tmp_path):
    """The acceptance bar: a campaign served by two worker hosts produces
    exactly the reference's rows, and the golden trace hashes."""
    kw = dict(accels=("accugraph", "hitgraph", "foregraph"),
              drams=("default", "hbm"))
    spec = tiny_spec(**kw)
    pool = make_remote_pool()
    sched = remote_scheduler(tmp_path, pool, trace_hashes=True)
    a1, _ = start_agent(pool.address, "h1", seats=1)
    a2, _ = start_agent(pool.address, "h2", seats=1)
    try:
        wait_for(lambda: pool.size == 2, what="both hosts")
        events = collect_events(sched.submit(spec), timeout=300)
        assert events[-1]["type"] == "done"
        assert rows_by_index(events) == ref_rows(**kw)
        golden = json.loads(TINY_GOLDEN.read_text())
        ids = [s.scenario_id for s in spec.scenarios()]
        assert {ids[e["index"]]: e["trace_hash"] for e in events
                if e["type"] == "row"} == {sid: golden[sid] for sid in ids}
        # both hosts actually participated
        hosts = pool.stats()["hosts"]
        assert hosts["h1"]["chunks_done"] >= 1
        assert hosts["h2"]["chunks_done"] >= 1
    finally:
        a1.stop()
        a2.stop()
        sched.close()


def test_scheduler_redispatches_after_host_kill(tmp_path):
    """Killing a host mid-chunk re-dispatches its scenarios to the
    survivor; the campaign still completes with the reference's rows."""
    class BlockOnce(InlinePool):
        def __init__(self):
            super().__init__(1)
            self.first = threading.Event()
            self.release = threading.Event()
            self._n = 0

        def submit(self, fn, *args):
            self._n += 1
            if self._n == 1:
                def blocked():
                    self.first.set()
                    self.release.wait(60)
                    return fn(*args)
                return self._ex.submit(blocked)
            return super().submit(fn, *args)

    kw = dict(accels=("accugraph", "hitgraph"))
    spec = tiny_spec(**kw)
    pool = make_remote_pool()
    sched = remote_scheduler(tmp_path, pool, chunk_size=1)
    doomed_local = BlockOnce()
    doomed, _ = start_agent(pool.address, "doomed", seats=1,
                            pool=doomed_local)
    survivor = None
    try:
        wait_for(lambda: pool.size == 1, what="doomed host")
        job = sched.submit(spec)
        assert doomed_local.first.wait(60), "no chunk reached doomed host"
        survivor, _ = start_agent(pool.address, "survivor", seats=1)
        wait_for(lambda: "survivor" in pool.stats()["hosts"],
                 what="survivor host")
        doomed.stop()  # dies holding a chunk
        events = collect_events(job, timeout=300)
        assert events[-1]["type"] == "done"
        statuses = [e["status"] for e in events if e["type"] == "row"]
        assert sorted(statuses) == ["ok", "ok"]
        assert rows_by_index(events) == ref_rows(**kw)
        s = sched.stats()
        assert s["faults"]["chunks_lost"] >= 1
        assert s["faults"]["scenarios_redispatched"] >= 1
    finally:
        doomed_local.release.set()
        if survivor:
            survivor.stop()
        sched.close()


def test_remote_poison_parity(tmp_path):
    """A chunk that is dropped on every dispatch trips the scheduler's
    poison breaker exactly as a crash-looping local worker does."""
    plan = FaultPlan(seed=0, rules=(FaultRule("remote", "drop"),))
    pool = make_remote_pool(task_deadline_s=0.5, fault_plan=plan)
    sched = remote_scheduler(tmp_path, pool, poison_threshold=2)
    agent, _ = start_agent(pool.address, "h1", seats=1)
    try:
        wait_for(lambda: pool.size == 1, what="registration")
        job = sched.submit(tiny_spec())
        events = collect_events(job, timeout=120)
        assert events[-1]["type"] == "done"
        rows = [e for e in events if e["type"] == "row"]
        assert len(rows) == 1 and rows[0]["status"] == "error"
        assert rows[0]["poison"] is True
        assert sched.stats()["faults"]["scenarios_poisoned"] == 1
    finally:
        agent.stop()
        sched.close()


# ---- the real topology: server + subprocess worker hosts --------------------


def _read_addr_file(path, proc, deadline_s=120):
    deadline = time.monotonic() + deadline_s
    while not path.exists() or not path.read_text().strip():
        if proc.poll() is not None:
            pytest.fail(f"process died: {proc.stderr.read().decode()}")
        if time.monotonic() > deadline:
            proc.kill()
            pytest.fail(f"{path} never written")
        time.sleep(0.1)
    return path.read_text().strip()


def spawn_multihost_server(tmp_path, cache, *extra_args):
    port_file = tmp_path / "port"
    worker_port_file = tmp_path / "worker_port"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.serve", "--port", "0",
         "--port-file", str(port_file), "--cache", str(cache),
         "--chunk-size", "1", "--quiet", "--device", "cpu",
         "--worker-listen", "127.0.0.1:0",
         "--worker-port-file", str(worker_port_file), *extra_args],
        env=env, cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    address = _read_addr_file(port_file, proc)
    pool_address = _read_addr_file(worker_port_file, proc)
    return proc, address, pool_address


def spawn_worker_host(pool_address, name, seats=1):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.serve", "worker",
         "--connect", pool_address, "--seats", str(seats),
         "--name", name, "--quiet", "--device", "cpu"],
        env=env, cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)


@pytest.mark.slow
def test_multihost_server_two_hosts_sigkill_one(tmp_path):
    """The full topology: a server with --worker-listen, two subprocess
    worker hosts, a client campaign with trace hashes on.  One host is
    SIGKILLed mid-campaign; re-dispatch converges and the rows equal the
    reference's, the trace hashes the golden ones."""
    cache = tmp_path / "cache"
    kw = dict(accels=ACCELS, drams=("default", "hbm"))
    spec = tiny_spec(**kw)
    proc, address, pool_address = spawn_multihost_server(
        tmp_path, cache, "--worker-deadline", "60", "--trace-hashes")
    w1 = spawn_worker_host(pool_address, "w1", seats=1)
    w2 = spawn_worker_host(pool_address, "w2", seats=1)
    try:
        client = ServeClient(address)
        client.wait_ready(deadline_s=60)
        wait_for(lambda: client.stats()["workers"].get("size", 0) == 2,
                 timeout=60, what="both hosts registered")
        hosts = client.stats()["workers"]["hosts"]
        assert {h["device"] for h in hosts.values()} == {"cpu"}

        result = {}

        def run():
            result["res"] = client.run(spec)

        t = threading.Thread(target=run)
        t.start()

        # SIGKILL w1 the moment it holds a chunk (its pid is in /stats)
        def w1_busy():
            hosts = client.stats()["workers"].get("hosts", {})
            return hosts.get("w1", {}).get("busy", 0) >= 1

        wait_for(w1_busy, timeout=120, what="w1 holding a chunk")
        os.kill(w1.pid, signal.SIGKILL)

        t.join(timeout=600)
        assert not t.is_alive(), "campaign never finished"
        res = result["res"]
        assert res.outcome == "done"
        statuses = res.statuses
        assert len(statuses) == 8 and set(statuses) <= {"ok", "cached"}
        assert res.rows == ref_rows(**kw)
        golden = json.loads(TINY_GOLDEN.read_text())
        ids = [s.scenario_id for s in spec.scenarios()]
        assert {ids[e["index"]]: e["trace_hash"] for e in res.row_events} == \
            {sid: golden[sid] for sid in ids}
        stats = client.stats()
        assert stats["faults"]["workers_lost"] >= 1
        assert stats["device"] == "cpu"
        client.shutdown()
        assert proc.wait(timeout=60) == 0
        assert w2.wait(timeout=60) == 0  # clean shutdown handshake
    finally:
        for p in (w1, w2, proc):
            if p.poll() is None:
                p.kill()
