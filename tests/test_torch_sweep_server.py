"""The port's sweep server (``repro_torch.serve``) against the reference's
(``repro.serve``): wire round-trips (the ``device`` engine axis included),
scheduler dedup, in-flight join, cancel and drain, an HTTP server that
submits, streams and shuts down, the CLI (``--device``, the multi-host
refusals), SIGTERM drain and resume of a ``python -m repro_torch.serve``
process, and served rows equal to the reference's ``run_sweep`` rows and
to the tiny golden trace hashes.  Everything runs on the CPU
(``device="cpu"``); ``tests/test_torch_serve.py`` holds the LM serving path.

Tolerance: exact equality of rows (``wall_s`` is no row column).
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time
from concurrent.futures import Future
from pathlib import Path

import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

import repro.serve.protocol as ref_protocol  # noqa: E402
import repro.sweep as ref_sweep  # noqa: E402
import repro.sweep.__main__ as ref_cli  # noqa: E402
import repro_torch.serve.__main__ as serve_cli  # noqa: E402
import repro_torch.sweep as sweep  # noqa: E402
import repro_torch.sweep.__main__ as sweep_cli  # noqa: E402
from repro.graph.generators import GraphSpec as RefGraphSpec  # noqa: E402
from repro_torch.core.dram import AddressMapping  # noqa: E402
from repro_torch.distributed.faults import FaultAction, FaultPlan, FaultRule  # noqa: E402
from repro_torch.graph.generators import GraphSpec  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    TERMINAL_EVENTS,
    ProtocolError,
    ServeClient,
    ServeError,
    SweepScheduler,
    SweepServer,
    dump_event,
    parse_event,
    protocol,
    spec_from_wire,
    spec_to_wire,
)
from repro_torch.sweep import ExecutionPolicy, SweepSpec  # noqa: E402
from repro_torch.sweep.cache import scenario_hash  # noqa: E402
from repro_torch.sweep.results import result_rows  # noqa: E402
from repro_torch.sweep.runner import run_sweep  # noqa: E402
from repro_torch.sweep.spec import ConfigOverride  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
TINY_GOLDEN = ROOT / "benchmarks" / "golden_hashes_tiny.json"
TINY_ARGS = ("tiny", "uniform", 256, 1024, True, 1, 0)
TINY = GraphSpec(*TINY_ARGS)
ACCELS = ("accugraph", "foregraph", "hitgraph", "thundergp")


def tiny_spec(accels=("accugraph",), problems=("bfs",), graphs=(TINY,),
              drams=("default",), **kw):
    return SweepSpec(name="t", accelerators=tuple(accels), graphs=tuple(graphs),
                     problems=tuple(problems), drams=tuple(drams), **kw)


def ref_rows(accels=("accugraph",), problems=("bfs",), drams=("default",), **kw):
    """The reference's ``run_sweep`` rows of the same tiny spec."""
    spec = ref_sweep.SweepSpec(name="t", accelerators=tuple(accels),
                               graphs=(RefGraphSpec(*TINY_ARGS),), problems=tuple(problems),
                               drams=tuple(drams), **kw)
    return ref_sweep.result_rows(ref_sweep.run_sweep(spec))


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


def rows_by_index(events) -> list[dict]:
    return [e["row"] for e in sorted((e for e in events if e["type"] == "row"),
                                     key=lambda e: e["index"])]


class GatedPool:
    """In-process stand-in for WorkerPool: runs chunks in threads (real
    execution, this process), each gated on a per-chunk Event when gates
    are provided — makes in-flight overlap deterministic in tests."""

    def __init__(self, size=1, gates=None):
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


def wait_for(cond, timeout=30.0, what="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.02)
    pytest.fail(f"timed out waiting for {what}")


# ---- wire protocol ----------------------------------------------------------


def rich_spec(side_sweep, graph, mapping):
    return side_sweep.SweepSpec(
        name="rich", accelerators=("accugraph", "hitgraph"), graphs=(graph, "sd"),
        problems=("bfs", "pr"), drams=("default", ("hbm", 4)),
        mappings=("row", "bank_xor@32", mapping), page_policies=("open", "closed"),
        pseudo_channels=(False, True),
        overrides=(side_sweep.ConfigOverride(engine="scan"),
                   side_sweep.ConfigOverride(label="none", optimizations=frozenset())),
        reorders=("identity", "degree"), interval_scales=(1, 2),
        engines=("numpy", "device"))


def test_spec_wire_roundtrip_equals_reference():
    from repro.core.dram import AddressMapping as RefAddressMapping

    spec = rich_spec(sweep, TINY, AddressMapping("bank", 16))
    wire = spec_to_wire(spec)
    back = spec_from_wire(json.loads(json.dumps(wire)))
    # mappings normalize to their label token; the expansion is identical
    assert back == dataclasses.replace(spec, mappings=("row", "bank_xor@32", "bank@16"))
    assert back.expand() == spec.expand()
    assert [scenario_hash(s) for s in back.scenarios()] == \
        [scenario_hash(s) for s in spec.scenarios()]
    ref_wire = ref_protocol.spec_to_wire(rich_spec(
        ref_sweep, RefGraphSpec(*TINY_ARGS), RefAddressMapping("bank", 16)))
    assert json.dumps(wire, sort_keys=True) == json.dumps(ref_wire, sort_keys=True)


def test_scenario_policy_and_chunk_wire_roundtrip():
    spec = rich_spec(sweep, TINY, AddressMapping("bank", 16))
    scenarios = spec.scenarios()[::7]
    assert any(s.config.semexec == "device" for s in scenarios)
    for s in scenarios:
        back = protocol.scenario_from_wire(json.loads(json.dumps(protocol.scenario_to_wire(s))))
        assert back == s and scenario_hash(back) == scenario_hash(s)
    plan = FaultPlan(seed=3, rules=(FaultRule("scenario", "error", at=(0, 2)),))
    policy = ExecutionPolicy(timeout_s=2.5, retries=2, backoff_s=0.1, fault_plan=plan)
    assert protocol.policy_from_wire(protocol.policy_to_wire(policy)) == policy
    assert protocol.policy_from_wire(protocol.policy_to_wire(None)) is None
    action = FaultAction("worker.chunk", "delay", delay_s=0.2)
    wire = json.loads(json.dumps(protocol.chunk_to_wire(7, scenarios, "batch", policy,
                                                        True, action)))
    assert protocol.chunk_from_wire(wire) == (7, scenarios, "batch", policy, True, action)
    with pytest.raises(ProtocolError):
        protocol.chunk_from_wire(dict(chunk=1))


def test_spec_wire_rejects_unknown_fields():
    wire = spec_to_wire(tiny_spec())
    wire["warp_speed"] = True
    with pytest.raises(ProtocolError, match="warp_speed"):
        spec_from_wire(wire)


def test_event_framing_roundtrip():
    ev = dict(type="row", job_id="job-000001", index=3, status="ok",
              row=dict(graph="tiny", cycles=123), done=4, total=8)
    line = dump_event(ev)
    assert line.endswith(b"\n") and b"\n" not in line[:-1]
    assert parse_event(line) == ev and line == ref_protocol.dump_event(ev)
    with pytest.raises(ProtocolError):
        parse_event(b"not json\n")


# ---- scheduler: dedup, in-flight join, cancel, drain ------------------------


def scheduler(tmp_path, pool, **kw):
    kw.setdefault("chunk_size", 1)
    kw.setdefault("device", "cpu")
    return SweepScheduler(cache_dir=str(tmp_path / "cache"), pool_factory=lambda: pool, **kw)


def test_scheduler_executes_and_caches(tmp_path):
    sched = scheduler(tmp_path, GatedPool())
    try:
        events = collect_events(sched.submit(tiny_spec()))
        assert [e["type"] for e in events] == ["job", "row", "done"]
        assert events[1]["status"] == "ok" and [events[1]["row"]] == ref_rows()
        events2 = collect_events(sched.submit(tiny_spec()))
        assert events2[1]["status"] == "cached" and events2[1]["row"] == events[1]["row"]
        stats = sched.stats()
        assert stats["counters"]["executed_ok"] == 1
        assert stats["counters"]["cache_hits"] == 1
        assert stats["device"] == "cpu"
    finally:
        sched.close()


def test_scheduler_inflight_join_across_jobs(tmp_path):
    gate = threading.Event()
    pool = GatedPool(gates=[gate])
    sched = scheduler(tmp_path, pool)
    try:
        job_a = sched.submit(tiny_spec())
        wait_for(lambda: len(pool.chunks) == 1, what="chunk dispatch")
        job_b = sched.submit(tiny_spec())  # identical, mid-flight: joins
        assert sched.metrics.get("inflight_joins") == 1
        gate.set()
        ev_a, ev_b = collect_events(job_a), collect_events(job_b)
        assert ev_a[1]["status"] == "ok" and ev_b[1]["status"] == "ok"
        assert ev_a[1]["row"] == ev_b[1]["row"]
        assert sum(len(c) for c in pool.chunks) == 1
        assert sched.stats()["counters"]["executed_ok"] == 1
    finally:
        sched.close()


def test_scheduler_dedups_within_one_submission(tmp_path):
    pool = GatedPool()
    sched = scheduler(tmp_path, pool)
    try:
        events = collect_events(sched.submit(tiny_spec(graphs=(TINY, TINY))))
        rows = [e for e in events if e["type"] == "row"]
        assert len(rows) == 2 and rows[0]["row"] == rows[1]["row"]
        assert sum(len(c) for c in pool.chunks) == 1
        assert sched.metrics.get("dedup_joins") == 1
    finally:
        sched.close()


def test_scheduler_cancel_drops_queued_work(tmp_path):
    gate = threading.Event()
    pool = GatedPool(size=1, gates=[gate, gate])  # two gated chunks in flight
    sched = scheduler(tmp_path, pool, mode="scenario")
    try:
        job = sched.submit(tiny_spec(accels=ACCELS))
        wait_for(lambda: len(pool.chunks) == 2, what="two gated dispatches")
        assert sched.cancel(job.id)
        assert not sched.cancel(job.id)
        assert collect_events(job)[-1]["type"] == "cancelled"
        gate.set()
        wait_for(lambda: sched.stats()["queue"]["inflight_chunks"] == 0,
                 what="inflight to settle")
        assert sched.stats()["counters"]["scenarios_cancelled"] == 2
        assert sum(len(c) for c in pool.chunks) == 2
    finally:
        sched.close()


def test_scheduler_drain_persists_completed_and_resumes(tmp_path):
    gate = threading.Event()
    pool = GatedPool(size=1, gates=[gate, gate])
    sched = scheduler(tmp_path, pool, mode="scenario")
    job = sched.submit(tiny_spec(accels=ACCELS))
    wait_for(lambda: len(pool.chunks) == 2, what="two gated dispatches")
    sched.drain()  # releases the gate: running chunks finish and persist
    events = collect_events(job, timeout=10)
    assert events[-1]["type"] == "interrupted" and events[-1]["completed"] == 2
    assert sched.stats()["draining"]
    with pytest.raises(RuntimeError):
        sched.submit(tiny_spec())
    sched2 = scheduler(tmp_path, GatedPool(), mode="scenario", resume=False)
    try:
        events2 = collect_events(sched2.submit(tiny_spec(accels=ACCELS)))
        assert events2[-1]["type"] == "done"
        statuses = [e["status"] for e in events2 if e["type"] == "row"]
        assert statuses.count("cached") == 2 and statuses.count("ok") == 2
        assert rows_by_index(events2) == ref_rows(accels=ACCELS)
    finally:
        sched2.close()


def test_scheduler_errors_not_cached(tmp_path):
    broken = GraphSpec("broken", "no-such-generator", 64, 128, True, 1, 0)
    sched = scheduler(tmp_path, GatedPool())
    try:
        events = collect_events(sched.submit(tiny_spec(graphs=(broken,))))
        assert events[1]["status"] == "error" and "error" in events[1]["row"]
        assert collect_events(sched.submit(tiny_spec(graphs=(broken,))))[1]["status"] == \
            "error"
        assert sched.stats()["counters"]["executed_error"] == 2
        assert sched.stats()["counters"].get("cache_hits", 0) == 0
    finally:
        sched.close()


@pytest.mark.parametrize("mode", ["scenario", "batch"])
def test_served_rows_equal_reference_and_tiny_golden_hashes(tmp_path, mode):
    """The 8 tiny golden scenarios through the scheduler with trace hashes
    on: every row equals the reference's ``run_sweep`` row and every
    ``trace_hash`` the golden one."""
    golden = json.loads(TINY_GOLDEN.read_text())
    spec = tiny_spec(accels=ACCELS, drams=("default", "hbm"))
    sched = scheduler(tmp_path, GatedPool(size=2), chunk_size=3, mode=mode,
                      trace_hashes=True)
    try:
        events = collect_events(sched.submit(spec))
    finally:
        sched.close()
    assert events[-1]["type"] == "done"
    assert rows_by_index(events) == ref_rows(accels=ACCELS, drams=("default", "hbm"))
    ids = [s.scenario_id for s in spec.scenarios()]
    hashes = {ids[e["index"]]: e["trace_hash"] for e in events if e["type"] == "row"}
    assert hashes == {sid: golden[sid] for sid in ids}


def test_served_engine_axis_rows_equal_reference(tmp_path):
    kw = dict(accels=ACCELS, problems=("bfs", "pr", "wcc"), engines=("numpy", "device"))
    sched = scheduler(tmp_path, GatedPool(size=2), chunk_size=4, mode="batch")
    try:
        events = collect_events(sched.submit(tiny_spec(**kw)))
    finally:
        sched.close()
    assert rows_by_index(events) == ref_rows(**kw)
    assert {r["engine"] for r in rows_by_index(events)} == {"numpy", "device"}


# ---- HTTP server lifecycle --------------------------------------------------


def test_server_submit_stream_stats_shutdown(tmp_path):
    from repro_torch.core.engine import ENGINE_VERSION

    server = SweepServer(port=0, cache_dir=str(tmp_path / "cache"), chunk_size=2,
                         quiet=True, pool_factory=lambda: GatedPool(size=2),
                         device="cpu").start()
    try:
        client = ServeClient(server.address)
        assert client.wait_ready()["status"] == "ok"
        spec = tiny_spec(accels=("accugraph", "hitgraph"))
        res = client.run(spec)
        assert res.outcome == "done" and res.statuses == ["ok", "ok"]
        assert res.rows == ref_rows(accels=("accugraph", "hitgraph"))
        res2 = client.run(spec)
        assert res2.statuses == ["cached", "cached"] and res2.rows == res.rows
        stats = client.stats()
        assert stats["counters"]["executed_ok"] == 2
        assert stats["counters"]["cache_hits"] == 2
        assert stats["jobs"]["completed"] == 2 and "row_s" in stats["latency"]
        assert stats["engine_version"] == ENGINE_VERSION and stats["device"] == "cpu"
        # on the CPU the plain versions launch no kernel
        assert stats["launches"] == dict(dram_timing=0, edge_update=0, spmv=0, attention=0,
                                         attention_bwd=0, ssm_scan=0)
        status = client.job_status(res.job_id)
        assert status["finished"] and status["done"] == 2
        client.shutdown()
        server.wait()
    finally:
        server.close()


def test_server_concurrent_overlap_shares_work(tmp_path):
    hold = threading.Event()
    pool = GatedPool(size=1, gates=[hold, hold, hold])
    server = SweepServer(port=0, cache_dir=str(tmp_path / "cache"), chunk_size=1,
                         quiet=True, pool_factory=lambda: pool, device="cpu").start()
    try:
        client = ServeClient(server.address)
        client.wait_ready()
        results = {}

        def run(name, spec):
            results[name] = ServeClient(server.address).run(spec)

        ta = threading.Thread(target=run, args=("a", tiny_spec(accels=("accugraph",
                                                                       "hitgraph"))))
        ta.start()
        wait_for(lambda: client.stats()["jobs"]["submitted"] >= 1, what="job A")
        tb = threading.Thread(target=run, args=("b", tiny_spec(accels=("hitgraph",
                                                                       "thundergp"))))
        tb.start()
        wait_for(lambda: client.stats()["jobs"]["submitted"] >= 2, what="job B")
        hold.set()
        ta.join(timeout=120)
        tb.join(timeout=120)
        assert not ta.is_alive() and not tb.is_alive()
        assert results["a"].rows == ref_rows(accels=("accugraph", "hitgraph"))
        assert results["b"].rows == ref_rows(accels=("hitgraph", "thundergp"))
        stats = client.stats()
        assert stats["counters"]["inflight_joins"] == 1
        assert stats["counters"]["executed_ok"] == 3
        assert sum(len(c) for c in pool.chunks) == 3
        client.shutdown()
        server.wait()
    finally:
        server.close()


def test_server_rejects_bad_spec(tmp_path):
    server = SweepServer(port=0, cache_dir=str(tmp_path / "cache"), quiet=True,
                         pool_factory=lambda: GatedPool(), device="cpu").start()
    try:
        client = ServeClient(server.address)
        client.wait_ready()
        with pytest.raises(ServeError, match="unknown accelerator"):
            client.run(tiny_spec(accels=("warpdrive",)))
        with pytest.raises(ServeError):
            client.job_status("job-999999")
    finally:
        server.close()


# ---- the CLI ----------------------------------------------------------------

AXES = ["--accels", "accugraph,hitgraph", "--graphs", "sd", "--problems", "bfs",
        "--drams", "default"]


def test_server_rows_byte_identical_to_cli(tmp_path):
    """A served sweep writes the same bytes as ``python -m repro_torch.sweep``
    and as the reference's ``python -m repro.sweep`` for the same spec."""
    assert ref_cli.main(AXES + ["--cache", str(tmp_path / "rc"),
                                "--out", str(tmp_path / "ref")]) == 0
    assert sweep_cli.main(AXES + ["--device", "cpu", "--cache", str(tmp_path / "cc"),
                                  "--out", str(tmp_path / "cli")]) == 0
    server = SweepServer(port=0, cache_dir=str(tmp_path / "srv_cache"), chunk_size=1,
                         quiet=True, pool_factory=lambda: GatedPool(),
                         device="cpu").start()
    try:
        assert serve_cli.main(["--submit", "--address", server.address,
                               "--out", str(tmp_path / "srv")] + AXES) == 0
    finally:
        server.close()
    for ext in ("csv", "json"):
        srv = (tmp_path / "srv" / f"sweep.{ext}").read_bytes()
        assert srv == (tmp_path / "cli" / f"sweep.{ext}").read_bytes()
        assert srv == (tmp_path / "ref" / f"sweep.{ext}").read_bytes()


def test_cli_search_client_writes_the_probes(tmp_path, capsys):
    server = SweepServer(port=0, cache_dir=str(tmp_path / "cache"), chunk_size=2,
                         quiet=True, pool_factory=lambda: GatedPool(size=2),
                         device="cpu").start()
    try:
        argv = ["--search", "--address", server.address, "--out", str(tmp_path / "o"),
                "--budget", "2", "--batch", "1"] + AXES
        assert serve_cli.main(argv) == 0
        out = capsys.readouterr().out
        assert "2 executed (+0 cached, +0 warm) of 2 candidates" in out
        report = json.loads((tmp_path / "o" / "sweep_search.json").read_text())
        assert report["executed"] == 2 and report["best"] is not None
        assert (tmp_path / "o" / "sweep_probes.csv").exists()
    finally:
        server.close()


@pytest.mark.parametrize("argv, says", [
    (["--worker-listen", "127.0.0.1:0"], "no CUDA device"),
    (["--worker-listen", "no-port", "--device", "cpu"], "bad address 'no-port'"),
    (["worker", "--connect", "127.0.0.1:8732", "--seats", "2"], "no CUDA device"),
    (["worker"], "required: --connect"),
])
def test_multihost_serving_exits_2_and_names_the_slice(argv, says, capsys, monkeypatch):
    """The multi-host surface's refusals: a server or worker host without
    its card, a bad listen address and a host with nowhere to connect
    print ``error: ...`` and exit 2, starting nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        rc = serve_cli.main(argv)
    except SystemExit as e:  # argparse's own usage error
        rc = e.code
    assert rc == 2
    err = capsys.readouterr().err
    assert "error: " in err and says in err
    if argv[0] != "worker":
        assert err.startswith("error: ")


def test_server_without_its_device_exits_2(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--device", "cuda"]):
        assert serve_cli.main(["--port", "0", "--cache", str(tmp_path / "c")] + extra) == 2
        assert "error: " in capsys.readouterr().err
    assert not (tmp_path / "c").exists()  # nothing started, nothing journaled
    with pytest.raises(RuntimeError, match="CUDA"):
        SweepServer(port=0, cache_dir=None, pool_factory=GatedPool)
    with pytest.raises(RuntimeError, match="CUDA"):
        SweepScheduler(cache_dir=None, pool_factory=GatedPool)


# ---- the whole process: spawn workers, SIGTERM drain, resume -----------------


def spawn_server(tmp_path, cache, *extra_args):
    port_file = tmp_path / "port"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.serve", "--port", "0", "--port-file",
         str(port_file), "--cache", str(cache), "--workers", "1", "--chunk-size", "1",
         "--device", "cpu", "--quiet", *extra_args],
        env=env, cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    deadline = time.time() + 120
    while not port_file.exists() or not port_file.read_text().strip():
        if proc.poll() is not None:
            pytest.fail(f"server died: {proc.stderr.read().decode()}")
        if time.time() > deadline:
            proc.kill()
            pytest.fail("server never wrote its port file")
        time.sleep(0.1)
    address = port_file.read_text().strip()
    port_file.unlink()
    return proc, address


def test_sigterm_drains_and_resume_completes(tmp_path):
    """SIGTERM mid-job: the server drains (exit 0), completed rows are in
    the cache, and a re-submission to a new server resumes from them; the
    rows equal the reference's."""
    cache = tmp_path / "cache"
    kw = dict(accels=ACCELS, drams=("default", "hbm"))  # 8 scenarios, chunk 1
    spec = tiny_spec(**kw)
    proc, address = spawn_server(tmp_path, cache)
    try:
        client = ServeClient(address)
        client.wait_ready(deadline_s=60)
        events = []
        fired = threading.Event()

        def stream():
            for ev in client.submit(spec):
                events.append(ev)
                if ev["type"] == "row" and not fired.is_set():
                    os.kill(proc.pid, signal.SIGTERM)  # mid-job, >= 1 row done
                    fired.set()

        t = threading.Thread(target=stream)
        t.start()
        t.join(timeout=180)
        assert not t.is_alive(), "stream never terminated after SIGTERM"
        assert proc.wait(timeout=60) == 0, "drain must exit cleanly"
    finally:
        if proc.poll() is None:
            proc.kill()
    assert events[-1]["type"] == "interrupted"
    done_first = events[-1]["completed"]
    assert 1 <= done_first < 8
    assert sum(e["type"] == "row" for e in events) == done_first

    proc2, address2 = spawn_server(tmp_path, cache, "--no-resume")
    try:
        client2 = ServeClient(address2)
        client2.wait_ready(deadline_s=60)
        res = client2.run(spec)
        assert res.outcome == "done" and len(res.rows) == 8
        assert res.statuses.count("cached") == done_first
        assert res.statuses.count("ok") == 8 - done_first
        assert res.rows == ref_rows(**kw)
        client2.shutdown()
        assert proc2.wait(timeout=60) == 0
    finally:
        if proc2.poll() is None:
            proc2.kill()


def test_journal_resume_after_sigterm_with_a_hung_worker(tmp_path):
    """SIGTERM while a fault-injected worker hangs: the stream ends
    ``interrupted`` (the drain bounded by the liveness deadline), the
    journal survives, and a restarted server resumes the job by itself to
    the rows of a fault-free run."""
    from repro_torch.serve.journal import JobJournal

    cache = tmp_path / "cache"
    spec = tiny_spec(accels=("accugraph", "foregraph"), drams=("default", "hbm"))
    plan = json.dumps(dict(seed=0, rules=[dict(site="worker.chunk", kind="hang", at=[0])]))
    proc, address = spawn_server(tmp_path, cache, "--worker-deadline", "3", "--faults", plan)
    try:
        client = ServeClient(address)
        client.wait_ready(deadline_s=60)
        events = []
        job_seen = threading.Event()

        def stream():
            for ev in client.submit(spec):
                events.append(ev)
                if ev["type"] == "job":
                    job_seen.set()

        t = threading.Thread(target=stream)
        t.start()
        assert job_seen.wait(timeout=60), "no job header"
        wait_for(lambda: client.stats()["counters"].get("faults_injected", 0) >= 1,
                 timeout=60, what="injected hang")
        os.kill(proc.pid, signal.SIGTERM)
        t.join(timeout=120)
        assert not t.is_alive(), "stream never terminated"
        assert proc.wait(timeout=60) == 0, "drain must exit cleanly"
    finally:
        if proc.poll() is None:
            proc.kill()
    assert events[-1]["type"] == "interrupted"
    jid = events[0]["job_id"]
    assert [op["id"] for op in JobJournal(cache).load_open()] == [jid]

    proc2, address2 = spawn_server(tmp_path, cache)
    try:
        client2 = ServeClient(address2)
        client2.wait_ready(deadline_s=60)

        def recovered_finished():
            try:
                return client2.job_status(jid).get("finished")
            except ServeError:
                return False

        wait_for(recovered_finished, timeout=180, what="journal-recovered job finishing")
        status = client2.job_status(jid)
        assert status["recovered"] and status["done"] == status["total"] == 4
        res = client2.run(spec)
        assert res.statuses == ["cached"] * 4
        assert res.rows == result_rows(run_sweep(spec, mode="scenario", device="cpu"))
        client2.shutdown()
        assert proc2.wait(timeout=60) == 0
    finally:
        if proc2.poll() is None:
            proc2.kill()


def test_override_axis_is_served(tmp_path):
    """Config overrides ride the wire and the scheduler like every axis."""
    kw = dict(accels=("hitgraph",), overrides=(
        ConfigOverride(), ConfigOverride(label="none", optimizations=frozenset())))
    sched = scheduler(tmp_path, GatedPool())
    try:
        events = collect_events(sched.submit(tiny_spec(**kw)))
    finally:
        sched.close()
    ref_kw = dict(accels=("hitgraph",), overrides=(
        ref_sweep.ConfigOverride(),
        ref_sweep.ConfigOverride(label="none", optimizations=frozenset())))
    assert rows_by_index(events) == ref_rows(**ref_kw)
