"""Chaos bench through the PyTorch port: the sweep service under a seeded
kill/hang/corrupt schedule.

The port's twin of ``benchmarks/bench_faults.py``.  Three phases against
real ``python -m repro_torch.serve`` processes, each given ``--device``
(default: the CUDA card, where every spawn worker opens its own CUDA
context and loads the kernels):

1. **Baseline** — a fault-free campaign on a fresh cache records the
   reference rows (and, in ``--tiny`` mode, checks their trace
   fingerprints against ``benchmarks/golden_hashes_tiny.json``).
2. **Chaos** — the same campaign on a fresh cache, plus an overlapping
   second client, under a deterministic
   :class:`repro_torch.distributed.faults.FaultPlan`: one worker **crash**, one
   worker **hang** past the liveness deadline, one chunk returning
   **corrupt records**, one **poison scenario** that kills every worker
   touching it, and one pre-seeded **corrupt cache record** on disk.  The
   campaign must converge: the poison scenario surfaces as a structured
   quarantined error row; every other row must be *byte-identical* to the
   baseline; the corrupted cache record must be quarantined to ``*.bad``
   and silently re-executed.
3. **Restart** — a campaign is SIGKILLed mid-flight (no drain, no
   goodbye); a restarted server must resume the job from the crash-safe
   journal, re-executing only the uncached tail, and the final rows must
   again match the baseline byte for byte.

Measured: chaos wall-clock overhead vs baseline, worker losses/respawns,
re-dispatches, poison quarantines, corrupt-record catches, and the
recovery split (cached vs re-executed) after the SIGKILL.

    PYTHONPATH=src python -m benchmarks.bench_faults_torch          # full
    PYTHONPATH=src python -m benchmarks.bench_faults_torch --tiny \
        --device cpu                                                # CI smoke

The result goes to ``results/bench_torch/BENCH_faults.json`` unless
``--out`` says otherwise.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

from repro_torch.distributed.faults import FaultPlan, FaultRule, plan_to_json
from repro_torch.graph.generators import GraphSpec
from repro_torch.serve.client import ServeClient
from repro_torch.serve.journal import JobJournal
from repro_torch.sweep.cache import ResultCache, scenario_hash
from repro_torch.sweep.spec import SweepSpec

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_hashes_tiny.json")

TINY_SPEC = SweepSpec(
    name="faults-tiny",
    accelerators=("accugraph", "foregraph", "hitgraph", "thundergp"),
    graphs=(GraphSpec("tiny", "uniform", 256, 1024, True, 1, 0),),
    problems=("bfs",),
    drams=("default", "hbm"),
)

FULL_SPEC = SweepSpec(
    name="faults-full",
    accelerators=("accugraph", "foregraph", "hitgraph", "thundergp"),
    graphs=("sd",),
    problems=("bfs", "pr"),
    drams=("default", "hbm"),
)


def canonical(row: dict) -> str:
    return json.dumps(row, sort_keys=True, separators=(",", ":"))


def start_server(tmp: str, *extra, device: str | None, workers: int = 2,
                 chunk_size: int = 1, trace_hashes: bool = False):
    """A server on ``device`` (``None``: the card, the server's default)."""
    port_file = os.path.join(tmp, "port")
    if os.path.exists(port_file):
        os.remove(port_file)  # a SIGKILLed predecessor leaves it behind
    cmd = [sys.executable, "-m", "repro_torch.serve", "--port", "0",
           "--port-file", port_file, "--cache", os.path.join(tmp, "c"),
           "--workers", str(workers), "--chunk-size", str(chunk_size),
           "--quiet", *extra]
    if device is not None:
        cmd += ["--device", device]
    if trace_hashes:
        cmd.append("--trace-hashes")
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(cmd, env=env)
    deadline = time.time() + 180
    while not os.path.exists(port_file) or not open(port_file).read().strip():
        if proc.poll() is not None:
            raise RuntimeError(f"server exited early: rc={proc.returncode}")
        if time.time() > deadline:
            proc.kill()
            raise RuntimeError("server never wrote its port file")
        time.sleep(0.1)
    address = open(port_file).read().strip()
    client = ServeClient(address)
    client.wait_ready(deadline_s=60)
    return proc, client


def stop_server(proc, client) -> int:
    client.shutdown()
    return proc.wait(timeout=120)


# ---- phase 1: fault-free baseline -------------------------------------------


def run_baseline(spec: SweepSpec, tiny: bool, device: str | None) -> dict:
    tmp = tempfile.mkdtemp(prefix="bench_faults_base_")
    proc, client = start_server(tmp, device=device, chunk_size=2,
                                trace_hashes=tiny)
    scenarios, _ = spec.expand()
    print(f"[bench_faults_torch] baseline: {len(scenarios)} scenarios, no faults")
    t0 = time.time()
    res = client.run(spec)
    wall = time.time() - t0
    assert res.outcome == "done", f"baseline ended {res.outcome!r}"
    assert res.statuses == ["ok"] * len(scenarios), res.statuses

    golden_checked = 0
    if tiny:
        golden = json.load(open(GOLDEN))
        served = {scenarios[ev["index"]].scenario_id: ev["trace_hash"]
                  for ev in res.row_events}
        mismatches = {sid: (h, golden.get(sid)) for sid, h in served.items()
                      if golden.get(sid) != h}
        assert not mismatches, f"trace hashes diverged: {mismatches}"
        golden_checked = len(served)
        print(f"  golden: {golden_checked}/{len(golden)} trace hashes match")

    stats = client.stats()
    if stats["device"].startswith("cuda"):  # timed in the workers' kernel
        assert stats["launches"]["dram_timing"] > 0, stats["launches"]
    rc = stop_server(proc, client)
    assert rc == 0, f"baseline drain exited {rc}"
    print(f"  {len(res.rows)} rows in {wall:.1f}s")
    return dict(rows=res.rows, wall_s=round(wall, 3),
                golden_checked=golden_checked, device=stats["device"],
                launches=stats["launches"])


# ---- phase 2: seeded chaos --------------------------------------------------


def chaos_plan(poison_id: str) -> FaultPlan:
    """Deterministic schedule keyed to the scheduler's dispatch counter.
    With chunk size 1 and a FIFO queue, dispatch *i* of the first round is
    expansion-scenario *i*, so the crash/hang/corrupt indices each hit a
    distinct innocent scenario while the match rule rides the poison
    scenario through every one of its (re-)dispatches."""
    return FaultPlan(seed=20260808, rules=(
        FaultRule("worker.chunk", "crash", match=poison_id),  # the poison
        FaultRule("worker.chunk", "crash", at=(1,)),
        FaultRule("worker.chunk", "hang", at=(3,)),
        FaultRule("worker.chunk", "corrupt", at=(5,)),
    ))


def run_chaos(spec: SweepSpec, baseline_rows: list[dict],
              device: str | None) -> dict:
    tmp = tempfile.mkdtemp(prefix="bench_faults_chaos_")
    scenarios, _ = spec.expand()
    poison_idx = len(scenarios) - 1
    poison_id = scenarios[poison_idx].scenario_id
    plan = chaos_plan(poison_id)

    # pre-seed a corrupted cache record at scenario 0's content address:
    # the server must quarantine it as a miss, never serve it
    cache = ResultCache(os.path.join(tmp, "c"))
    bad_path = cache.path(scenario_hash(scenarios[0]))
    os.makedirs(os.path.dirname(bad_path), exist_ok=True)
    with open(bad_path, "w") as f:
        f.write('{"sha256": "torn mid-wri')

    overlap = SweepSpec(name=spec.name + "-overlap",
                        accelerators=spec.accelerators[:2],
                        graphs=spec.graphs, problems=spec.problems,
                        drams=spec.drams)
    n_overlap = len(overlap.expand()[0])

    proc, client = start_server(
        tmp, "--worker-deadline", "3", "--poison-threshold", "2",
        "--faults", plan_to_json(plan), device=device)
    print(f"[bench_faults_torch] chaos: {len(scenarios)} scenarios + "
          f"{n_overlap} overlapping, poison={poison_id}")

    results: dict[str, object] = {}
    t0 = time.time()

    def run_client(name, s):
        results[name] = ServeClient(f"{client.host}:{client.port}").run(s)

    main_t = threading.Thread(target=run_client, args=("main", spec))
    main_t.start()
    time.sleep(0.5)  # main job queues first: dispatch i == scenario i
    over_t = threading.Thread(target=run_client, args=("overlap", overlap))
    over_t.start()
    main_t.join(timeout=1800)
    over_t.join(timeout=1800)
    wall = time.time() - t0
    res, over = results["main"], results["overlap"]

    assert res.outcome == "done", f"chaos campaign ended {res.outcome!r}"
    assert over.outcome == "done", f"overlap job ended {over.outcome!r}"

    # exactly one poison quarantine, surfaced as a structured error row
    assert res.n_poisoned == 1, f"poisoned rows: {res.n_poisoned}"
    prow = res.rows[poison_idx]
    assert prow.get("poison") is True and "quarantined" in prow["error"], prow
    assert prow["attempts"] == 2, prow

    # every other row converged byte-identically to the fault-free run
    diverged = [i for i in range(len(scenarios)) if i != poison_idx
                and canonical(res.rows[i]) != canonical(baseline_rows[i])]
    assert not diverged, f"rows diverged from baseline: {diverged}"
    assert over.n_errors == 0
    over_diverged = [i for i, row in enumerate(over.rows)
                     if canonical(row) != canonical(baseline_rows[i])]
    assert not over_diverged, f"overlap rows diverged: {over_diverged}"

    # the pre-corrupted cache record was quarantined aside and re-executed
    assert os.path.exists(bad_path + ".bad"), "corrupt record not quarantined"
    assert not os.path.exists(bad_path) or cache.get(
        scenario_hash(scenarios[0])) is not None

    stats = client.stats()
    faults = stats["faults"]
    assert faults["chunks_lost"] >= 3, faults      # >=1 crash, 1 hang, poison
    assert faults["scenarios_poisoned"] == 1, faults
    assert faults["corrupt_records"] >= 1, faults  # the mangled chunk
    assert faults["workers_lost"] >= 3, faults
    rc = stop_server(proc, client)
    assert rc == 0, f"chaos drain exited {rc}"
    print(f"  converged in {wall:.1f}s: {len(scenarios) - 1} rows identical, "
          f"1 poison row; faults={faults}")
    return dict(wall_s=round(wall, 3), poison_scenario=poison_id,
                rows_identical=len(scenarios) - 1, overlap_rows=n_overlap,
                faults=faults,
                inflight_joins=stats["counters"].get("inflight_joins", 0))


# ---- phase 3: SIGKILL + journal restart -------------------------------------


def run_restart(spec: SweepSpec, baseline_rows: list[dict],
                device: str | None) -> dict:
    tmp = tempfile.mkdtemp(prefix="bench_faults_restart_")
    scenarios, _ = spec.expand()
    proc, client = start_server(tmp, device=device, workers=1)
    print("[bench_faults_torch] restart: SIGKILL mid-campaign, then resume")

    state = dict(job_id="", rows=0)
    killed = threading.Event()

    def stream():
        try:
            for ev in client.submit(spec):
                if ev["type"] == "job":
                    state["job_id"] = ev["job_id"]
                elif ev["type"] == "row":
                    state["rows"] += 1
                    if state["rows"] >= 2 and not killed.is_set():
                        os.kill(proc.pid, signal.SIGKILL)  # no drain, no ack
                        killed.set()
        except OSError:
            pass  # the connection dies with the server

    t = threading.Thread(target=stream)
    t.start()
    t.join(timeout=600)
    assert killed.is_set(), "never reached 2 rows to kill at"
    proc.wait(timeout=60)
    jid, rows_before = state["job_id"], state["rows"]

    # the journal survived the SIGKILL with the job still open
    open_ids = [op["id"] for op in JobJournal(os.path.join(tmp, "c")
                                              ).load_open()]
    assert jid in open_ids, f"journal lost job {jid}: {open_ids}"

    proc2, client2 = start_server(tmp, device=device, workers=1)
    t0 = time.time()
    deadline = time.time() + 900
    while True:
        status = client2.job_status(jid)
        if status.get("finished"):
            break
        if time.time() > deadline:
            raise RuntimeError(f"recovered job never finished: {status}")
        time.sleep(0.25)
    recover_wall = time.time() - t0
    assert status["recovered"], status
    counts = status["counts"]
    # resumed from the journal + cache: only the unfinished tail re-executed
    assert counts.get("cached", 0) >= rows_before, (counts, rows_before)
    assert counts.get("cached", 0) + counts.get("ok", 0) == len(scenarios)
    assert counts.get("ok", 0) >= 1, counts

    # and the converged state is byte-identical to the fault-free run
    res = client2.run(spec)
    assert res.outcome == "done"
    assert res.statuses == ["cached"] * len(scenarios), res.statuses
    diverged = [i for i, row in enumerate(res.rows)
                if canonical(row) != canonical(baseline_rows[i])]
    assert not diverged, f"post-recovery rows diverged: {diverged}"
    rc = stop_server(proc2, client2)
    assert rc == 0, f"restarted server drain exited {rc}"
    print(f"  recovered {counts.get('cached', 0)} cached + "
          f"{counts.get('ok', 0)} re-executed in {recover_wall:.1f}s")
    return dict(rows_before_kill=rows_before,
                recovered_cached=counts.get("cached", 0),
                recovered_executed=counts.get("ok", 0),
                recover_wall_s=round(recover_wall, 3))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tiny", action="store_true",
                    help="CI smoke: tiny grid + golden trace hashes")
    ap.add_argument("--device", default=None,
                    help="device of every server's workers (default: the "
                         "CUDA card; cpu: the kernels' plain versions)")
    ap.add_argument("--out",
                    default=os.path.join("results", "bench_torch",
                                         "BENCH_faults.json"))
    args = ap.parse_args(argv)

    spec = TINY_SPEC if args.tiny else FULL_SPEC
    baseline = run_baseline(spec, tiny=args.tiny, device=args.device)
    chaos = run_chaos(spec, baseline["rows"], args.device)
    restart = run_restart(spec, baseline["rows"], args.device)

    result = dict(
        mode="tiny" if args.tiny else "full",
        scenarios=len(spec.expand()[0]),
        baseline=dict(wall_s=baseline["wall_s"],
                      golden_checked=baseline["golden_checked"],
                      device=baseline["device"],
                      launches=baseline["launches"]),
        chaos=chaos,
        restart=restart,
        chaos_overhead=round(chaos["wall_s"] / max(1e-9, baseline["wall_s"]),
                             3),
    )
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"[bench_faults_torch] wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
