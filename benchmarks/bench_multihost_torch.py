"""Multi-host sweep-serving bench through the PyTorch port: scale-out
throughput and chaos recovery.

The port's twin of ``benchmarks/bench_multihost.py``.  Starts a real
``python -m repro_torch.serve`` server with ``--worker-listen`` (so its
pool is a :class:`~repro_torch.distributed.remote.RemoteWorkerPool` that
executes nothing locally), then connects real ``python -m
repro_torch.serve worker`` host agents — the full multi-host topology on
one machine, every byte crossing the actual wire.  ``--device`` (default:
the CUDA card) goes to the server and to every host, whose spawn seats
each open a CUDA context of their own and load the kernels.  Measured:

- **rows/s vs host count** — the same campaign grid served by 1, 2 and 4
  worker hosts (fresh cache per point, so every row executes).  On one
  machine the curve only rises while ``hosts x seats`` fits the core
  count; past that (and always on a single-core box, which the result
  records via ``cpu_count``) it measures the wire + supervision overhead
  of scale-out, not its win — the win needs actual machines,
- **chaos variant** — the 2-host campaign with one host SIGKILLed while
  it holds a chunk: the run must still complete every row (host loss ->
  ``WorkerLost`` -> chunk re-dispatch to the survivor), and the bench
  records the recovery overhead next to the clean 2-host number.

``--tiny`` is the CI smoke: two worker hosts serve the tiny grid with
``--trace-hashes`` on, every streamed row's trace fingerprint must match
``benchmarks/golden_hashes_tiny.json`` — the same goldens the
single-host serve bench and the host bench check, which is the proof
that rows served over the multi-host wire are byte-identical to the
local path — then a resubmission must be 100% cached and the drain must
shut both hosts down cleanly (exit 0).

    PYTHONPATH=src python -m benchmarks.bench_multihost_torch          # full
    PYTHONPATH=src python -m benchmarks.bench_multihost_torch --tiny \
        --device cpu                                                   # CI smoke

The result goes to ``results/bench_torch/BENCH_multihost.json`` unless
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
import time

from repro_torch.graph.generators import GraphSpec
from repro_torch.serve.client import ServeClient
from repro_torch.sweep.spec import SweepSpec

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_hashes_tiny.json")

TINY_SPEC = SweepSpec(
    name="serve-tiny",
    accelerators=("accugraph", "foregraph", "hitgraph", "thundergp"),
    graphs=(GraphSpec("tiny", "uniform", 256, 1024, True, 1, 0),),
    problems=("bfs",),
    drams=("default", "hbm"),
)

CAMPAIGN_SPEC = SweepSpec(
    name="multihost",
    accelerators=("accugraph", "foregraph", "hitgraph", "thundergp"),
    graphs=("sd", "db"),
    problems=("bfs", "pr"),
    drams=("default", "hbm"),
)


def _env():
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    return env


def device_args(device: str | None) -> list[str]:
    """``--device`` for a child: none means the card (the child's default)."""
    return [] if device is None else ["--device", device]


def start_server(cache_dir: str, trace_hashes: bool, device: str | None,
                 chunk_size: int = 2, worker_deadline: float = 120.0):
    """Spawn the server in multi-host mode; wait for both address files."""
    port_file = os.path.join(cache_dir, "port")
    worker_port_file = os.path.join(cache_dir, "worker_port")
    cmd = [sys.executable, "-m", "repro_torch.serve", "--port", "0",
           "--port-file", port_file, "--cache", os.path.join(cache_dir, "c"),
           "--chunk-size", str(chunk_size), "--quiet",
           "--worker-listen", "127.0.0.1:0",
           "--worker-port-file", worker_port_file,
           "--worker-deadline", str(worker_deadline), *device_args(device)]
    if trace_hashes:
        cmd.append("--trace-hashes")
    proc = subprocess.Popen(cmd, env=_env())
    deadline = time.time() + 180
    for path in (port_file, worker_port_file):
        while not os.path.exists(path) or not open(path).read().strip():
            if proc.poll() is not None:
                raise RuntimeError(f"server exited early: rc={proc.returncode}")
            if time.time() > deadline:
                proc.kill()
                raise RuntimeError(f"server never wrote {path}")
            time.sleep(0.1)
    address = open(port_file).read().strip()
    pool_address = open(worker_port_file).read().strip()
    client = ServeClient(address)
    client.wait_ready(deadline_s=60)
    return proc, client, pool_address


def start_host(pool_address: str, name: str, seats: int,
               device: str | None) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.serve", "worker",
         "--connect", pool_address, "--seats", str(seats),
         "--name", name, "--quiet", *device_args(device)],
        env=_env())


def wait_hosts(client: ServeClient, n: int, deadline_s: float = 120) -> None:
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        if client.stats()["workers"].get("alive", 0) >= n:
            return
        time.sleep(0.1)
    raise RuntimeError(f"{n} worker hosts never registered")


def stop_all(proc, client, hosts) -> None:
    """Drain the server (which tells every host to shut down) and assert
    the whole topology exits cleanly."""
    client.shutdown()
    rc = proc.wait(timeout=120)
    assert rc == 0, f"server drain exited {rc}"
    for h in hosts:
        hrc = h.wait(timeout=60)
        assert hrc == 0, f"worker host exited {hrc}"


# ---- CI smoke ---------------------------------------------------------------


def run_tiny(out: str, device: str | None) -> int:
    tmp = tempfile.mkdtemp(prefix="bench_multihost_")
    proc, client, pool_address = start_server(tmp, trace_hashes=True,
                                              device=device)
    hosts = [start_host(pool_address, f"h{i}", seats=1, device=device)
             for i in range(2)]
    scenarios, _ = TINY_SPEC.expand()
    golden = json.load(open(GOLDEN))

    print(f"[bench_multihost_torch] tiny: {len(scenarios)} scenarios over 2 "
          f"worker hosts (pool at {pool_address})")
    wait_hosts(client, 2)
    t0 = time.time()
    res = client.run(TINY_SPEC)
    wall = time.time() - t0
    assert res.outcome == "done", f"job ended {res.outcome!r}"
    assert res.statuses == ["ok"] * len(scenarios), res.statuses

    served = {scenarios[ev["index"]].scenario_id: ev["trace_hash"]
              for ev in res.row_events}
    mismatches = {sid: (h, golden.get(sid))
                  for sid, h in served.items() if golden.get(sid) != h}
    assert not mismatches, f"multi-host trace hashes diverged: {mismatches}"
    print(f"  golden: {len(served)}/{len(golden)} trace hashes match "
          f"({wall:.1f}s)")

    hosts_stats = client.stats()["workers"]["hosts"]
    participating = [n for n, h in hosts_stats.items()
                     if h.get("chunks_done", 0) >= 1]
    assert len(participating) == 2, f"idle host: {hosts_stats}"
    print(f"  both hosts served chunks: "
          f"{ {n: hosts_stats[n]['chunks_done'] for n in participating} }")

    res2 = client.run(TINY_SPEC)
    assert res2.statuses == ["cached"] * len(scenarios), res2.statuses
    assert [e["trace_hash"] for e in res2.row_events] == \
        [e["trace_hash"] for e in res.row_events]
    print("  resubmit: 8/8 cached, fingerprints stable")

    # on a card the hosts' seats must have timed every row in the kernel
    stats = client.stats()
    host_devices = {n: h["device"] for n, h in hosts_stats.items()}
    if any(d.startswith("cuda") for d in host_devices.values()):
        assert stats["launches"]["dram_timing"] > 0, stats["launches"]
    print(f"  host devices {host_devices}, launches {stats['launches']}")

    stop_all(proc, client, hosts)
    print("  clean shutdown: server + both hosts exit 0")

    result = dict(
        mode="tiny",
        device=stats["device"],
        host_devices=host_devices,
        launches=stats["launches"],
        scenarios=len(scenarios),
        hosts=2,
        wall_s=round(wall, 3),
        golden_hashes_checked=len(served),
        golden_ok=True,
        both_hosts_served=True,
        resubmit_all_cached=True,
        clean_shutdown=True,
    )
    write_result(out, result)
    return 0


# ---- full: rows/s vs host count + chaos -------------------------------------


def run_campaign(n_hosts: int, seats: int, device: str | None,
                 chaos: bool = False) -> dict:
    """One fresh-cache campaign over ``n_hosts`` worker hosts.  With
    ``chaos`` a host is SIGKILLed once it holds a chunk."""
    tmp = tempfile.mkdtemp(prefix="bench_multihost_")
    proc, client, pool_address = start_server(tmp, trace_hashes=False,
                                              device=device)
    hosts = [start_host(pool_address, f"h{i}", seats=seats, device=device)
             for i in range(n_hosts)]
    victim = None
    try:
        wait_hosts(client, n_hosts)
        scenarios, _ = CAMPAIGN_SPEC.expand()
        t0 = time.time()
        if chaos:
            import threading

            victim = hosts.pop(0)  # h0
            victim_pid = victim.pid

            def assassin():
                deadline = time.time() + 120
                while time.time() < deadline:
                    h = client.stats()["workers"].get("hosts", {}).get("h0")
                    if h and h.get("busy", 0) >= 1:
                        os.kill(victim_pid, signal.SIGKILL)
                        return
                    time.sleep(0.05)

            threading.Thread(target=assassin, daemon=True).start()
        res = client.run(CAMPAIGN_SPEC)
        wall = time.time() - t0
        assert res.outcome == "done", f"job ended {res.outcome!r}"
        assert set(res.statuses) <= {"ok", "cached"}, res.statuses
        assert len(res.rows) == len(scenarios)
        stats = client.stats()
        if chaos:
            assert stats["faults"]["workers_lost"] >= 1, \
                "chaos run never observed the host loss"
        stop_all(proc, client, hosts)
        return dict(
            hosts=n_hosts, seats_per_host=seats, chaos=chaos,
            device=stats["device"], launches=stats["launches"],
            scenarios=len(scenarios),
            wall_s=round(wall, 3),
            rows_per_s=round(len(scenarios) / wall, 3),
            workers_lost=stats["faults"]["workers_lost"],
            scenarios_redispatched=stats["faults"].get(
                "scenarios_redispatched", 0),
        )
    finally:
        if victim is not None and victim.poll() is None:
            victim.kill()
        for p in hosts + [proc]:
            if p.poll() is None:
                p.kill()


def run_full(out: str, host_counts, seats: int, device: str | None) -> int:
    scenarios, _ = CAMPAIGN_SPEC.expand()
    cores = os.cpu_count() or 1
    print(f"[bench_multihost_torch] campaign: {len(scenarios)} scenarios, "
          f"host counts {list(host_counts)}, {seats} seats/host, "
          f"{cores} core(s)")
    if cores < max(host_counts) * seats:
        print(f"  note: {cores} core(s) < {max(host_counts)}x{seats} "
              "host-seats — the curve measures scale-out overhead, not "
              "speedup (run hosts on separate machines for the win)")
    scaling = []
    for n in host_counts:
        point = run_campaign(n, seats, device)
        scaling.append(point)
        print(f"  {n} host(s): {point['rows_per_s']} rows/s "
              f"({point['wall_s']}s)")

    print("  chaos: 2 hosts, h0 SIGKILLed mid-chunk")
    chaos = run_campaign(2, seats, device, chaos=True)
    print(f"  chaos 2->1 hosts: {chaos['rows_per_s']} rows/s "
          f"({chaos['wall_s']}s), {chaos['workers_lost']} host(s) lost, "
          f"{chaos['scenarios_redispatched']} scenarios re-dispatched")

    base = scaling[0]["rows_per_s"]
    result = dict(
        mode="full",
        workload=dict(scenarios=len(scenarios), seats_per_host=seats,
                      cpu_count=cores),
        scaling=scaling,
        speedup={str(p["hosts"]): round(p["rows_per_s"] / base, 3)
                 for p in scaling},
        chaos=chaos,
    )
    write_result(out, result)
    return 0


def write_result(out: str, result: dict) -> None:
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"  wrote {out}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tiny", action="store_true",
                    help="CI smoke: 2 hosts, golden trace hashes, clean "
                         "drain")
    ap.add_argument("--hosts", default="1,2,4",
                    help="comma-separated host counts for the scaling curve")
    ap.add_argument("--seats", type=int, default=1,
                    help="worker seats per host")
    ap.add_argument("--device", default=None,
                    help="device of the server and every host (default: "
                         "the CUDA card; cpu: the kernels' plain versions)")
    ap.add_argument("--out",
                    default=os.path.join("results", "bench_torch",
                                         "BENCH_multihost.json"))
    args = ap.parse_args(argv)
    if args.tiny:
        return run_tiny(args.out, args.device)
    counts = [int(c) for c in args.hosts.split(",") if c.strip()]
    return run_full(args.out, counts, args.seats, args.device)


if __name__ == "__main__":
    raise SystemExit(main())
