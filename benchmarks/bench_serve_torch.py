"""Sweep-server bench through the PyTorch port: throughput, row latency and
work-collapse rate.

The port's twin of ``benchmarks/bench_serve.py``.  Starts a real
``python -m repro_torch.serve`` server process (``--device`` passed on;
without it the server and its spawn workers take the CUDA card, each
worker timing its rows with ``csrc/dram_timing.cu``), then drives it the
way a sweep campaign does: several concurrent clients submitting
*overlapping* scenario grids (adjacent sweeps share most of their axis
product).  The server must collapse that overlap three ways: on-disk
cache hits, in-flight joins across clients, and duplicate collapse within
a submission.  Measured:

- **jobs/s** and **rows/s** over the whole campaign,
- **p50/p95 row latency** (submit-to-row, from the server's ``/stats``
  histograms),
- **collapse rate**: the fraction of submitted scenarios that never hit a
  worker because the cache, an in-flight entry or an intra-job dedup
  already covered them,
- worker host-cache warmth across jobs, and the workers' kernel launches
  (``/stats["launches"]``; on the card the campaign must launch B1).

``--tiny`` is the CI smoke: one tiny job with ``--trace-hashes`` on; every
streamed row's trace fingerprint must match
``benchmarks/golden_hashes_tiny.json``, a resubmission must be 100%
cached, and the server must drain cleanly.  The result, with the device
and the card's name and power limit, goes to
``results/bench_torch/BENCH_serve.json`` unless ``--out`` says otherwise.

    PYTHONPATH=src python -m benchmarks.bench_serve_torch                 # full campaign, the card
    PYTHONPATH=src python -m benchmarks.bench_serve_torch --tiny --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

from benchmarks.torch_common import card, device_or_exit

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_hashes_tiny.json")


def tiny_spec():
    from repro_torch.graph.generators import GraphSpec
    from repro_torch.sweep.spec import SweepSpec

    return SweepSpec(
        name="serve-tiny",
        accelerators=("accugraph", "foregraph", "hitgraph", "thundergp"),
        graphs=(GraphSpec("tiny", "uniform", 256, 1024, True, 1, 0),),
        problems=("bfs",),
        drams=("default", "hbm"),
    )


def start_server(cache_dir: str, workers: int, trace_hashes: bool, device: str | None,
                 chunk_size: int = 2):
    """Spawn ``python -m repro_torch.serve`` and wait for its port file."""
    from repro_torch.serve.client import ServeClient

    port_file = os.path.join(cache_dir, "port")
    cmd = [sys.executable, "-m", "repro_torch.serve", "--port", "0",
           "--port-file", port_file, "--cache", os.path.join(cache_dir, "c"),
           "--workers", str(workers), "--chunk-size", str(chunk_size), "--quiet"]
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
    client = ServeClient(open(port_file).read().strip())
    client.wait_ready(deadline_s=60)
    return proc, client


def stop_server(proc, client) -> int:
    client.shutdown()
    return proc.wait(timeout=120)


def _write(out: str, result: dict) -> None:
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"  wrote {out}")


# ---- CI smoke ---------------------------------------------------------------


def run_tiny(out: str, device: str | None, dev) -> int:
    spec = tiny_spec()
    with tempfile.TemporaryDirectory(prefix="bench_serve_torch_") as tmp:
        proc, client = start_server(tmp, workers=2, trace_hashes=True, device=device)
        try:
            scenarios, _ = spec.expand()
            golden = json.load(open(GOLDEN))
            print(f"[bench_serve_torch] tiny: {len(scenarios)} scenarios -> "
                  f"http://{client.host}:{client.port}")
            t0 = time.perf_counter()
            res = client.run(spec)
            wall = time.perf_counter() - t0
            assert res.outcome == "done", f"job ended {res.outcome!r}"
            assert res.statuses == ["ok"] * len(scenarios), res.statuses

            served = {scenarios[ev["index"]].scenario_id: ev["trace_hash"]
                      for ev in res.row_events}
            mismatches = {sid: (h, golden.get(sid))
                          for sid, h in served.items() if golden.get(sid) != h}
            assert not mismatches, f"served trace hashes diverged: {mismatches}"
            print(f"  golden: {len(served)}/{len(golden)} trace hashes match ({wall:.1f}s)")

            res2 = client.run(spec)
            assert res2.statuses == ["cached"] * len(scenarios), res2.statuses
            assert [e["trace_hash"] for e in res2.row_events] == \
                [e["trace_hash"] for e in res.row_events]
            print("  resubmit: 8/8 cached, fingerprints stable")

            stats = client.stats()
            if dev.type == "cuda":
                assert stats["launches"]["dram_timing"] > 0, stats["launches"]
            rc = stop_server(proc, client)
        finally:
            if proc.poll() is None:
                proc.kill()
    assert rc == 0, f"server drain exited {rc}"
    print(f"  launches {stats['launches']}; clean shutdown (exit 0)")

    _write(out, dict(
        mode="tiny",
        device=stats["device"],
        card=card(dev),
        launches=stats["launches"],
        scenarios=len(scenarios),
        wall_s=wall,
        golden_hashes_checked=len(served),
        golden_ok=True,
        resubmit_all_cached=True,
        clean_shutdown=True,
        counters=stats["counters"],
    ))
    return 0


# ---- full campaign ----------------------------------------------------------


def campaign_specs() -> list:
    """Overlapping sweeps the way a study submits them: each job varies one
    axis of a base grid, so consecutive jobs share most scenarios."""
    from repro_torch.sweep.spec import SweepSpec

    base = dict(graphs=("sd", "db"), problems=("bfs",), drams=("default",))
    four = ("accugraph", "hitgraph", "thundergp", "foregraph")
    return [
        SweepSpec(name="base", accelerators=("accugraph", "hitgraph"), **base),
        # same grid again from a second client (pure overlap)
        SweepSpec(name="again", accelerators=("accugraph", "hitgraph"), **base),
        # widen the accelerator axis (half overlap)
        SweepSpec(name="accels", accelerators=four, **base),
        # add a problem (half overlap with the widened grid)
        SweepSpec(name="problems", accelerators=four, graphs=("sd", "db"),
                  problems=("bfs", "pr"), drams=("default",)),
        # swing the memory axis (overlaps on the default-DRAM half)
        SweepSpec(name="drams", accelerators=four, graphs=("sd", "db"),
                  problems=("bfs", "pr"), drams=("default", "hbm")),
    ]


def run_full(out: str, workers: int, device: str | None, dev) -> int:
    from repro_torch.serve.client import ServeClient

    specs = campaign_specs()
    n_submitted = sum(len(s.expand()[0]) for s in specs)
    uniq = {scn.scenario_id for s in specs for scn in s.expand()[0]}
    with tempfile.TemporaryDirectory(prefix="bench_serve_torch_") as tmp:
        proc, client = start_server(tmp, workers=workers, trace_hashes=False, device=device,
                                    chunk_size=4)
        try:
            print(f"[bench_serve_torch] campaign: {len(specs)} jobs, {n_submitted} scenario "
                  f"submissions over {len(uniq)} unique scenarios, {workers} workers")
            results = {}

            def submit(spec):
                results[spec.name] = ServeClient(f"{client.host}:{client.port}").run(spec)

            # the first two jobs race each other (in-flight joins); the rest
            # arrive staggered as an interactive study submits them
            threads = [threading.Thread(target=submit, args=(s,)) for s in specs]
            t0 = time.perf_counter()
            threads[0].start()
            threads[1].start()
            for t in threads[2:]:
                time.sleep(0.3)
                t.start()
            for t in threads:
                t.join(timeout=1800)
            wall = time.perf_counter() - t0
            assert not any(t.is_alive() for t in threads), "a campaign client never finished"

            bad = {name: r.outcome for name, r in results.items()
                   if r.outcome != "done" or r.n_errors}
            assert not bad, f"campaign jobs failed: {bad}"
            rows_total = sum(len(r.rows) for r in results.values())
            stats = client.stats()
            rc = stop_server(proc, client)
        finally:
            if proc.poll() is None:
                proc.kill()
    assert rc == 0, f"server drain exited {rc}"
    c = stats["counters"]
    collapsed = c.get("cache_hits", 0) + c.get("inflight_joins", 0) + c.get("dedup_joins", 0)
    executed = c.get("executed_ok", 0) + c.get("executed_error", 0)
    # every unique scenario must have executed exactly once
    assert executed == len(uniq), (executed, len(uniq))
    assert executed + collapsed == c.get("scenarios_submitted", 0)
    if dev.type == "cuda":
        assert stats["launches"]["dram_timing"] > 0, stats["launches"]

    result = dict(
        mode="full",
        device=stats["device"],
        card=card(dev),
        launches=stats["launches"],
        workload=dict(jobs=len(specs), scenario_submissions=n_submitted,
                      unique_scenarios=len(uniq), workers=workers),
        wall_s=wall,
        jobs_per_s=len(specs) / wall,
        rows_per_s=rows_total / wall,
        row_latency_s=stats["latency"].get("row_s", {}),
        execute_latency_s=stats["latency"].get("execute_s", {}),
        queue_wait_s=stats["latency"].get("queue_wait_s", {}),
        collapse=dict(
            submitted=c.get("scenarios_submitted", 0),
            executed=executed,
            cache_hits=c.get("cache_hits", 0),
            inflight_joins=c.get("inflight_joins", 0),
            dedup_joins=c.get("dedup_joins", 0),
            collapse_rate=round(collapsed / max(1, c.get("scenarios_submitted", 0)), 4),
        ),
        worker_hostcache={k: v for k, v in c.items() if k.startswith("worker_hostcache")},
        counters=c,
    )
    _write(out, result)
    print(f"  {rows_total} rows in {wall:.1f}s; executed {executed} of {n_submitted} "
          f"submitted (collapse rate {result['collapse']['collapse_rate']:.0%})")
    print(f"  row latency p50={result['row_latency_s'].get('p50')}s "
          f"p95={result['row_latency_s'].get('p95')}s; launches {stats['launches']}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--tiny", action="store_true",
                    help="CI smoke: one tiny job, golden trace hashes")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="device of the server's workers (default: the CUDA card; "
                         "cpu: the kernels' plain versions)")
    ap.add_argument("--out", default=os.path.join("results", "bench_torch",
                                                  "BENCH_serve.json"))
    args = ap.parse_args(argv)
    dev = device_or_exit(args.device)
    if args.tiny:
        return run_tiny(args.out, args.device, dev)
    return run_full(args.out, args.workers, args.device, dev)


if __name__ == "__main__":
    raise SystemExit(main())
