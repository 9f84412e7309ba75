"""CLI for the sweep server and its client.

Server (stays up, drains on SIGTERM):

    PYTHONPATH=src python -m repro_torch.serve \
        --port 8731 --cache results/sweep_cache --workers 4

Client (same axis flags as ``python -m repro_torch.sweep``):

    PYTHONPATH=src python -m repro_torch.serve --submit --address 127.0.0.1:8731 \
        --accels accugraph,hitgraph --graphs sd --problems bfs --out results/served

    PYTHONPATH=src python -m repro_torch.serve --stats --address 127.0.0.1:8731
    PYTHONPATH=src python -m repro_torch.serve --shutdown --address 127.0.0.1:8731

``--search`` submits an *adaptive search* job instead of a grid (same
axis flags, plus the query flags of ``python -m repro_torch.sweep search``):

    PYTHONPATH=src python -m repro_torch.serve --search --address 127.0.0.1:8731 \
        --accels accugraph,hitgraph --graphs sd --problems bfs,pr \
        --drams hbm --channels 4,8 --page-policies open,closed \
        --objective runtime_s --budget-frac 0.25 --out results/served

``--port 0`` picks a free port; ``--port-file`` writes the bound
``host:port`` for whoever spawned the server (the bench harness and CI
use this for discovery).

``--device`` names the device the server's workers run on: the CUDA card
when it is left out (without one the server prints ``error: ...`` and
exits 2), ``cpu`` for the kernels' plain versions.  The server's own
process opens no CUDA context; each spawn worker opens its own and loads
the kernels before it takes a chunk.

Multi-host serving: ``--worker-listen HOST:PORT`` makes the server run a
:class:`~repro_torch.distributed.remote.RemoteWorkerPool` instead of a
local spawn pool — it executes nothing until worker hosts connect.  On
each host, start an agent that registers its seats and runs chunks on a
warm local pool on that host's card:

    PYTHONPATH=src python -m repro_torch.serve --port 8731 \
        --cache results/sweep_cache --worker-listen 0.0.0.0:8732

    # on every worker host
    PYTHONPATH=src python -m repro_torch.serve worker \
        --connect scheduler-host:8732 --seats 4

Hosts re-register with backoff after a scheduler restart or network
blip; a host that dies mid-chunk surfaces as a ``WorkerLost`` and its
chunks re-dispatch to the surviving hosts.  ``--worker-listen`` with
port 0 picks a free port; ``--worker-port-file`` writes the bound
address for the spawning harness.  Under ``--worker-listen`` the
server's ``--device`` names its own host's device (``/stats["device"]``),
where no chunk runs; each ``worker`` takes its own ``--device`` (default:
its card; without one it prints ``error: ...`` and exits 2), and
``/stats["launches"]`` sums the kernel launches of every host.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.kernels._platform import resolve_device
from repro_torch.serve.client import ServeClient, ServeError
from repro_torch.serve.server import SweepServer
from repro_torch.sweep.__main__ import (
    add_policy_args,
    add_spec_args,
    build_policy,
    build_spec,
)
from repro_torch.sweep.results import write_csv, write_json
from repro_torch.sweep.search.cli import (
    _print_answer,
    add_search_args,
    build_search_spec,
)


def _load_faults(arg: str):
    """``--faults`` accepts inline JSON or ``@path/to/plan.json``."""
    if not arg:
        return None
    from repro_torch.distributed.faults import plan_from_json

    text = arg
    if arg.startswith("@"):
        with open(arg[1:]) as f:
            text = f.read()
    return plan_from_json(text)


def _serve(args: argparse.Namespace) -> int:
    try:
        policy = build_policy(args)
        fault_plan = _load_faults(args.faults)
        device = str(resolve_device(args.device))
    except (OSError, ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    pool_factory = None
    if args.worker_listen:
        from repro_torch.distributed.remote import RemoteWorkerPool, parse_address

        try:
            whost, wport = parse_address(args.worker_listen)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

        def pool_factory(whost=whost, wport=wport):
            return RemoteWorkerPool(
                host=whost, port=wport, fault_plan=fault_plan,
                task_deadline_s=args.worker_deadline or None)

    server = SweepServer(
        host=args.host, port=args.port,
        cache_dir=args.cache or None,
        workers=args.workers, mode=args.mode, policy=policy,
        chunk_size=args.chunk_size, trace_hashes=args.trace_hashes,
        quiet=args.quiet,
        pool_factory=pool_factory,
        poison_threshold=args.poison_threshold,
        fault_plan=fault_plan,
        worker_deadline_s=args.worker_deadline or None,
        resume=not args.no_resume,
        device=device,
    )
    server.install_signal_handlers()
    server.start()
    if args.port_file:
        with open(args.port_file, "w") as f:
            f.write(server.address + "\n")
    pool = f"workers={args.workers}"
    if args.worker_listen:
        pool_addr = server.scheduler.pool.address
        if args.worker_port_file:
            with open(args.worker_port_file, "w") as f:
                f.write(pool_addr + "\n")
        pool = f"worker hosts connect to {pool_addr}"
    print(f"serving on http://{server.address} "
          f"(cache={args.cache or '<none>'}, {pool}, device={device})", flush=True)
    server.wait()
    return 0


def worker_main(argv: list[str] | None = None) -> int:
    """``python -m repro_torch.serve worker``: one worker-host agent."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve worker",
        description="Worker-host agent: connects out to a scheduler's "
                    "--worker-listen port, registers its seats, executes "
                    "dispatched chunks on a warm local worker pool on this "
                    "host's device, and re-registers with backoff after "
                    "disconnects.")
    ap.add_argument("--connect", required=True,
                    help="scheduler worker-listen address (host:port)")
    ap.add_argument("--seats", type=int, default=2,
                    help="local spawn-worker pool size to offer")
    ap.add_argument("--name", default="",
                    help="host label in scheduler stats "
                         "(default: hostname:pid)")
    ap.add_argument("--worker-deadline", type=float, default=300.0,
                    help="per-chunk liveness deadline of the local pool "
                         "(0 disables)")
    ap.add_argument("--device", default=None,
                    help="device this host's workers run on (default: the "
                         "CUDA card; cpu: the kernels' plain versions)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress structured logs on stderr")
    args = ap.parse_args(argv)

    from repro_torch.distributed.remote import parse_address, run_worker_host
    from repro_torch.serve.server import jlog

    try:
        parse_address(args.connect)
        device = str(resolve_device(args.device))
    except (ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    outcome = run_worker_host(args.connect, seats=max(1, args.seats),
                              name=args.name or None,
                              worker_deadline_s=args.worker_deadline or None,
                              log=None if args.quiet else jlog, device=device)
    return 0 if outcome == "shutdown" else 1


def _submit(args: argparse.Namespace) -> int:
    try:
        spec = build_spec(args)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    client = ServeClient(args.address)
    try:
        result = client.run(spec)
    except (OSError, ServeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    for sk in result.skipped:
        print(f"skip {sk['graph']}/{sk['accelerator']}/{sk['problem']}"
              f"/{sk['dram']}: {sk['reason']}")
    rows = result.rows_with_status()
    if rows:
        csv_path = f"{args.out}/{spec.name}.csv"
        write_csv(csv_path, rows)
        write_json(f"{args.out}/{spec.name}.json", rows)
        print(f"wrote {csv_path} ({len(rows)} rows)")
    else:
        print("no runnable scenarios (all combinations filtered); nothing written")
    print(f"{result.job_id}: {result.outcome}; {len(rows)}/{result.total} rows "
          f"({result.n_cached} cached, {result.n_errors} errors)")
    if result.outcome != "done":
        return 3
    return 1 if result.n_errors else 0


def _search(args: argparse.Namespace) -> int:
    try:
        space = build_spec(args)
        sspec = build_search_spec(args, space)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    client = ServeClient(args.address)
    try:
        result = client.run_search(sspec)
    except (OSError, ServeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    rows = result.rows_with_status()
    if rows:
        csv_path = f"{args.out}/{space.name}_probes.csv"
        write_csv(csv_path, rows)
        print(f"wrote {csv_path} ({len(rows)} probe rows)")
    if result.result is not None:
        os.makedirs(args.out, exist_ok=True)
        report = f"{args.out}/{space.name}_search.json"
        with open(report, "w") as f:
            json.dump(result.result, f, indent=2, sort_keys=True)
        print(f"wrote {report}")
        _print_answer(result.result)
        r = result.result
        print(f"{result.job_id}: {result.outcome}; {r['executed']} executed "
              f"(+{r['cached']} cached, +{r['warm']} warm) of {r['pool']} "
              f"candidates in {len(result.proposals)} rounds")
    else:
        print(f"{result.job_id}: {result.outcome}; no search result "
              f"({result.error or 'stream ended early'})")
    if result.outcome != "done" or result.result is None:
        return 3
    return 1 if result.error else 0


def main(argv: list[str] | None = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "worker":
        return worker_main(argv[1:])
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve",
                                 description=__doc__)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--submit", action="store_true",
                      help="act as a client: submit a sweep to --address")
    mode.add_argument("--search", action="store_true",
                      help="act as a client: submit an adaptive search "
                           "job to --address")
    mode.add_argument("--stats", action="store_true",
                      help="print the server's /stats snapshot")
    mode.add_argument("--shutdown", action="store_true",
                      help="ask the server to drain and exit")
    ap.add_argument("--address", default="127.0.0.1:8731",
                    help="server address for client modes")
    # server knobs
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8731,
                    help="0 picks a free port (see --port-file)")
    ap.add_argument("--port-file", default="",
                    help="write the bound host:port here once listening")
    ap.add_argument("--cache", default="results/sweep_cache",
                    help="result cache directory ('' disables caching)")
    ap.add_argument("--workers", type=int, default=2,
                    help="persistent spawn-worker pool size")
    ap.add_argument("--mode", default="batch", choices=("scenario", "batch"))
    ap.add_argument("--chunk-size", type=int, default=4,
                    help="scenarios per worker dispatch")
    ap.add_argument("--trace-hashes", action="store_true",
                    help="attach trace_stream_hash fingerprints to rows "
                         "(golden-hash verification)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress structured logs on stderr")
    # fault-tolerance knobs
    ap.add_argument("--poison-threshold", type=int, default=3,
                    help="dispatch attempts before a scenario that keeps "
                         "killing workers is quarantined as an error row")
    ap.add_argument("--worker-deadline", type=float, default=300.0,
                    help="per-chunk liveness deadline in seconds; a worker "
                         "sitting on a chunk longer is killed and the chunk "
                         "re-dispatched (0 disables)")
    ap.add_argument("--faults", default="",
                    help="deterministic fault-injection plan: inline JSON "
                         "or @file (testing/chaos benchmarking only)")
    ap.add_argument("--no-resume", action="store_true",
                    help="skip journal recovery of unfinished jobs from a "
                         "previous server run")
    ap.add_argument("--device", default=None,
                    help="device the workers run on (default: the CUDA "
                         "card; cpu: the kernels' plain versions); under "
                         "--worker-listen, this host's, where no chunk runs")
    # multi-host knobs
    ap.add_argument("--worker-listen", default="",
                    help="host:port to accept worker hosts on; replaces the "
                         "local pool with a RemoteWorkerPool (port 0 picks "
                         "a free port, see --worker-port-file)")
    ap.add_argument("--worker-port-file", default="",
                    help="write the bound worker-listen host:port here once "
                         "listening")
    add_policy_args(ap)
    # client knobs
    ap.add_argument("--out", default="results/served",
                    help="(--submit/--search) output directory")
    add_spec_args(ap)
    add_search_args(ap)
    args = ap.parse_args(argv)

    if args.stats:
        try:
            print(json.dumps(ServeClient(args.address).stats(), indent=2))
        except (OSError, ServeError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        return 0
    if args.shutdown:
        try:
            ServeClient(args.address).shutdown()
        except (OSError, ServeError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        print("server draining")
        return 0
    if args.submit:
        return _submit(args)
    if args.search:
        return _search(args)
    return _serve(args)


if __name__ == "__main__":
    sys.exit(main())
