#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and ``nvcc``.
Phases, one JSON line each on stdout:

1. device  -- the card (nvidia-smi name and power limit), torch and CUDA.
2. build   -- compile ``src/repro_torch/csrc/dram_timing.cu`` for sm_90a into
              ``build/repro_torch/`` (nvcc, plain C interface, ctypes).
3. kernel  -- the DRAM-timing kernel against its plain PyTorch version on the
              same CUDA tensors, bit for bit: random [64, 4096] batches for
              every preset x page policy, and the first 8,192 requests of the
              real ``lj/hitgraph/bfs`` batch.
4. main    -- the main path at full size: 18 scenarios on the paper graph
              ``lj`` and the 8 tiny golden scenarios through
              ``run_accelerator(..., device=None)``, i.e. on the card.  Every trace hash, TimingReport field, iteration count and
              value hash must equal ``tests/data/torch_golden_reports.json``
              (written from the JAX reference) and
              ``benchmarks/golden_hashes_tiny.json``; hits/misses/conflicts
              must equal the exact host classifier; BFS values must equal the
              port's ``reference_solve`` on the card.
5. kernels -- one line per ported kernel: launches on the main path, its
              time at the main path's largest bucket (CUDA events), its
              bound, and the plain version's time.

Any mismatch raises and the exit code is nonzero; without a CUDA card, or
outside the repository, it exits nonzero before printing any result.  The
last line is ``{"ok": true, "device": {...}}``.  Per-scenario detail goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "torch_golden_reports.json"
TINY_GOLDEN = ROOT / "benchmarks" / "golden_hashes_tiny.json"
OUT_DIR = ROOT / "chiprun_out"

# The card's published peaks (H100 SXM data sheet): HBM bandwidth, and the
# float32 rate outside the tensor cores, used as the rate of the kernel's
# scalar int32 operations (the pipeline that executes them is no faster).
PEAK_BYTES_PER_S = 3.35e12
PEAK_SCALAR_OPS_PER_S = 67e12
# int32 operations per valid request in the state machine's update
# (compares, max, adds and selects of one step; see csrc/dram_timing.cu).
OPS_PER_REQUEST = 20


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0].strip()


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timing_kwargs(cfg) -> dict:
    t = cfg.timing_cycles()
    return dict(nbanks=cfg.nbanks, tCL=t["tCL"], tRCD=t["tRCD"], tRP=t["tRP"],
                tRC=t["tRC"], tBL=t["tBL"], lookahead=16 * t["tBL"],
                page_open=cfg.page_open)


def values_sha256(values) -> str:
    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(values).tobytes()).hexdigest()


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_kernel_vs_plain(dev, lj_batch) -> int:
    """Kernel == plain on the same CUDA tensors; returns the max abs error
    (0, or the script has already failed)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core.dram import dram_config
    from repro_torch.kernels.dram_timing import (
        dram_timing_batch,
        dram_timing_batch_plain,
    )

    presets = {name: dram_config(name) for name in ("ddr3", "default", "hbm", "hitgraph")}
    presets["hbm-pc"] = dram_config("hbm", pseudo_channels=True).pseudo_channel_view()
    rng = np.random.default_rng(2024)
    B, L = 64, 4096
    worst = 0
    cases = 0
    t0 = time.perf_counter()

    def compare(label, bank, row, lengths, cfg):
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (bank, row, lengths)]
        got = dram_timing_batch(*args, **timing_kwargs(cfg))
        want = dram_timing_batch_plain(*args, **timing_kwargs(cfg))
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        check(torch.equal(got, want), f"kernel != plain on {label}: max err {err}")
        return got, err

    for name, base in presets.items():
        for policy in ("open", "closed"):
            cfg = dataclasses.replace(base, page_policy=policy)
            lengths = rng.integers(0, L + 1, size=B).astype(np.int32)
            lengths[0], lengths[1] = 0, L  # an all-padding row and a full one
            bank = rng.integers(0, cfg.nbanks, size=(B, L)).astype(np.int32)
            row = rng.integers(0, 6, size=(B, L)).astype(np.int32)
            pad = np.arange(L)[None, :] >= lengths[:, None]
            bank[pad], row[pad] = -1, 0
            got, err = compare(f"{name}/{policy}", bank, row, lengths, cfg)
            check(got[0].tolist() == [cfg.tCL, 0, 0, 0],
                  f"all-padding row is not (tCL, 0, 0, 0) on {name}/{policy}")
            worst = max(worst, err)
            cases += 1
    # the real main-path batch of lj/hitgraph/bfs, cut to 8,192 requests a row
    bank, row, lengths, cfg = lj_batch
    cut = 8192
    _, err = compare("lj/hitgraph/bfs", bank[:, :cut], row[:, :cut],
                     np.minimum(lengths, cut).astype(np.int32), cfg)
    worst = max(worst, err)
    cases += 1
    emit(dict(phase="kernel", kernel="dram_timing", cases=cases, max_abs_err=worst,
              random_shape=[B, L], lj_shape=[int(bank.shape[0]), cut],
              seconds=round(time.perf_counter() - t0, 3)))
    return worst


def tiny_scenarios() -> list[dict]:
    from repro_torch.core.accelerators import ACCELERATORS

    return [dict(key=f"tiny/{accel}/bfs/{d}x1", graph="tiny", accelerator=accel,
                 problem="bfs", dram=d, mapping="row", page_policy="open",
                 pseudo_channels=False)
            for accel in ACCELERATORS for d in ("default", "hbm")]


def graph_spec(name: str):
    from repro_torch.graph.generators import PAPER_GRAPHS, GraphSpec

    if name == "tiny":
        return GraphSpec("tiny", "uniform", 256, 1024, True, 1, 0)
    return PAPER_GRAPHS[name]


def prepare(sc: dict, graphs: dict):
    """The semantic half of ``run_accelerator`` for one scenario."""
    from repro_torch.configs.graphsim import default_config
    from repro_torch.core.accelerators import ACCELERATORS
    from repro_torch.core.dram import dram_config
    from repro_torch.graph.problems import PROBLEMS

    spec = graph_spec(sc["graph"])
    dram = dram_config(sc["dram"], mapping=sc["mapping"],
                       page_policy=sc["page_policy"],
                       pseudo_channels=sc["pseudo_channels"])
    acc = ACCELERATORS[sc["accelerator"]](default_config(sc["accelerator"]))
    return acc.prepare(graphs[sc["graph"]], PROBLEMS[sc["problem"]],
                       root=spec.root, dram=dram), spec.root


def largest_bucket(pending) -> int:
    """Length bucket of the longest trace ``simulate_batch`` sends to the
    kernel for ``pending`` (0 if none)."""
    from repro_torch.core import engine

    return max((engine._pow2_bucket(tr.n) for tr in pending.traces()
                if tr.n and engine.select_engine(tr.n, pending.config.engine,
                                                 pending.config.scan_cutoff) == "scan"),
               default=0)


def largest_group(pending):
    """The first kernel batch of the largest length bucket that
    ``simulate_batch`` forms for ``pending`` (same dedup, bucketing and
    chunking): (bank, row, lengths, cfg)."""
    import numpy as np

    from repro_torch.core import engine

    L = largest_bucket(pending)
    seen, group = set(), []
    for tr in pending.traces():
        key = tr.structural_key() if hasattr(tr, "structural_key") else id(tr)
        if key in seen or not tr.n or engine._pow2_bucket(tr.n) != L:
            continue
        seen.add(key)
        group.append(tr)
    chunk = group[: max(1, engine.MAX_BATCH_ELEMS // L)]
    batch = engine.TraceBatch.from_traces(chunk, pending.dram)
    lengths = np.zeros(batch.bank.shape[0], dtype=np.int32)
    lengths[: batch.size] = batch.lengths
    return batch.bank, batch.row, lengths, pending.dram


def check_against_classifier(pending, rep) -> None:
    """Hits/misses/conflicts of the kernel-timed report == the exact host
    classifier summed over the same traces (independent of the golden)."""
    from repro_torch.core import engine

    hits = misses = conflicts = 0
    for tr in pending.traces():
        bank, row = engine.decode(tr.lines, pending.dram)
        cls = engine.classify_fast(bank, row, pending.dram.nbanks,
                                   pending.dram.page_open)
        hits += int((cls == 0).sum())
        misses += int((cls == 1).sum())
        conflicts += int((cls == 2).sum())
    t = rep.timing
    check((t.hits, t.misses, t.conflicts) == (hits, misses, conflicts),
          f"{rep.graph}/{rep.accelerator}/{rep.problem}: kernel counters "
          f"{(t.hits, t.misses, t.conflicts)} != classifier {(hits, misses, conflicts)}")


def phase_main(graphs: dict) -> tuple[list[dict], dict]:
    """Every scenario through ``run_accelerator(..., device=None)``; the
    launch counts are zeroed just before and read just after."""
    import torch

    from repro_torch.configs.graphsim import default_config
    from repro_torch.core import engine, hostcache
    from repro_torch.core.accelerators import run_accelerator
    from repro_torch.core.dram import dram_config
    from repro_torch.core.trace import trace_stream_hash
    from repro_torch.graph.problems import PROBLEMS, reference_solve
    from repro_torch.kernels import _platform

    golden = {s["key"]: s for s in json.loads(GOLDEN.read_text())["scenarios"]}
    tiny_golden = json.loads(TINY_GOLDEN.read_text())
    scenarios = [s for s in golden.values() if s["graph"] == "lj"]
    check(len(scenarios) == 18, f"expected 18 lj goldens, found {len(scenarios)}")
    scenarios += tiny_scenarios()

    # device time of each kernel call, by CUDA events around the engine's
    # calls of the wrapper (the wrapper itself still does the counting)
    kernel_events: list = []
    launch = engine.dram_timing_batch

    def timed_launch(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch(*args, **kw)
        end.record()
        kernel_events.append((start, end))
        return out

    hostcache.clear_all()  # the main path pays its own semantic half
    rows = []
    largest = (0, None)
    engine.dram_timing_batch = timed_launch
    _platform.reset_launches()
    engine.reset_dispatch_stats()
    t_main = time.perf_counter()
    try:
        for sc in scenarios:
            spec = graph_spec(sc["graph"])
            dram = dram_config(sc["dram"], mapping=sc["mapping"],
                               page_policy=sc["page_policy"],
                               pseudo_channels=sc["pseudo_channels"])
            kernel_events.clear()
            t0 = time.perf_counter()
            rep = run_accelerator(sc["accelerator"], graphs[sc["graph"]],
                                  PROBLEMS[sc["problem"]], spec.root, dram,
                                  default_config(sc["accelerator"]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            kernel_ms = sum(s.elapsed_time(e) for s, e in kernel_events)
            # the semantic half again (a host-cache hit) for the traces
            pending, _ = prepare(sc, graphs)
            traces = pending.traces()
            rows.append(dict(key=sc["key"], wall_s=wall, kernel_ms=kernel_ms,
                             host_s=wall - kernel_ms / 1e3,
                             launches=len(kernel_events), traces=len(traces),
                             requests=sum(t.n for t in traces),
                             time_ns=rep.timing.time_ns))
            thash = trace_stream_hash(traces)[:16]
            if sc["graph"] == "tiny":
                check(thash == tiny_golden[sc["key"]],
                      f"{sc['key']}: trace hash {thash} != {tiny_golden[sc['key']]}")
                continue
            L = largest_bucket(pending)
            if L > largest[0]:
                largest = (L, sc)
            want = golden[sc["key"]]
            check(thash == want["trace_hash"], f"{sc['key']}: trace hash {thash}")
            check(rep.timing.to_dict() == want["timing"],
                  f"{sc['key']}: timing {rep.timing.to_dict()} != {want['timing']}")
            check(rep.iterations == want["iterations"], f"{sc['key']}: iterations")
            check(values_sha256(rep.values) == want["values_sha256"],
                  f"{sc['key']}: values differ from the reference")
            check_against_classifier(pending, rep)
            if PROBLEMS[sc["problem"]].kind == "min":
                ref, _ = reference_solve(graphs[sc["graph"]], PROBLEMS[sc["problem"]],
                                         spec.root)
                check(values_sha256(ref) == values_sha256(rep.values),
                      f"{sc['key']}: values != reference_solve on the card")
    finally:
        engine.dram_timing_batch = launch
    seconds = time.perf_counter() - t_main
    counts = _platform.launch_counts()
    stats = engine.dispatch_stats()
    check(counts["dram_timing"] > 0, "the main path launched no dram_timing kernel")
    check(counts["dram_timing"] == stats["dispatches"],
          f"launches {counts['dram_timing']} != engine dispatches {stats['dispatches']}")
    lj = [r for r in rows if r["key"].startswith("lj/")]
    emit(dict(phase="main", scenarios=len(rows), seconds=round(seconds, 3),
              launches=counts["dram_timing"], dispatches=stats["dispatches"],
              traces=stats["traces"], requests=stats["requests"],
              lj_wall_s=round(sum(r["wall_s"] for r in lj), 3),
              lj_host_s=round(sum(r["host_s"] for r in lj), 3),
              lj_kernel_ms=round(sum(r["kernel_ms"] for r in lj), 3),
              largest_bucket=largest[0], largest_key=largest[1]["key"]))
    pending, _ = prepare(largest[1], graphs)
    return rows, dict(counts=counts, batch=largest_group(pending))


def phase_kernel_timing(dev, batch) -> dict:
    import torch

    from repro_torch.kernels.dram_timing import (
        dram_timing_batch,
        dram_timing_batch_plain,
    )

    bank, row, lengths, cfg = batch
    args = [torch.from_numpy(a).to(dev) for a in (bank, row, lengths)]
    kw = timing_kwargs(cfg)
    ms = cuda_ms(lambda: dram_timing_batch(*args, **kw), reps=20)
    got = dram_timing_batch(*args, **kw)
    t0 = time.perf_counter()
    want = dram_timing_batch_plain(*args, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = int((got.long() - want.long()).abs().max())
    check(torch.equal(got, want), f"kernel != plain at the largest bucket: max err {err}")
    B, L = bank.shape
    requests = int(lengths.sum())
    nbytes = 8 * requests + 4 * B + 16 * B
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = OPS_PER_REQUEST * requests / PEAK_SCALAR_OPS_PER_S * 1e3
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                max_abs_err=err, shape=[B, L], requests=requests)


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    if not (ROOT / "src" / "repro_torch").is_dir() or not GOLDEN.exists():
        fail(f"run from the repository root: {ROOT} holds no src/repro_torch")
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda")

    # 1. device
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit(dict(phase="device", nvidia_smi=smi, name=kind,
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda, python=sys.version.split()[0]))

    # 2. build
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    lib = _build.build("dram_timing", verbose=True)
    _build.load("dram_timing")
    emit(dict(phase="build", kernel="dram_timing", library=str(lib.relative_to(ROOT))
              if lib.is_relative_to(ROOT) else str(lib),
              seconds=round(time.perf_counter() - t0, 3)))

    # graph generation is set-up, not the path
    graphs = {name: graph_spec(name).build() for name in ("lj", "tiny")}

    # 3. kernel vs plain (one case is the real lj/hitgraph/bfs batch)
    pending, _ = prepare(dict(graph="lj", accelerator="hitgraph", problem="bfs",
                              dram="hitgraph", mapping="row", page_policy="open",
                              pseudo_channels=False), graphs)
    worst = phase_kernel_vs_plain(dev, largest_group(pending))

    # 4. main path
    rows, info = phase_main(graphs)

    # 5. kernel timing at the main path's largest bucket
    timing = phase_kernel_timing(dev, info["batch"])
    emit(dict(phase="kernel_timing", kernel="dram_timing", **timing))

    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        dict(card=smi, scenarios=rows, kernel_timing=timing), indent=1) + "\n")

    emit(dict(kernels=[dict(
        name="dram_timing", route="cuda", source="src/repro_torch/csrc/dram_timing.cu",
        replaces="src/repro/kernels/dram_timing/dram_timing.py:120",
        launches=info["counts"]["dram_timing"],
        max_abs_err=max(worst, timing["max_abs_err"]),
        ms=timing["ms"], plain_ms=timing["plain_ms"], bound_ms=timing["bound_ms"],
        bound_by=timing["bound_by"], library_ms=None, shape=timing["shape"],
        card=smi)]))
    print(smi, flush=True)
    emit(dict(ok=True, device=dict(platform="gpu", kind=kind,
                                   count=torch.cuda.device_count())))


if __name__ == "__main__":
    main()
