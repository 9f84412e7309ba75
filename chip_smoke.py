#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and ``nvcc``.
Phases, one JSON line each on stdout:

1. device  -- the card (nvidia-smi name and power limit), torch and CUDA.
2. build   -- compile ``src/repro_torch/csrc/{dram_timing,edge_update,spmv,
              attention}.cu`` for sm_90a into ``build/repro_torch/`` (one nvcc
              per source, all started together; plain C interface, ctypes).
   sass    -- whether the attention library's SASS holds wgmma (``HGMMA``)
              and TMA loads (``UTMALDG``), by ``cuobjdump -sass``; "not
              checked" where the tool is missing, a failure where an opcode is.
3. kernel  -- each kernel against its plain PyTorch version on the same CUDA
              tensors.  DRAM timing, bit for bit: random [64, 4096] batches
              (-1 banks and -1 rows inside the lengths) for every preset x
              page policy, each on the matrix path at the wrapper's segment
              count and at 7, 333 and 5,000 segments (edges at odd places,
              empty segments) and on the direct walk; 32 banks (the direct
              walk, past the matrix path); and the first 8,192 requests of
              the real ``lj/hitgraph/bfs`` batch at 1, 5, 37 and the
              wrapper's segments.  Edge update, bit for bit:
              random f32 (+inf sources, src -1 edges, empty segments,
              negative values) and int32 (int32-max sources) inputs, the
              real ``lj`` HitGraph min layout, and inputs that break the
              kernel's grouping (``edge_update_cases``: dst runs of 5, 32
              and 77 edges, src-sorted, every edge to one destination at
              1,048,579 edges; mixed-sign candidates in a group, +inf
              sources and src -1 inside groups, int32 adds that wrap; 0, 1,
              31, 33 and 200,003 edges; each also from one edge in, off the
              16-byte grid), each through the wrapper and planned for 1 and
              3 resident blocks (four edges a lane, many rounds a warp).  SpMV, bit for bit: the real
              ``lj`` PageRank ELL layout (31 wide, the tiled path) and
              the ``tw`` one (52 wide, the wide-row path).  Attention, within the
              reference's tolerances (2e-5 in f32, 2e-2 in bf16; TF32 is
              off for every matmul): the shape set of
              ``tests/test_kernels.py``, qwen3's heads (16/8, hd 128) at
              S 1,024 and on a ragged S, and a non-causal case, in f32 and
              bf16.
4. main    -- the main path at full size: 18 scenarios on the paper graph
              ``lj`` and the 8 tiny golden scenarios through
              ``run_accelerator(..., device=None)``, i.e. on the card.  Every trace hash, TimingReport field, iteration count and
              value hash must equal ``tests/data/torch_golden_reports.json``
              (written from the JAX reference) and
              ``benchmarks/golden_hashes_tiny.json``; hits/misses/conflicts
              must equal the exact host classifier; BFS values must equal the
              port's ``reference_solve`` on the card.  Printed: the DRAM
              timing kernel's CUDA-event ms by length bucket and in all.
5. main_device -- the ``semexec="device"`` path at full size: all 16
              (accelerator, problem) pairs of ``semexec.SUPPORTED`` on ``lj``,
              each on its accelerator's own DRAM preset, through
              ``run_accelerator(..., AccelConfig(semexec="device"),
              device=None)``.  Every pair must equal the numpy engine run on
              the same card (trace hash, TimingReport, iterations; min values
              bit-equal, acc values allclose) and record
              ``layout["engine"] == "device"``; the 8 bfs/pr pairs must equal
              the goldens too.  The edge-update and SpMV kernels must have
              launched.  Printed: the edge-update calls by power-of-2 edge
              count, with their CUDA-event ms and the host ms inside the
              wrapper calls.
6. serve_golden -- the LM serving path in f32 on the card against
              ``tests/data/torch_golden_serve.json`` (written from the JAX
              reference): ``qwen3_0_6b.reduced()`` and qwen3 at full width
              cut to 2 layers, weights from ``interop.lm_params_numpy``.
              Teacher-forced logits of every step within the file's
              tolerance; ``ServeEngine``'s greedy tokens equal up to each
              request's first near-tie (counted and printed).
7. serve   -- the LM serving path at full size: ``qwen3_0_6b`` at its
              published widths and depth (28 layers) in bf16, weights from
              ``Model.init`` with a seeded generator on the card.
              ``ServeEngine(batch=4, max_seq=1056)`` answers 8 requests of
              1,024 seeded prompt tokens and 32 new tokens (two waves).
              Every request must be answered with tokens in the vocab, the
              tokens must equal a stepwise greedy loop over ``prefill`` and
              ``decode_step``, and every prefill layer must have launched the
              attention kernel (28 x waves).  The kernel is then held against
              its plain version on the real q/k/v of layer 0 of wave 1.
              Printed: wall per wave, prefill and decode tokens per second,
              and the share of prefill time inside the attention kernel.
8. kernels -- one line per ported kernel: launches on its path, its time at
              the path's largest call (CUDA events), its bound, the plain
              version's time and, where one PyTorch call computes the same
              function, that call's time.  ``ms`` is the mean of calls
              back to back from the host (CUDA events), as in every
              earlier run.  DRAM timing is timed whole at the path's largest
              call, also as a replayed CUDA graph, with its segment count
              and the matrix path's own operation count beside the bound.  Edge update, SpMV and attention are timed in turn with their
              library call over 7 rounds, each round back to back (``ms``)
              and as a replayed CUDA graph (``graph_ms``, the device time
              without the host's enqueue): median, min and max.  Edge
              update also at the path's typical small call (the median size
              of ``lj/foregraph/bfs``'s calls, in ``foregraph_call``), with
              ``torch.profiler``'s device us of its kernels and the atomics
              it takes at both calls, and the wrapper's host enqueue us a
              call at the small one.

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
# int32 operations per request in each column of the matrix path's segment
# map (horizon: add, max; t_act: add, max, max; row_ready: add; slot_end:
# max, add; see csrc/dram_timing.cu, kernel 3), for an estimate of what that
# path executes (chip_smoke.json only: no bound is drawn from it)
MATRIX_OPS_PER_COLUMN = 8
KERNELS = ("dram_timing", "edge_update", "spmv", "attention")
# bf16 tensor-core peak (H100 SXM data sheet, dense), the rate of the
# attention kernel's operations on its bf16 inputs at the serving path
PEAK_BF16_OPS_PER_S = 989e12
SERVE_GOLDEN = ROOT / "tests" / "data" / "torch_golden_serve.json"
# the reference's own attention tolerances (tests/test_kernels.py)
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SERVE_ARCH = "qwen3_0_6b"
SERVE_BATCH, SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 4, 8, 1024, 32
SERVE_MAX_SEQ = 1056
# rounds of the alternated kernel / library timings (median and spread)
TIMING_ROUNDS = 7
# the bf16 attention kernel must run wgmma and load by TMA: SASS opcodes
ATTENTION_SASS = ("HGMMA", "UTMALDG")
# keys of a kernel's timing that its line in the kernels JSON carries too
EXTRA_KEYS = ("segments", "ms_min", "ms_max",
              "library_ms_min", "library_ms_max", "graph_ms",
              "graph_ms_min", "graph_ms_max", "graph_library_ms", "graph_library_ms_min",
              "graph_library_ms_max", "rounds")
# the device pair whose edge-update call of median size B2 is timed at
# (the path's typical small call)
FOREGRAPH_PAIR = "foregraph/bfs"
# wrapper calls a host-enqueue timing makes, with no sync until the end
ENQUEUE_CALLS = 1000
# acc values of the device engine against the numpy engine: the sums
# associate in another order than np.add.at (tests/test_semexec.py:58)
ACC_RTOL, ACC_ATOL = 1e-5, 1e-6


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


def graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls captured in
    one CUDA graph and replayed: the card's time for the work, without the
    host's enqueue of each call (which, for a call of ~10 us, is longer than
    the call and sets the pace of ``cuda_ms``)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as capture asks
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_us_by_kernel(fn, reps: int) -> dict:
    """Device microseconds a call of ``fn()`` spends in each CUDA kernel it
    launches (self device time), by ``torch.profiler`` over ``reps`` calls
    after a warm-up; keyed by the kernel's function name."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0:  # a kernel: its own device time
            name = re.search(r"(\w+_kernel)", evt.key)
            key = name.group(1) if name else evt.key
            out[key] = out.get(key, 0.0) + us / reps
    return out


def alternate_ms(fns: dict, reps: int, rounds: int = TIMING_ROUNDS) -> dict:
    """Times each of ``fns`` in turn, ``rounds`` times over (a, b, a, b, ...),
    so that a drift of the card's clocks reaches all of them alike: each
    round back to back from the host (``cuda_ms``, which a short call's
    enqueue can set) and by a replayed CUDA graph (``graph_ms``, the device
    time).  Returns per name the median, min and max of both."""
    import statistics

    times = {name: {"graph": [], "eager": []} for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            times[name]["graph"].append(graph_ms(fn, reps=reps))
            times[name]["eager"].append(cuda_ms(fn, reps=reps))
    return {name: {kind: dict(median=statistics.median(t), min=min(t), max=max(t), rounds=t)
                   for kind, t in by_kind.items()}
            for name, by_kind in times.items()}


def spread(t: dict) -> dict:
    """From ``alternate_ms``'s kernel and library: the median back to back
    (``ms``, ``library_ms``, the yardstick of every earlier run), min and
    max, and the same as a replayed graph (``graph_ms``, ...), with every
    round."""
    out = dict(rounds=TIMING_ROUNDS)
    for who, key in (("kernel", "ms"), ("library", "library_ms")):
        for kind, prefix in (("eager", ""), ("graph", "graph_")):
            stats = t[who][kind]
            out[prefix + key] = stats["median"]
            out[prefix + key + "_min"] = stats["min"]
            out[prefix + key + "_max"] = stats["max"]
            out[prefix + key + "_rounds"] = stats["rounds"]
    return out


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
    (0, or the script has already failed).  Both of the kernel's paths run:
    the matrix path (segments chosen by the wrapper, and forced counts whose
    segment edges fall at odd places, some past every trace's end) and the
    direct walk (forced, and for 32 banks, past the matrix path)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core.dram import dram_config
    from repro_torch.kernels.dram_timing import (
        MATRIX_BANKS,
        dram_timing_batch,
        dram_timing_batch_plain,
        plan_segments,
        target_warps,
    )
    from repro_torch.kernels.dram_timing.dram_timing import _launch

    presets = {name: dram_config(name) for name in ("ddr3", "default", "hbm", "hitgraph")}
    presets["hbm-pc"] = dram_config("hbm", pseudo_channels=True).pseudo_channel_view()
    rng = np.random.default_rng(2024)
    B, L = 64, 4096
    worst = 0
    cases = []
    t0 = time.perf_counter()

    def compare(label, bank, row, lengths, kw, segment_counts=(None,)):
        """The kernel at each of ``segment_counts`` (None: the wrapper's
        choice) against one plain run; returns the outputs and the error."""
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (bank, row, lengths)]
        want = dram_timing_batch_plain(*args, **kw)
        err = 0
        for segments in segment_counts:
            got = (dram_timing_batch(*args, **kw) if segments is None
                   else _launch(*args, segments, **kw))
            torch.cuda.synchronize()
            err = max(err, int((got.long() - want.long()).abs().max()))
            used = segments or plan_segments(
                *bank.shape, warps=target_warps(dev),
                **{k: kw[k] for k in ("nbanks", "tRCD", "tRP", "tRC", "tBL", "lookahead")})
            check(torch.equal(got, want),
                  f"kernel != plain on {label}, {used} segments: max err {err}")
            cases.append(dict(case=label, segments=used, shape=list(bank.shape)))
        return want, err

    def random_batch(nbanks):
        lengths = rng.integers(0, L + 1, size=B).astype(np.int32)
        lengths[0], lengths[1] = 0, L  # an all-padding row and a full one
        bank = rng.integers(0, nbanks, size=(B, L)).astype(np.int32)
        row = rng.integers(0, 6, size=(B, L)).astype(np.int32)
        live = np.arange(L)[None, :] < lengths[:, None]
        row[live & (rng.random((B, L)) < 0.05)] = -1  # hit and miss on a closed bank
        bank[live & (rng.random((B, L)) < 0.02)] = -1  # no-ops inside the lengths
        bank[~live], row[~live] = -1, 0
        return bank, row, lengths

    for name, base in presets.items():
        for policy in ("open", "closed"):
            cfg = dataclasses.replace(base, page_policy=policy)
            kw = timing_kwargs(cfg)
            bank, row, lengths = random_batch(cfg.nbanks)
            # the wrapper's choice (16 segments), the direct walk, and segment
            # edges at odd places (4096 / 7 and 4096 / 333 are not multiples
            # of 32; 5000 segments of one request leave the last 904 past
            # every trace's end, and more past the shorter ones)
            want, err = compare(f"{name}/{policy}", bank, row, lengths, kw,
                                (None, 1, 7, 333, 5000))
            check(want[0].tolist() == [cfg.tCL, 0, 0, 0],
                  f"all-padding row is not (tCL, 0, 0, 0) on {name}/{policy}")
            worst = max(worst, err)
    # banks past the matrix path: the direct walk
    kw = dict(timing_kwargs(presets["default"]), nbanks=2 * MATRIX_BANKS)
    _, err = compare("default timings, 32 banks", *random_batch(kw["nbanks"]), kw)
    worst = max(worst, err)
    # the real main-path batch of lj/hitgraph/bfs (its largest bucket), cut
    # to 8,192 requests a row, with odd segment counts
    bank, row, lengths, cfg = lj_batch
    cut = 8192
    kw = timing_kwargs(cfg)
    _, err = compare("lj/hitgraph/bfs largest bucket, cut", bank[:, :cut], row[:, :cut],
                     np.minimum(lengths, cut).astype(np.int32), kw, (None, 1, 5, 37))
    worst = max(worst, err)
    emit(dict(phase="kernel", kernel="dram_timing", cases=len(cases), max_abs_err=worst,
              random_shape=[B, L], lj_shape=[int(bank.shape[0]), cut],
              segment_counts=sorted({c["segments"] for c in cases}),
              seconds=round(time.perf_counter() - t0, 3)))
    return worst


def pr_layout(g, dev) -> dict:
    """The PageRank accumulation layout of ``g`` with its ELL, as the
    device path builds it."""
    from repro_torch.core import semexec

    w_eff = semexec._acc_weight("pr", g.src, None, g.degrees_out)
    return semexec._acc_layout(g.src, g.dst, w_eff, g.n, dev)


def lj_device_layouts(graphs: dict, dev):
    """The real ``lj`` layouts of the device path: HitGraph's bfs min layout
    (every routed edge, as ``semexec.HitGraphDevice`` builds it) and the
    PageRank accumulation layout with its ELL."""
    from repro_torch.configs.graphsim import default_config
    from repro_torch.core import semexec
    from repro_torch.core.accelerators.hitgraph import HitGraph
    from repro_torch.graph.partition import horizontal_partition
    from repro_torch.graph.problems import PROBLEMS

    g = graphs["lj"]
    ivl = default_config("hitgraph").effective_interval
    parts = horizontal_partition(g, ivl, by="src")
    prep = [HitGraph._partition_prep(g, parts.edge_idx[i], parts.k, ivl, True, False)
            for i in range(parts.k)]
    lay_min = semexec._build_hitgraph_min(g, PROBLEMS["bfs"], prep, parts.k, ivl, dev)
    return lay_min, pr_layout(g, dev)


def edge_update_cases(rng) -> dict:
    """Inputs chosen to break the edge-update kernel's grouping, as numpy
    arrays: edge orders (random; sorted by dst in runs of 5, 32 and 77
    edges, shorter than, equal to and longer than a warp's round and
    crossing its edges; sorted by src; every edge to one destination, at
    1,048,579 edges), values (f32 with negative and positive candidates in
    one group; +inf sources and src -1 edges inside groups; int32 near the
    max, where the add wraps, with int32-max sources) and sizes (0, 1, 31,
    33, and 200,003 edges: not a multiple of 4)."""
    import numpy as np

    i32max = np.iinfo(np.int32).max

    def case(order: str, kind: str, m: int):
        n = 64 + m // 4
        src = rng.integers(0, n, m).astype(np.int32)
        dst = rng.integers(0, n, m).astype(np.int32)
        if kind == "i32-wrap":
            values = rng.integers(i32max - 40, i32max, n).astype(np.int32)
            values[rng.random(n) < 0.3] = i32max
            delta = rng.integers(-5, 60, m).astype(np.int32)
            src[rng.random(m) < 0.1] = -1
        else:
            values = (rng.standard_normal(n) * 10).astype(np.float32)
            delta = (rng.standard_normal(m) * 3).astype(np.float32)
            if kind == "f32-masked":
                values[rng.random(n) < 0.3] = np.inf
                src[rng.random(m) < 0.2] = -1
        if order.startswith("dst-runs"):
            dst = (np.arange(m) // int(order.removeprefix("dst-runs")) % n).astype(np.int32)
        elif order == "src-sorted":
            o = np.argsort(src, kind="stable")
            src, dst, delta = src[o], dst[o], delta[o]
        elif order == "one-dst":
            dst = np.full(m, 7, np.int32)
        return src, dst, delta, values

    kinds = ("f32-mixed", "f32-masked", "i32-wrap")
    cases = {f"{order}/{kind}/200003": case(order, kind, 200_003) for kind in kinds
             for order in ("random", "dst-runs5", "dst-runs32", "dst-runs77", "src-sorted")}
    cases.update({f"random/{kind}/{m}": case("random", kind, m) for kind in kinds
                  for m in (0, 1, 31, 33)})
    cases.update({f"one-dst/{kind}/1048579": case("one-dst", kind, 1_048_579)
                  for kind in ("f32-masked", "i32-wrap")})
    return cases


def phase_edge_update_vs_plain(dev, graphs: dict, lay_min) -> int:
    """Edge-update kernel == plain, bit for bit, on the same CUDA tensors;
    returns the max abs error (0, or the script has already failed).  Every
    case runs through the wrapper and at forced plans (``_launch`` planned
    for 1 and 3 resident blocks: four edges a lane past 256 and 768 edges,
    many rounds a warp); the adversarial cases also from one edge in (the
    arrays then not 16-byte aligned, so the kernel loads an edge at a
    time)."""
    import numpy as np
    import torch

    from repro_torch.graph.problems import PROBLEMS, reference_solve
    from repro_torch.kernels.edge_update import edge_update, edge_update_plain
    from repro_torch.kernels.edge_update.edge_update import _launch

    rng = np.random.default_rng(2025)
    n, m = 100_000, 1_000_000
    src = rng.integers(0, n, size=m).astype(np.int32)
    src[rng.random(m) < 0.05] = -1  # skipped edges
    dst = rng.integers(0, n // 2, size=m).astype(np.int32)  # upper half empty
    vf = (rng.standard_normal(n) * 10).astype(np.float32)  # negative values too
    vf[rng.random(n) < 0.3] = np.inf  # unreached sources
    df = (rng.standard_normal(m) * 3).astype(np.float32)
    vi = rng.integers(0, 1000, size=n).astype(np.int32)
    vi[rng.random(n) < 0.3] = np.iinfo(np.int32).max  # saturated sources
    di = rng.integers(-5, 6, size=m).astype(np.int32)
    on = lambda *arrays: [torch.from_numpy(a).to(dev) for a in arrays]  # noqa: E731
    cases = [("random-f32", *on(src, dst, df, vf)), ("random-i32", *on(src, dst, di, vi))]
    # the real lj HitGraph layout, mid-BFS: levels with 40% of vertices
    # unreached and 30% of edges masked, as update filtering does
    g = graphs["lj"]
    levels, _ = reference_solve(g, PROBLEMS["bfs"], graph_spec("lj").root, device=dev)
    levels[rng.random(g.n) < 0.4] = np.inf
    kept = torch.from_numpy(rng.random(lay_min["src"].shape[0]) < 0.7).to(dev)
    cases.append(("lj/hitgraph/bfs", torch.where(kept, lay_min["src"], -1),
                  lay_min["dst"], lay_min["delta"], *on(levels)))
    for label, arrays in edge_update_cases(rng).items():
        s, d, dl, v = on(*arrays)
        cases.append((label, s, d, dl, v))
        if len(s) > 1:  # one edge in, on the card: a base off the 16-byte grid
            cases.append((label + "/offset1", s[1:], d[1:], dl[1:], v))
    t0 = time.perf_counter()
    launches = 0
    for label, *args in cases:
        want = edge_update_plain(*args)
        for how, fn in (("wrapper", edge_update),
                        ("1 block", lambda *a: _launch(*a, resident=1)),
                        ("3 blocks", lambda *a: _launch(*a, resident=3))):
            got = fn(*args)
            torch.cuda.synchronize()
            launches += 1
            check(torch.equal(got, want), f"edge_update kernel != plain on {label} ({how}): "
                  f"{int((got != want).sum())} of {got.numel()} differ")
    emit(dict(phase="kernel", kernel="edge_update", cases=len(cases), launches=launches,
              max_abs_err=0, random_shape=[m, n],
              lj_shape=[int(lay_min["src"].shape[0]), g.n],
              seconds=round(time.perf_counter() - t0, 3)))
    return 0


def phase_spmv_vs_plain(dev, layouts: dict) -> float:
    """SpMV kernel against plain on real PageRank ELLs, ``layouts`` by graph
    name as (layout, n): ``lj``, 31 wide (the tiled path), and ``tw``, 52
    wide (the wide-row path).  Returns the max abs error, which should be 0
    (same column order and roundings)."""
    import numpy as np
    import torch

    from repro_torch.kernels.spmv import spmv_coo_plain, spmv_ell, spmv_ell_plain

    t0 = time.perf_counter()
    worst, shapes = 0.0, {}
    for name, (lay_acc, n) in layouts.items():
        idx, val = lay_acc["ell"]
        x = torch.from_numpy(np.random.default_rng(7).random(n).astype(np.float32)).to(dev)
        got = spmv_ell(idx, val, x)
        want = spmv_ell_plain(idx, val, x)
        coo = spmv_coo_plain(lay_acc["src"], lay_acc["dst"], lay_acc["w"], x, n)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.equal(got, want),
              f"spmv kernel != plain, bit for bit, on the {name} ELL: max abs err {err}")
        check(torch.allclose(got[:n], coo, rtol=ACC_RTOL, atol=ACC_ATOL),
              f"spmv kernel disagrees with the COO sum on the {name} ELL")
        worst = max(worst, err)
        shapes[name] = list(idx.shape)
    emit(dict(phase="kernel", kernel="spmv", cases=len(layouts), max_abs_err=worst,
              bit_equal=True, ell_shapes=shapes, seconds=round(time.perf_counter() - t0, 3)))
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


def scan_buckets(pending) -> list[int]:
    """Length buckets of the traces ``simulate_batch`` sends to the kernel
    for ``pending``, in increasing order."""
    from repro_torch.core import engine

    return sorted({engine._pow2_bucket(tr.n) for tr in pending.traces()
                   if tr.n and engine.select_engine(tr.n, pending.config.engine,
                                                    pending.config.scan_cutoff) == "scan"})


def largest_bucket(pending) -> int:
    """Length bucket of the longest trace ``simulate_batch`` sends to the
    kernel for ``pending`` (0 if none)."""
    return max(scan_buckets(pending), default=0)


def largest_group(pending, L: int | None = None):
    """The first kernel batch of length bucket ``L`` (default: the largest)
    that ``simulate_batch`` forms for ``pending`` (same dedup, bucketing and
    chunking): (bank, row, lengths, cfg)."""
    import numpy as np

    from repro_torch.core import engine

    L = largest_bucket(pending) if L is None else L
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

    by_bucket: dict = {}  # L -> [(start, end, B)] over the whole phase

    def timed_launch(bank, *args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch(bank, *args, **kw)
        end.record()
        kernel_events.append((start, end))
        by_bucket.setdefault(int(bank.shape[1]), []).append((start, end, int(bank.shape[0])))
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
    # B1's CUDA-event time by length bucket: calls, batch sizes, ms
    buckets = {L: dict(calls=len(ev), batch_sizes=sorted({b for _, _, b in ev}),
                       ms=round(sum(s.elapsed_time(e) for s, e, _ in ev), 4))
               for L, ev in sorted(by_bucket.items())}
    emit(dict(phase="main", scenarios=len(rows), seconds=round(seconds, 3),
              launches=counts["dram_timing"], dispatches=stats["dispatches"],
              traces=stats["traces"], requests=stats["requests"],
              lj_wall_s=round(sum(r["wall_s"] for r in lj), 3),
              lj_host_s=round(sum(r["host_s"] for r in lj), 3),
              lj_kernel_ms=round(sum(r["kernel_ms"] for r in lj), 3),
              kernel_ms=round(sum(b["ms"] for b in buckets.values()), 3),
              kernel_ms_by_bucket=buckets,
              largest_bucket=largest[0], largest_key=largest[1]["key"]))
    pending, _ = prepare(largest[1], graphs)
    return rows, dict(counts=counts, batch=largest_group(pending))


def matrix_ops_estimate(lengths, L: int, segments: int, nbanks: int) -> int:
    """An estimate of the int32 operations the matrix path executes on a
    batch: MATRIX_OPS_PER_COLUMN a request in each of D columns (the
    segments' maps), 2 D^3 a product of two maps (an add and a max per term;
    a group of k live maps takes k - 1), and 3 D^2 a fold step (a compare,
    an add and a max per entry; one a group), with the groups that
    ``csrc/dram_timing.cu::launch_matrix`` forms.  The last-rows pass and
    the open-row scan are left out."""
    D = 2 * nbanks + 2
    seg = -(-L // segments)
    G = 1
    while 3 * G * G < segments:
        G += 1
    G = 1 if G < 3 else G
    ops = 0
    for n in lengths:
        live = min(segments, -(-int(n) // seg))
        steps = -(-live // G)
        ops += MATRIX_OPS_PER_COLUMN * D * int(n) + 2 * D ** 3 * (live - steps) + 3 * D * D * steps
    return ops


def phase_kernel_timing(dev, batch) -> dict:
    """B1 at the path's largest call, whole, against the plain version bit
    for bit.  ``ms`` is the mean of 20 calls back to back (every PR's
    yardstick), ``graph_ms`` the same calls as a replayed CUDA graph."""
    import torch

    from repro_torch.kernels.dram_timing import (
        dram_timing_batch,
        dram_timing_batch_plain,
        plan_segments,
        target_warps,
    )

    bank, row, lengths, cfg = batch
    args = [torch.from_numpy(a).to(dev) for a in (bank, row, lengths)]
    kw = timing_kwargs(cfg)
    ms = cuda_ms(lambda: dram_timing_batch(*args, **kw), reps=20)
    graph = graph_ms(lambda: dram_timing_batch(*args, **kw), reps=20)
    breakdown = device_us_by_kernel(lambda: dram_timing_batch(*args, **kw), reps=5)
    got = dram_timing_batch(*args, **kw)
    t0 = time.perf_counter()
    want = dram_timing_batch_plain(*args, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = int((got.long() - want.long()).abs().max())
    check(torch.equal(got, want), f"kernel != plain at the largest bucket: max err {err}")
    B, L = bank.shape
    segments = plan_segments(B, L, warps=target_warps(dev), **{
        k: kw[k] for k in ("nbanks", "tRCD", "tRP", "tRC", "tBL", "lookahead")})
    requests = int(lengths.sum())
    nbytes = 8 * requests + 4 * B + 16 * B
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = OPS_PER_REQUEST * requests / PEAK_SCALAR_OPS_PER_S * 1e3
    return dict(ms=ms, graph_ms=graph, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                segments=segments,
                matrix_ops_estimate=(matrix_ops_estimate(lengths, L, segments, cfg.nbanks)
                                     if segments > 1 else None),
                kernel_us_per_call=breakdown,
                longest_trace_requests=int(lengths.max()),
                max_abs_err=err, shape=[B, L], requests=requests)


def device_pairs() -> list[tuple[str, str]]:
    from repro_torch.core import semexec

    return [(a, p) for a, probs in sorted(semexec.SUPPORTED.items()) for p in sorted(probs)]


class KernelRecorder:
    """Times every wrapper call the path makes, with CUDA events around the
    port's own call sites (the wrappers still do the counting) and a host
    clock inside them, and keeps a copy of the inputs of each kernel's
    largest call (the first of equal sizes) and, when ``capture`` names
    one, of one edge-update call."""

    SITES = {  # kernel -> (module path, attribute, size of a call's inputs)
        "dram_timing": ("repro_torch.core.engine", "dram_timing_batch",
                        lambda bank, *a, **k: bank.numel()),
        "edge_update": ("repro_torch.kernels.edge_update.ops", "edge_update",
                        lambda src, *a, **k: src.numel()),
        "spmv": ("repro_torch.kernels.spmv.ops", "spmv_ell",
                 lambda idx, *a, **k: idx.numel()),
        "attention": ("repro_torch.models.attention", "flash_attention",
                      lambda q, *a, **k: q.numel()),
    }

    def __init__(self):
        # (kernel, start, end, size of the call's inputs, host s in the call)
        self.events: list = []
        self.largest: dict = {}
        self.pair: str | None = None  # the pair now running
        self.edge_sizes: dict = {}  # pair -> the size of each edge-update call
        self.capture: tuple | None = None  # (pair, i): keep its i-th edge-update call
        self.captured: list | None = None  # the inputs of that call
        self._saved: list = []

    def __enter__(self):
        import importlib

        import torch

        for name, (mod, attr, size_of) in self.SITES.items():
            module = importlib.import_module(mod)
            fn = getattr(module, attr)
            self._saved.append((module, attr, fn))

            def timed(*args, _name=name, _fn=fn, _size=size_of, **kw):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                t0 = time.perf_counter()
                out = _fn(*args, **kw)
                host_s = time.perf_counter() - t0
                end.record()
                size = _size(*args)
                self.events.append((_name, start, end, size, host_s))
                if _name != "dram_timing" and size > self.largest.get(_name, (-1,))[0]:
                    self.largest[_name] = (size, [a.clone() for a in args])
                if _name == "edge_update":
                    sizes = self.edge_sizes.setdefault(self.pair, [])
                    if self.capture == (self.pair, len(sizes)):
                        self.captured = [a.clone() for a in args]
                    sizes.append(size)
                return out

            setattr(module, attr, timed)
        return self

    def __exit__(self, *exc):
        for module, attr, fn in self._saved:
            setattr(module, attr, fn)

    def kernel_ms(self) -> dict:
        out = {name: 0.0 for name in self.SITES}
        for name, start, end, *_ in self.events:
            out[name] += start.elapsed_time(end)
        return out


def median_call(sizes: list) -> int:
    """The index of the call at the median of ``sizes`` (sorted stably)."""
    return sorted(range(len(sizes)), key=lambda i: sizes[i])[len(sizes) // 2]


def capture_edge_update(g, root: int, pair: str, index: int) -> list:
    """The inputs of the ``index``-th edge-update call of the device pair
    ``pair`` ("accel/problem") on ``g`` from ``root``, from a run of its
    own (host caches cleared, so that the semantics run again): the path's
    run clones nothing, so the allocations of the clones do not reach its
    timing."""
    import dataclasses

    from repro_torch.configs.graphsim import default_config
    from repro_torch.core import hostcache
    from repro_torch.core.accelerators import run_accelerator
    from repro_torch.graph.problems import PROBLEMS

    accel, prob = pair.split("/")
    hostcache.clear_all()
    with KernelRecorder() as rec:
        rec.pair = pair
        rec.capture = (pair, index)
        run_accelerator(accel, g, PROBLEMS[prob], root, None,
                        dataclasses.replace(default_config(accel), semexec="device"))
    check(rec.captured is not None, f"{pair} made no edge-update call {index}")
    return rec.captured


def phase_main_device(graphs: dict) -> tuple[list[dict], dict]:
    """All 16 device pairs on lj through ``run_accelerator(...,
    AccelConfig(semexec="device"), device=None)``, held against the numpy
    engine on the same card and against the goldens; the launch counts are
    zeroed just before and read just after."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.graphsim import default_config
    from repro_torch.core import hostcache
    from repro_torch.core.accelerators import ACCELERATORS, run_accelerator
    from repro_torch.core.trace import trace_stream_hash
    from repro_torch.graph.problems import PROBLEMS
    from repro_torch.kernels import _platform

    golden = {s["key"]: s for s in json.loads(GOLDEN.read_text())["scenarios"]}
    g, root = graphs["lj"], graph_spec("lj").root
    pairs = device_pairs()
    check(len(pairs) == 16, f"expected 16 device pairs, found {len(pairs)}")

    def config(accel: str, engine: str):
        return dataclasses.replace(default_config(accel), semexec=engine)

    def trace_hash(accel: str, prob: str, engine: str) -> str:
        # the semantic half again: a host-cache hit, no launch
        pending = ACCELERATORS[accel](config(accel, engine)).prepare(
            g, PROBLEMS[prob], root=root, device="cuda")
        return trace_stream_hash(pending.traces())[:16]

    # the numpy engine on the same card: what every device pair must equal
    t0 = time.perf_counter()
    ref = {}
    for accel, prob in pairs:
        rep = run_accelerator(accel, g, PROBLEMS[prob], root, None, config(accel, "numpy"))
        check(rep.layout["engine"] == "numpy", f"{accel}/{prob}: numpy run used {rep.layout['engine']}")
        ref[(accel, prob)] = (rep, trace_hash(accel, prob, "numpy"))
    numpy_s = time.perf_counter() - t0

    hostcache.clear_all()  # the device path pays its own semantic half
    rows = []
    _platform.reset_launches()
    t_phase = time.perf_counter()
    by_bucket: dict = {}  # edge-update calls and ms by power-of-2 edge count
    with KernelRecorder() as rec:
        for accel, prob in pairs:
            rec.events.clear()
            rec.pair = f"{accel}/{prob}"
            t0 = time.perf_counter()
            rep = run_accelerator(accel, g, PROBLEMS[prob], root, None,
                                  config(accel, "device"))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            kms = rec.kernel_ms()
            for name, start, end, size, host_s in rec.events:
                if name == "edge_update":
                    b = by_bucket.setdefault(1 << max(size - 1, 0).bit_length(),
                                             [0, 0.0, 0.0])
                    b[0] += 1
                    b[1] += start.elapsed_time(end)
                    b[2] += host_s * 1e3
            label = f"lj/{accel}/{prob}/{ACCELERATORS[accel].default_dram}"
            want, want_hash = ref[(accel, prob)]
            thash = trace_hash(accel, prob, "device")
            check(rep.layout["engine"] == "device", f"{label}: engine {rep.layout['engine']}")
            check(thash == want_hash, f"{label}: device trace hash {thash} != numpy {want_hash}")
            check(rep.timing.to_dict() == want.timing.to_dict(),
                  f"{label}: timing {rep.timing.to_dict()} != numpy {want.timing.to_dict()}")
            check(rep.iterations == want.iterations,
                  f"{label}: iterations {rep.iterations} != numpy {want.iterations}")
            err = float(np.abs(rep.values.astype(np.float64) - want.values).max()
                        if np.isfinite(want.values).all() else 0.0)
            if PROBLEMS[prob].kind == "min":
                check(values_sha256(rep.values) == values_sha256(want.values),
                      f"{label}: min values are not bit-equal to the numpy engine")
            else:
                check(np.allclose(rep.values, want.values, rtol=ACC_RTOL, atol=ACC_ATOL),
                      f"{label}: acc values not allclose to the numpy engine: {err}")
            if label in golden:
                gold = golden[label]
                check(thash == gold["trace_hash"], f"{label}: trace hash != golden")
                check(rep.timing.to_dict() == gold["timing"], f"{label}: timing != golden")
                check(rep.iterations == gold["iterations"], f"{label}: iterations != golden")
                if prob == "bfs":
                    check(values_sha256(rep.values) == gold["values_sha256"],
                          f"{label}: values != golden")
            kernel_ms = sum(kms.values())
            rows.append(dict(key=label, wall_s=wall, kernel_ms=kernel_ms,
                             host_s=wall - kernel_ms / 1e3,
                             kernel_ms_by_name=kms, iterations=rep.iterations,
                             golden=label in golden, max_abs_err_vs_numpy=err,
                             calls={k: sum(1 for e in rec.events if e[0] == k)
                                    for k in KERNELS}))
    seconds = time.perf_counter() - t_phase
    counts = _platform.launch_counts()
    for name in ("edge_update", "spmv"):
        check(counts[name] > 0, f"the semexec=device path launched no {name} kernel")
        check(counts[name] == sum(r["calls"][name] for r in rows),
              f"{name}: launches {counts[name]} != wrapper calls on the path")
    emit(dict(phase="main_device", pairs=len(rows), goldens=sum(r["golden"] for r in rows),
              seconds=round(seconds, 3), numpy_engine_s=round(numpy_s, 3),
              launches={k: counts[k] for k in KERNELS},
              wall_s=round(sum(r["wall_s"] for r in rows), 3),
              host_s=round(sum(r["host_s"] for r in rows), 3),
              kernel_s=round(sum(r["kernel_ms"] for r in rows) / 1e3, 4),
              kernel_ms_by_name={k: round(sum(r["kernel_ms_by_name"][k] for r in rows), 3)
                                 for k in KERNELS},
              edge_update_by_edges={str(b): [c, round(ms, 4), round(host_ms, 4)]
                                    for b, (c, ms, host_ms) in sorted(by_bucket.items())}))
    sizes = rec.edge_sizes[FOREGRAPH_PAIR]
    foregraph_call = capture_edge_update(g, root, FOREGRAPH_PAIR, median_call(sizes))
    return rows, dict(counts=counts, largest=rec.largest, foregraph_call=foregraph_call,
                      foregraph_sizes=sizes,
                      edge_update_by_edges={b: v for b, v in sorted(by_bucket.items())})


def edge_update_library(args):
    """The library yardstick of B2: torch's own amin scatter from the same
    candidates (computed outside the timed call) into a sentinel base."""
    import torch

    from repro_torch.kernels.edge_update import sentinel_max

    src, dst, delta, values = args
    top = sentinel_max(values.dtype)
    sv = values[src.clamp_min(0).long()]
    cand = torch.where((src >= 0) & (sv != top), sv + delta, top)
    index = dst.clamp_min(0).long()
    base = torch.full_like(values, top)
    return lambda: torch.scatter_reduce(base, 0, index, cand, "amin", include_self=True)


def edge_update_atomics(args, per_lane: int) -> dict:
    """The atomics B2 takes on these inputs: one a live edge in the first
    design (``live_edges``), and in this one a run of equal consecutive dst
    with a live edge in each round of ``32 * per_lane`` edges
    (``runs_with_candidate``; exact where no dst comes back apart within a
    round, as on HitGraph's sorted blocks; a few more where one does)."""
    import torch

    from repro_torch.kernels.edge_update import sentinel_max

    src, dst, _, values = args
    m = src.numel()
    live = (src >= 0) & (values[src.clamp_min(0).long()] != sentinel_max(values.dtype))
    if m == 0:
        return dict(live_edges=0, runs_with_candidate=0)
    start = torch.arange(m, device=src.device) % (32 * per_lane) == 0
    start[1:] |= dst[1:] != dst[:-1]
    run = torch.cumsum(start.long(), 0) - 1
    has = torch.zeros(int(run[-1]) + 1, dtype=torch.long, device=src.device)
    has.index_add_(0, run, live.long())
    return dict(live_edges=int(live.sum()), runs_with_candidate=int((has > 0).sum()))


def enqueue_us(fn, calls: int = ENQUEUE_CALLS, repeats: int = TIMING_ROUNDS) -> dict:
    """Host microseconds a call of ``fn()`` takes to enqueue: a host clock
    around ``calls`` calls with no sync until the end, ``repeats`` times;
    the median and the least (the host's other work adds, never takes
    away)."""
    import statistics

    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) * 1e6 / calls)
        torch.cuda.synchronize()
    return dict(median=statistics.median(times), min=min(times))


def phase_edge_update_timing(args, small_args) -> dict:
    """B2 at the path's largest call and at its typical small call (the
    median size of ``FOREGRAPH_PAIR``'s calls): the kernel and
    ``scatter_reduce`` in turn over 7 rounds, back to back and as a
    replayed graph, each against the plain version bit for bit; the
    profiler's device us of each of its kernels, and the wrapper's host
    enqueue us a call at the small one."""
    import torch

    from repro_torch.kernels.edge_update import edge_update, edge_update_plain
    from repro_torch.kernels.edge_update.edge_update import _DEVICES, launch_plan

    out = {}
    for label, a in (("largest", args), ("foregraph", small_args)):
        library = edge_update_library(a)
        t = alternate_ms({"kernel": lambda a=a: edge_update(*a), "library": library}, reps=50)
        got = edge_update(*a)
        check(torch.equal(got, edge_update_plain(*a)),
              f"edge_update kernel != plain at the {label} call")
        check(torch.equal(library(), got), f"edge_update kernel != torch.scatter_reduce "
              f"at the {label} call")
        m, n = a[0].numel(), a[3].numel()
        nbytes = 12 * m + 8 * n  # src, dst, delta per edge; values in, acc out
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        ops_ms = m / PEAK_SCALAR_OPS_PER_S * 1e3  # one add per edge
        per_lane, blocks, chunk = launch_plan(m, _DEVICES[a[3].device.index][1])
        out[label] = dict(plain_ms=cuda_ms(lambda a=a: edge_update_plain(*a), reps=20),
                          **spread(t), library="torch.scatter_reduce(amin)",
                          bound_ms=max(bytes_ms, ops_ms),
                          bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                          max_abs_err=0, shape=[m, n], bytes=nbytes,
                          plan=dict(per_lane=per_lane, blocks=blocks, chunk=chunk),
                          atomics=edge_update_atomics(a, per_lane),
                          kernel_us_per_call=device_us_by_kernel(
                              lambda a=a: edge_update(*a), reps=20))
    out["foregraph"]["enqueue_us_per_call"] = enqueue_us(
        lambda: edge_update(*small_args))
    return dict(out["largest"], foregraph_call=out["foregraph"])


def ell_to_csr(idx, w, ncols: int):
    """The library yardstick's matrix: the ELL as a torch CSR tensor, built
    outside any timed call.  An ELL row lists its sources in edge order,
    with repeats for multi-edges, while torch's CSR wants each row's columns
    sorted and unique, so the entries go through a coalesced COO tensor
    (repeats summed) first."""
    import torch

    live = idx >= 0
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None].expand_as(idx)[live]
    coo = torch.sparse_coo_tensor(torch.stack([rows, idx[live].long()]), w[live],
                                  size=(idx.shape[0], ncols), check_invariants=True)
    return coo.coalesce().to_sparse_csr()


def phase_spmv_timing(args) -> dict:
    import torch

    from repro_torch.kernels.spmv import spmv_ell, spmv_ell_plain

    idx, w, x = args
    csr = ell_to_csr(idx, w, x.shape[0])
    library = lambda: csr @ x  # noqa: E731
    t = alternate_ms({"kernel": lambda: spmv_ell(*args), "library": library}, reps=50)
    plain_ms = cuda_ms(lambda: spmv_ell_plain(*args), reps=10)
    got = spmv_ell(*args)
    want = spmv_ell_plain(*args)
    err = float((got - want).abs().max())
    check(torch.equal(got, want), f"spmv kernel != plain, bit for bit, at the largest call: {err}")
    check(torch.allclose(library(), got, rtol=ACC_RTOL, atol=ACC_ATOL),
          "spmv kernel disagrees with the CSR mat-vec")
    rows, d = idx.shape
    nbytes = 8 * rows * d + 4 * x.numel() + 4 * rows  # idx + w per slot; x in, y out
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = 2 * rows * d / PEAK_SCALAR_OPS_PER_S * 1e3  # f32 mul + add per slot
    return dict(plain_ms=plain_ms, **spread(t),
                library="torch.sparse_csr_tensor @ x", bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                max_abs_err=err, bit_equal=bool(torch.equal(got, want)),
                shape=[rows, d], bytes=nbytes)


# ---------------------------------------------------------------------------
# the LM serving path and the attention kernel
# ---------------------------------------------------------------------------


def compare_attention(q, k, v, causal: bool, label: str) -> float:
    """Kernel against plain on the same CUDA tensors; returns the max abs
    error, after checking it against the dtype's tolerance."""
    import torch

    from repro_torch.kernels.attention import attention_fwd, attention_plain

    got = attention_fwd(q, k, v, causal=causal)
    want = attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    tol = ATTN_TOL[str(q.dtype).removeprefix("torch.")]
    err = float((got.float() - want.float()).abs().max())
    check(bool(torch.isfinite(got).all()), f"attention kernel gave non-finite values on {label}")
    check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
          f"attention kernel != plain on {label}: max abs err {err} (tolerance {tol})")
    return err


def phase_attention_vs_plain(dev) -> float:
    """Kernel == plain within the reference's tolerances on random inputs."""
    import numpy as np
    import torch

    cases = [(1, 128, 2, 2, 64, True), (2, 256, 4, 2, 64, True),
             (1, 256, 4, 1, 32, True), (2, 384, 8, 8, 128, True),  # tests/test_kernels.py
             (4, 1024, 16, 8, 128, True), (2, 160, 16, 8, 128, True),  # qwen3, ragged S
             (2, 256, 4, 2, 64, False)]  # non-causal
    rng = np.random.default_rng(2026)
    worst = {}
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        for b, s, nq, nkv, hd, causal in cases:
            q, k, v = (torch.from_numpy(rng.standard_normal((b, s, n, hd), np.float32))
                       .to(dev, dtype) for n in (nq, nkv, nkv))
            err = compare_attention(q, k, v, causal, f"{(b, s, nq, nkv, hd)} {dtype} "
                                    f"causal={causal}")
            key = str(dtype).removeprefix("torch.")
            worst[key] = max(worst.get(key, 0.0), err)
    emit(dict(phase="kernel", kernel="attention", cases=2 * len(cases), max_abs_err=worst,
              tolerance=ATTN_TOL, tf32=False, seconds=round(time.perf_counter() - t0, 3)))
    return max(worst.values())


def phase_serve_golden(dev) -> dict:
    """The serving path in f32 on the card against the reference's goldens."""
    import base64

    import numpy as np
    import torch

    from repro_torch.configs.base import ArchConfig
    from repro_torch.interop import lm_params_numpy, load_lm_params
    from repro_torch.models import Model
    from repro_torch.serve.legacy.engine import Request, ServeEngine

    golden = json.loads(SERVE_GOLDEN.read_text())
    tol, near_tie = golden["tolerance"], golden["near_tie"]
    t0 = time.perf_counter()
    out = {}
    for g in golden["configs"]:
        cfg = ArchConfig(**g["config"])
        model = load_lm_params(Model(cfg), lm_params_numpy(cfg, g["weight_seed"]))
        prompts = np.asarray(g["prompts"], np.int32)
        tokens = np.asarray(g["tokens"], np.int32)
        want = np.frombuffer(base64.b64decode(g["logits_f32_b64"]),
                             np.float32).reshape(g["logits_shape"])
        n, max_new = tokens.shape
        s = prompts.shape[1]
        cache = model.init_cache(n, s + max_new)
        logits, cache = model.prefill({"tokens": torch.from_numpy(prompts).to(dev)}, cache)
        err = 0.0
        for step in range(max_new):
            got = logits[:, -1, : cfg.vocab].float().cpu().numpy()
            err = max(err, float(np.abs(got - want[:, step]).max()))
            check(np.allclose(got, want[:, step], rtol=tol, atol=tol),
                  f"serve golden {g['name']}: step {step} logits differ by {err} (tolerance {tol})")
            if step + 1 < max_new:
                nxt = torch.from_numpy(tokens[:, step:step + 1]).to(dev)
                logits, cache = model.decode_step(nxt, cache, s + step)
        served = ServeEngine(model, batch=n, max_seq=s + max_new).run(
            [Request(rid=i, prompt=p, max_new=max_new) for i, p in enumerate(prompts)])
        check(len(served) == n, f"serve golden {g['name']}: {len(served)} of {n} answered")
        margins = np.asarray(g["margins"])
        ties = compared = 0
        for r in served:
            tie_steps = np.flatnonzero(margins[r.rid] <= near_tie)
            upto = int(tie_steps[0]) if len(tie_steps) else max_new
            ties += len(tie_steps)
            compared += upto
            check(r.out[:upto].tolist() == tokens[r.rid, :upto].tolist(),
                  f"serve golden {g['name']}: request {r.rid} tokens {r.out.tolist()} "
                  f"!= {tokens[r.rid].tolist()}")
        out[g["name"]] = dict(max_abs_err=err, near_ties=ties, tokens_compared=compared,
                              tokens=n * max_new)
        del model, cache
    emit(dict(phase="serve_golden", configs=out, tolerance=tol, near_tie=near_tie,
              dtype="float32", seconds=round(time.perf_counter() - t0, 3)))
    return out


def phase_serve(dev, card: str) -> dict:
    """Full-width qwen3_0_6b in bf16 through ``ServeEngine.run``; the launch
    counts are zeroed just before the run and read just after."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import _platform
    from repro_torch.models import Model
    from repro_torch.serve.legacy.engine import Request, ServeEngine

    cfg = get_arch(SERVE_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(2026)
    prompts = [rng.integers(0, cfg.vocab, SERVE_PROMPT).astype(np.int32)
               for _ in range(SERVE_REQUESTS)]
    engine = ServeEngine(model, batch=SERVE_BATCH, max_seq=SERVE_MAX_SEQ)
    # set-up: one short wave warms cuBLAS and the lazily loaded kernels
    engine.run([Request(rid=0, prompt=prompts[0][:64], max_new=2)])

    phases: list = []  # (kind, seconds) of every prefill / decode call
    prefill, decode = engine.prefill, engine.decode

    def timed(kind, fn):
        def call(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            phases.append((kind, time.perf_counter() - t))
            return out
        return call

    engine.prefill, engine.decode = timed("prefill", prefill), timed("decode", decode)
    requests = [Request(rid=i, prompt=p, max_new=SERVE_NEW) for i, p in enumerate(prompts)]
    waves = -(-SERVE_REQUESTS // SERVE_BATCH)
    with KernelRecorder() as rec:
        _platform.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = engine.run(requests)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _platform.launch_counts()
    attn_ms = rec.kernel_ms()["attention"]
    calls = sum(1 for e in rec.events if e[0] == "attention")
    engine.prefill, engine.decode = prefill, decode
    check(sorted(r.rid for r in done) == list(range(SERVE_REQUESTS)),
          f"served {len(done)} of {SERVE_REQUESTS} requests")
    for r in done:
        check(r.out is not None and len(r.out) == SERVE_NEW,
              f"request {r.rid}: {None if r.out is None else len(r.out)} tokens")
        check(bool(np.all((r.out >= 0) & (r.out < cfg.vocab))),
              f"request {r.rid}: a token outside [0, {cfg.vocab})")
    check(counts["attention"] == cfg.n_layers * waves,
          f"attention launches {counts['attention']} != {cfg.n_layers} layers x {waves} waves")
    check(counts["attention"] == calls,
          f"attention launches {counts['attention']} != calls on the path {calls}")

    # the card's twin of tests/test_serving.py's stepwise greedy check
    by_rid = {r.rid: r.out.tolist() for r in done}
    for w in range(waves):
        wave = prompts[w * SERVE_BATCH:(w + 1) * SERVE_BATCH]
        cache = model.init_cache(SERVE_BATCH, SERVE_MAX_SEQ)
        toks = torch.from_numpy(np.stack(wave)).to(dev)
        logits, cache = model.prefill({"tokens": toks}, cache)
        outs = [[] for _ in wave]
        for step in range(SERVE_NEW):
            cur = torch.argmax(logits[:, -1, : cfg.vocab], dim=-1)
            for i, t in enumerate(cur.tolist()):
                outs[i].append(t)
            logits, cache = model.decode_step(cur.to(torch.int32)[:, None], cache,
                                              SERVE_PROMPT + step)
        for i, o in enumerate(outs):
            check(by_rid[w * SERVE_BATCH + i] == o,
                  f"request {w * SERVE_BATCH + i}: engine tokens != stepwise greedy")

    prefill_s = sum(t for k, t in phases if k == "prefill")
    decode_s = sum(t for k, t in phases if k == "decode")
    decode_steps = sum(1 for k, _ in phases if k == "decode")
    info = dict(arch=cfg.arch, dtype=cfg.dtype, n_layers=cfg.n_layers, params=params,
                requests=SERVE_REQUESTS, batch=SERVE_BATCH, waves=waves,
                prompt_tokens=SERVE_PROMPT, new_tokens=SERVE_NEW, wall_s=wall,
                wall_per_wave_s=wall / waves, prefill_s=prefill_s, decode_s=decode_s,
                prefill_tok_per_s=waves * SERVE_BATCH * SERVE_PROMPT / prefill_s,
                decode_tok_per_s=decode_steps * SERVE_BATCH / decode_s,
                decode_steps=decode_steps, attention_ms=attn_ms,
                attention_share_of_prefill=attn_ms / 1e3 / prefill_s,
                launches=counts["attention"], init_s=init_s,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit(dict(phase="serve", card=card, **{k: round(v, 6) if isinstance(v, float) else v
                                           for k, v in info.items()}))

    # the kernel against its plain version on the real q/k/v of layer 0 of
    # wave 1 (every call has one size, so the recorder kept the first)
    q, k, v = rec.largest["attention"][1]
    causal = True  # dense prefill self-attention
    info["real_qkv_err"] = compare_attention(q, k, v, causal, "the serve path's layer 0")
    emit(dict(phase="kernel", kernel="attention", case="serve layer 0, wave 1",
              shape=[list(q.shape), list(k.shape)], dtype=str(q.dtype),
              max_abs_err=info["real_qkv_err"], tolerance=ATTN_TOL["bfloat16"]))
    info["largest"] = (q, k, v, causal)
    del model, engine
    torch.cuda.empty_cache()
    return info


def phase_attention_timing(q, k, v, causal: bool) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.attention import attention_fwd, attention_plain

    # the library yardstick, on (B, H, S, D) views of the same tensors
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=causal, enable_gqa=True)
    t = alternate_ms({"kernel": lambda: attention_fwd(q, k, v, causal=causal),
                      "library": library}, reps=20)
    plain_ms = cuda_ms(lambda: attention_plain(q, k, v, causal=causal), reps=10)
    got = attention_fwd(q, k, v, causal=causal)
    want = attention_plain(q, k, v, causal=causal)
    tol = ATTN_TOL[str(q.dtype).removeprefix("torch.")]
    err = float((got.float() - want.float()).abs().max())
    check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
          f"attention kernel != plain at the largest call: {err}")
    lib = library().transpose(1, 2).float()
    lib_err = float((lib - got.float()).abs().max())
    check(torch.allclose(lib, got.float(), rtol=2 * tol, atol=2 * tol),
          f"attention kernel disagrees with SDPA: {lib_err}")
    b, s, nq, hd = q.shape
    nkv = k.shape[2]
    pairs = b * nq * (s * (s + 1) // 2 if causal else s * s)  # (query, key) pairs
    flops = 4 * hd * pairs  # QK^T and PV, a multiply and an add each
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_BF16_OPS_PER_S * 1e3
    return dict(plain_ms=plain_ms, **spread(t),
                library="torch.nn.functional.scaled_dot_product_attention"
                        "(is_causal, enable_gqa)",
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                max_abs_err=err, library_max_abs_err=lib_err,
                shape=[b, s, nq, nkv, hd], dtype=str(q.dtype), flops=flops, bytes=nbytes)


def phase_sass(lib: Path) -> dict:
    """Whether the built attention library's SASS holds ``ATTENTION_SASS``
    (wgmma and TMA loads), as ``cuobjdump -sass`` shows it.  Without
    ``cuobjdump`` it says "not checked" and does not pass; with it, a missing
    opcode fails the run."""
    import shutil

    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump")
    if tool is None:
        cand = Path(_build.find_nvcc()).parent / "cuobjdump"
        tool = str(cand) if cand.exists() else None
    if tool is None:
        info = dict(phase="sass", kernel="attention", checked="not checked", passed=False,
                    reason="cuobjdump not found")
        emit(info)
        return info
    proc = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300)
    check(proc.returncode == 0, f"cuobjdump -sass failed: {proc.stderr.strip()[-500:]}")
    counts = {op: proc.stdout.count(op) for op in ATTENTION_SASS}
    info = dict(phase="sass", kernel="attention", checked=True,
                passed=all(counts.values()), counts=counts, tool=tool)
    emit(info)
    check(info["passed"], f"the attention library's SASS lacks {ATTENTION_SASS}: {counts}")
    return info


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    if not (ROOT / "src" / "repro_torch").is_dir() or not GOLDEN.exists() \
            or not SERVE_GOLDEN.exists():
        fail(f"run from the repository root: {ROOT} holds no src/repro_torch")
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda")
    # every float32 matmul and convolution in full f32: TF32 keeps ~3 digits,
    # too few for the attention and serve_golden tolerances
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit(dict(phase="device", nvidia_smi=smi, name=kind,
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda, python=sys.version.split()[0]))

    # 2. build: one nvcc per source, all started together
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        libs = dict(zip(KERNELS, pool.map(lambda k: _build.build(k, verbose=True), KERNELS)))
    for name in KERNELS:
        _build.load(name)
        lib = libs[name]
        emit(dict(phase="build", kernel=name, library=str(lib.relative_to(ROOT))
                  if lib.is_relative_to(ROOT) else str(lib),
                  seconds=round(time.perf_counter() - t0, 3)))

    sass = phase_sass(libs["attention"])

    # graph generation is set-up, not the path
    graphs = {name: graph_spec(name).build() for name in ("lj", "tiny", "tw")}

    # 3. kernels vs plain (on the real lj batch and layouts among others)
    pending, _ = prepare(dict(graph="lj", accelerator="hitgraph", problem="bfs",
                              dram="hitgraph", mapping="row", page_policy="open",
                              pseudo_channels=False), graphs)
    worst = {"dram_timing": phase_kernel_vs_plain(dev, largest_group(pending))}
    lay_min, lay_acc = lj_device_layouts(graphs, dev)
    worst["edge_update"] = phase_edge_update_vs_plain(dev, graphs, lay_min)
    tw = graphs.pop("tw")  # only for the wide-row SpMV check
    worst["spmv"] = phase_spmv_vs_plain(dev, {"lj": (lay_acc, graphs["lj"].n),
                                              "tw": (pr_layout(tw, dev), tw.n)})
    worst["attention"] = phase_attention_vs_plain(dev)
    del lay_min, lay_acc, tw

    # 4. main path (numpy semantics)
    rows, info = phase_main(graphs)

    # 5. the semexec="device" path
    device_rows, device_info = phase_main_device(graphs)

    # 6. the LM serving path in f32 against the reference's goldens
    serve_golden = phase_serve_golden(dev)

    # 7. the LM serving path at full size
    serve = phase_serve(dev, smi)
    worst["attention"] = max(worst["attention"], serve["real_qkv_err"])

    # 8. kernel timing at each path's largest call
    timing = {"dram_timing": phase_kernel_timing(dev, info["batch"]),
              "edge_update": phase_edge_update_timing(
                  device_info["largest"]["edge_update"][1], device_info["foregraph_call"]),
              "spmv": phase_spmv_timing(device_info["largest"]["spmv"][1]),
              "attention": phase_attention_timing(*serve.pop("largest"))}
    launches = {"dram_timing": info["counts"]["dram_timing"],
                "edge_update": device_info["counts"]["edge_update"],
                "spmv": device_info["counts"]["spmv"],
                "attention": serve["launches"]}
    for name in KERNELS:
        emit(dict(phase="kernel_timing", kernel=name, launches=launches[name],
                  **timing[name]))

    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        dict(card=smi, scenarios=rows, device_pairs=device_rows,
             serve_golden=serve_golden, serve=serve, kernel_timing=timing,
             attention_sass=sass),
        indent=1) + "\n")

    replaces = {"dram_timing": "src/repro/kernels/dram_timing/dram_timing.py:120",
                "edge_update": "src/repro/kernels/edge_update/edge_update.py:53",
                "spmv": "src/repro/kernels/spmv/spmv.py:36",
                "attention": "src/repro/kernels/attention/attention.py:79"}
    emit(dict(kernels=[dict(
        name=name, route="cuda", source=f"src/repro_torch/csrc/{name}.cu",
        replaces=replaces[name], launches=launches[name],
        max_abs_err=max(worst[name], timing[name]["max_abs_err"]),
        ms=timing[name]["ms"], plain_ms=timing[name]["plain_ms"],
        bound_ms=timing[name]["bound_ms"], bound_by=timing[name]["bound_by"],
        library_ms=timing[name].get("library_ms"), shape=timing[name]["shape"],
        **{key: timing[name][key] for key in EXTRA_KEYS if key in timing[name]},
        card=smi) for name in KERNELS]))
    print(smi, flush=True)
    emit(dict(ok=True, device=dict(platform="gpu", kind=kind,
                                   count=torch.cuda.device_count())))


if __name__ == "__main__":
    main()
