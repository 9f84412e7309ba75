#!/usr/bin/env python3
"""Times the DRAM timing (B1), edge-update (B2), SpMV (B3) and attention (B4)
kernels of two checkouts of this repository in turn on one CUDA card, each
beside its library call where one exists.

    git archive <rev> | tar -x -C build/base     # a gitignored directory
    python3 kernel_ab.py --base build/base

Run from the repository root on a machine with a CUDA card and ``nvcc``.
One child process per tree, in the order base, this tree, this tree, base,
so that a drift of the card's clocks reaches both alike.  Each child puts
its tree's ``src`` first on the path, builds that tree's ``dram_timing.cu``,
``edge_update.cu``, ``spmv.cu`` and ``attention.cu`` with that tree's
``kernels/_build.py`` (into that tree's ``build/``), and times on the same
seeded inputs:

- ``dram_timing_batch`` on the main path's largest call (the first batch of
  the largest length bucket of ``lj/foregraph/bfs`` on its own preset, as
  ``chip_smoke.py`` phase ``kernel_timing`` takes it), as the wrapper
  chooses and walked one request after another (``_launch`` at one segment
  where the tree has it), and on the path's largest call of its shortest
  bucket (``tiny/hitgraph/bfs`` on ``default``, [32, 256], which every
  tree walks); its output must be the same bit for bit in every child
  and case of one batch (no PyTorch call computes it);
- ``edge_update`` at the ``semexec="device"`` path's largest call (the first
  of ``lj/hitgraph/wcc``, 1,784,584 edges) and at its typical small call
  (the call of median size of ``lj/foregraph/bfs``, 10,209 edges), both
  taken from the tree's own run of those pairs through ``chip_smoke``'s
  recorder; checked bit for bit against ``edge_update_plain``, beside
  ``torch.scatter_reduce(amin)``, with each kernel's device us a call
  (``torch.profiler``) and, at the small call, the wrapper's host enqueue us
  a call (1,000 calls, no sync until the end);
- ``spmv_ell`` on the PageRank ELL of the paper graphs ``lj`` (75,008 x 31)
  and ``tw`` (65,536 x 52), as the ``semexec="device"`` path builds it,
  checked bit for bit against ``spmv_ell_plain``, beside the CSR mat-vec;
- ``attention_fwd`` in bf16 at the serving path's call (B 4, S 1,024, 16/8
  heads, hd 128, causal; seeded normal q/k/v), checked against
  ``attention_plain``, beside ``F.scaled_dot_product_attention``.

Each case is timed by ``chip_smoke.alternate_ms``: kernel and library in
turn over ``--rounds`` rounds, each round back to back from the host
(``ms``) and as a replayed CUDA graph (``graph_ms``); median, min and max.
One JSON line per child on stdout, then the card, then a summary by tree
and case.  Everything also goes to ``chiprun_out/kernel_ab.json``.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "kernel_ab.json"
SPMV_GRAPHS = ("lj", "tw")
ATTN_SHAPE = (4, 1024, 16, 8, 128)  # B, S, query heads, kv heads, head dim
REPS = {"dram_timing": 5, "dram_timing/short": 50, "edge_update": 50, "spmv": 50,
        "attention": 20}
# the device pairs whose edge-update calls B2 is timed at: the path's
# largest call is the first of the first, its typical one the median of the
# second's (chip_smoke.FOREGRAPH_PAIR)
B2_PAIRS = (("hitgraph", "wcc"), ("foregraph", "bfs"))
# the scenarios whose largest kernel call (of their largest and of their
# shortest length bucket) B1 is timed at
B1_SCENARIO = dict(graph="lj", accelerator="foregraph", problem="bfs", dram="foregraph",
                   mapping="row", page_policy="open", pseudo_channels=False)
B1_SHORT_SCENARIO = dict(graph="tiny", accelerator="hitgraph", problem="bfs", dram="default",
                         mapping="row", page_policy="open", pseudo_channels=False)


def sha(t) -> str:
    """Short sha256 of a tensor's bytes (inputs must match across trees)."""
    import torch

    return hashlib.sha256(t.cpu().contiguous().view(-1).view(torch.uint8)
                          .numpy().tobytes()).hexdigest()[:16]


def child(tree: Path, rounds: int) -> dict:
    """Times one tree's kernels; returns its line."""
    sys.path.insert(0, str(tree / "src"))
    import dataclasses

    import numpy as np
    import torch
    import torch.nn.functional as F

    import chip_smoke
    import repro_torch
    from repro_torch.core import semexec
    from repro_torch.graph.generators import PAPER_GRAPHS
    from repro_torch.kernels import _build
    from repro_torch.configs.graphsim import default_config
    from repro_torch.core.accelerators import run_accelerator
    from repro_torch.graph.problems import PROBLEMS
    from repro_torch.kernels.attention import attention_fwd, attention_plain
    import repro_torch.kernels.dram_timing.dram_timing as b1
    from repro_torch.kernels.dram_timing import dram_timing_batch
    from repro_torch.kernels.edge_update import edge_update, edge_update_plain
    from repro_torch.kernels.spmv import spmv_ell, spmv_ell_plain
    from repro_torch.kernels.spmv.spmv import to_ell

    chip_smoke.check(Path(repro_torch.__file__).resolve().is_relative_to(tree.resolve()),
                     f"repro_torch came from {repro_torch.__file__}, not {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:  # one nvcc each, started together
        list(pool.map(_build.load, ("dram_timing", "edge_update", "spmv", "attention")))
    build_s = time.perf_counter() - t0
    line = dict(tree=str(tree), build_s=build_s, cases={})

    graphs = {name: PAPER_GRAPHS[name].build() for name in SPMV_GRAPHS}
    graphs["tiny"] = chip_smoke.graph_spec("tiny").build()
    pending, _ = chip_smoke.prepare(B1_SCENARIO, graphs)
    short, _ = chip_smoke.prepare(B1_SHORT_SCENARIO, graphs)
    # the largest call walked one request after another: a tree with
    # ``_launch`` walks at one segment, an older one walks in its wrapper
    walk = ((lambda *a, **k: b1._launch(*a, 1, **k)) if hasattr(b1, "_launch")
            else dram_timing_batch)
    for case, batch, fn, reps in (
            ("dram_timing/lj", chip_smoke.largest_group(pending), dram_timing_batch,
             REPS["dram_timing"]),
            ("dram_timing/lj/walk", chip_smoke.largest_group(pending), walk,
             REPS["dram_timing"]),
            ("dram_timing/tiny/256", chip_smoke.largest_group(
                short, min(chip_smoke.scan_buckets(short))), dram_timing_batch,
             REPS["dram_timing/short"])):
        bank, row, lengths, cfg = batch
        args = [torch.from_numpy(a).to(dev) for a in (bank, row, lengths)]
        kw = chip_smoke.timing_kwargs(cfg)
        got = fn(*args, **kw)
        t = chip_smoke.alternate_ms({"kernel": lambda: fn(*args, **kw)},
                                    reps=reps, rounds=rounds)
        line["cases"][case] = dict(
            shape=list(bank.shape), inputs=sha(args[0]) + sha(args[1]) + sha(args[2]),
            output=sha(got), kernel=t["kernel"]["eager"], graph_kernel=t["kernel"]["graph"])

    g = graphs["lj"]
    with chip_smoke.KernelRecorder() as rec:
        for accel, prob in B2_PAIRS:
            rec.pair = f"{accel}/{prob}"
            run_accelerator(accel, g, PROBLEMS[prob], chip_smoke.graph_spec("lj").root, None,
                            dataclasses.replace(default_config(accel), semexec="device"))
    small = chip_smoke.capture_edge_update(
        g, chip_smoke.graph_spec("lj").root, chip_smoke.FOREGRAPH_PAIR,
        chip_smoke.median_call(rec.edge_sizes[chip_smoke.FOREGRAPH_PAIR]))
    for case, a in (("edge_update/lj/largest", rec.largest["edge_update"][1]),
                    ("edge_update/lj/foregraph", small)):
        got = edge_update(*a)
        chip_smoke.check(torch.equal(got, edge_update_plain(*a)),
                         f"{tree}: edge_update kernel != plain, bit for bit, at {case}")
        t = chip_smoke.alternate_ms({"kernel": lambda a=a: edge_update(*a),
                                     "library": chip_smoke.edge_update_library(a)},
                                    reps=REPS["edge_update"], rounds=rounds)
        line["cases"][case] = dict(
            shape=[a[0].numel(), a[3].numel()], inputs="".join(sha(x) for x in a),
            output=sha(got), kernel_us=chip_smoke.device_us_by_kernel(
                lambda a=a: edge_update(*a), reps=20),
            **({"enqueue_us": chip_smoke.enqueue_us(lambda a=a: edge_update(*a))}
               if case.endswith("foregraph") else {}),
            **{f"{prefix}{who}": t[who][kind] for who in ("kernel", "library")
               for kind, prefix in (("eager", ""), ("graph", "graph_"))})
    del rec, small

    for gname in SPMV_GRAPHS:
        g = graphs[gname]
        w_eff = semexec._acc_weight("pr", g.src, None, g.degrees_out)
        idx, val = (torch.from_numpy(a).to(dev) for a in to_ell(g.src, g.dst, w_eff, g.n))
        x = torch.from_numpy(np.random.default_rng(7).random(g.n).astype(np.float32)).to(dev)
        csr = chip_smoke.ell_to_csr(idx, val, g.n)
        got, want = spmv_ell(idx, val, x), spmv_ell_plain(idx, val, x)
        chip_smoke.check(torch.equal(got, want),
                         f"{tree}: spmv kernel != plain, bit for bit, on {gname}")
        t = chip_smoke.alternate_ms({"kernel": lambda: spmv_ell(idx, val, x),
                                     "library": lambda: csr @ x},
                                    reps=REPS["spmv"], rounds=rounds)
        line["cases"][f"spmv/{gname}"] = dict(
            shape=list(idx.shape), inputs=sha(idx) + sha(val) + sha(x), bit_equal=True,
            **{f"{prefix}{who}": t[who][kind] for who in ("kernel", "library")
               for kind, prefix in (("eager", ""), ("graph", "graph_"))})

    b, s, nq, nkv, hd = ATTN_SHAPE
    rng = np.random.default_rng(2026)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, n, hd), np.float32))
               .to(dev, torch.bfloat16) for n in (nq, nkv, nkv))
    got, want = attention_fwd(q, k, v, causal=True), attention_plain(q, k, v, causal=True)
    tol = chip_smoke.ATTN_TOL["bfloat16"]
    err = float((got.float() - want.float()).abs().max())
    chip_smoke.check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
                     f"{tree}: attention kernel != plain: {err}")
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    t = chip_smoke.alternate_ms(
        {"kernel": lambda: attention_fwd(q, k, v, causal=True),
         "library": lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                            enable_gqa=True)},
        reps=REPS["attention"], rounds=rounds)
    line["cases"]["attention/qwen3"] = dict(
        shape=list(ATTN_SHAPE), inputs=sha(q) + sha(k) + sha(v), max_abs_err=err,
        **{f"{prefix}{who}": t[who][kind] for who in ("kernel", "library")
           for kind, prefix in (("eager", ""), ("graph", "graph_"))})
    return line


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", type=Path, help="unpacked checkout to compare with this one")
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)  # a child's tree
    args = ap.parse_args()
    if args.one is not None:
        print(json.dumps(child(args.one, args.rounds)), flush=True)
        return

    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_ab: no CUDA device (torch.cuda.is_available() is false)")
    if args.base is None or not (args.base / "src" / "repro_torch").is_dir():
        sys.exit(f"kernel_ab: --base must be a checkout holding src/repro_torch, "
                 f"got {args.base}")
    if not (ROOT / "src" / "repro_torch").is_dir():
        sys.exit(f"kernel_ab: run from the repository root: {ROOT} holds no src/repro_torch")
    trees = {"base": args.base.resolve(), "this": ROOT}
    lines = []
    for label in ("base", "this", "this", "base"):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--one",
                               str(trees[label]), "--rounds", str(args.rounds)],
                              capture_output=True, text=True, cwd=ROOT, timeout=900)
        if proc.returncode != 0:
            sys.exit(f"kernel_ab: the {label} child failed:\n{proc.stderr[-3000:]}")
        line = dict(label=label, **json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(line), flush=True)
        lines.append(line)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    summary = {case: {label: {key: [ln["cases"][case][key]["median"] for ln in lines
                                    if ln["label"] == label]
                              for key in ("kernel", "library", "graph_kernel", "graph_library")
                              if key in lines[0]["cases"][case]}
                      for label in trees}
               for case in lines[0]["cases"]}
    for case, by_tree in summary.items():  # B2's profiler split and host enqueue
        for label, row in by_tree.items():
            for key in ("kernel_us", "enqueue_us"):
                if key in lines[0]["cases"][case]:
                    row[key] = [ln["cases"][case][key] for ln in lines if ln["label"] == label]
    for case in summary:
        inputs = {ln["cases"][case]["inputs"] for ln in lines}
        if len(inputs) != 1:
            sys.exit(f"kernel_ab: the trees saw different inputs for {case}")
        outputs = {ln["cases"][case].get("output") for ln in lines}
        if len(outputs) != 1:
            sys.exit(f"kernel_ab: the trees' outputs differ for {case}: {outputs}")
    if ({ln["cases"]["dram_timing/lj"]["output"] for ln in lines}
            != {ln["cases"]["dram_timing/lj/walk"]["output"] for ln in lines}):
        sys.exit("kernel_ab: dram_timing's walk and its wrapper's choice differ")
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(dict(card=smi, runs=lines, summary=summary), indent=1) + "\n")
    print(smi, flush=True)
    print(json.dumps(dict(card=smi, summary=summary)), flush=True)


if __name__ == "__main__":
    main()
