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
              3 resident blocks (four edges a lane, many rounds a warp);
              a quarter of the destinations outside [0, n) (-5, -1, n, n + 7),
              random and inside runs of equal dst, f32 and int32.  SpMV,
              bit for bit: the real
              ``lj`` PageRank ELL layout (31 wide, the tiled path) and
              the ``tw`` one (52 wide, the wide-row path).  Attention, within the
              reference's tolerances (2e-5 in f32, 2e-2 in bf16; TF32 is
              off for every matmul): the shape set of
              ``tests/test_kernels.py``, qwen3's heads (16/8, hd 128) at
              S 1,024 and on a ragged S, and non-causal cases at S 256 and
              at S that is not a multiple of the 128-row block (whisper's
              encoder, (4, 1,500, 12/12, hd 64), and (1, 160, 4/2, hd
              64)), in f32 and bf16.
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
6. sweep   -- the sweep runner (``repro_torch.sweep.run_sweep(...,
              device=None)``) on the paper's tab4 (4 accelerators x bfs, pr,
              wcc on DDR4) on ``lj``, each run on a fresh cache under
              ``build/sweep_cache`` with the host caches cleared: scenario
              mode, batch mode and batch mode on 2 spawn workers (each its
              own CUDA context) must give the rows of
              ``tests/data/torch_golden_sweep.json`` (written from the JAX
              reference); the last again on its cache must be all cached
              with no launch; ``engines=("numpy", "device")`` must give
              numpy rows equal to the goldens and device rows equal to them
              but for ``engine`` (every pair of ``semexec.SUPPORTED`` on
              ``device``), launching B1, B2 and B3.  An error row or a
              ``timing_fallback`` record fails.  Printed: seconds per
              scenario of each semantic engine, each alone in scenario mode
              in turns (numpy, device, device, numpy), split into host and
              kernel time by CUDA events around the wrappers; every run's
              wall and launches; the parent's peak device memory.
7. search  -- adaptive search (``repro_torch.sweep.search.run_search(...,
              device=None)``) in this process.  The tiny smoke
              (``bench_search --tiny`` through the port): an exhaustive
              search over the 8 tiny golden scenarios with trace hashes on
              must match ``benchmarks/golden_hashes_tiny.json``, its probe
              rows ``run_sweep``'s, and a warm re-search must execute and
              launch nothing.  On ``lj``: ``bench_search``'s
              controller-sensitivity space (64 points) as a full grid in
              batch mode, then seeds 0-2 at a quarter of it (batches of 3),
              each on a fresh cache with the host caches cleared; every
              probe row must equal the grid's.  Printed: the grid's wall and
              optimum, each seed's executions, best, gap and executions to
              the 5% band (not gated on lj), walls and launches.
8. sweep_server -- ``python -m repro_torch.serve --port 0 --port-file
              build/serve_port --cache build/serve_cache --workers 2`` (no
              ``--device``: the card) as a child process, driven through
              ``ServeClient``: (a) tab4 on ``lj`` against the sweep
              goldens; (b) two overlapping jobs at once (numpy and device
              engines; device alone): each unique scenario executes once,
              the rest join or hit the cache, B2 and B3 launch in the
              workers; (c) a search job equal to phase ``search``'s seed 0
              (best, history, executions); (d) (a) again, all cached with
              no launch; SIGTERM, exit 0; (e) a second server whose
              dispatch 1 crashes its worker: a WorkerLost, one respawn,
              (a)'s rows; SIGTERM, exit 0.  An error row or a
              ``timing_fallback`` record fails.  The server's parent must
              open no CUDA context (one more compute app per worker).
              Printed: spawn to port file, to each worker's ``ready`` (its
              CUDA context and kernel load) and to the first row; each
              job's wall, rows/s, executed, joins, hits and the workers'
              launches (``/stats``); ``nvidia-smi --query-compute-apps``
              while the workers are up.  Logs in
              ``chiprun_out/serve_{clean,faults}.log``.
9. multihost -- multi-host serving: ``python -m repro_torch.serve --port 0
              --worker-listen 127.0.0.1:0 --cache build/multihost_cache
              --chunk-size 1 --trace-hashes`` and two worker hosts
              (``python -m repro_torch.serve worker --connect <pool>
              --seats 1 --name h0|h1``) as children, none given
              ``--device`` (the card), so two seats on the one card, each its
              own CUDA context.  (a) the 8 tiny golden scenarios: trace
              hashes equal to ``benchmarks/golden_hashes_tiny.json``, both
              hosts serve chunks, a resubmission all cached with no launch;
              (b) tab4 on ``lj`` against the sweep goldens, B1 launched by
              the hosts (summed in ``/stats``); (c) tab4 with the numpy and
              device engines, B2 and B3 launched by the hosts; ``--shutdown``:
              the request, the server and both hosts exit 0.  Then a second
              server and hosts on ``build/multihost_cache_kill``: (d) tab4
              with h0 SIGKILLed once it holds a chunk, the golden rows and a
              host lost; (e) ``--shutdown``: the server and h1 exit 0.  An
              error row or a ``timing_fallback`` record fails.  The server's
              and the agents' own processes open no CUDA context (one more
              compute app a seat), and every context is gone after the
              phase.  Printed: spawn to the port files, each host's spawn to
              registration and to its seat's ``worker_ready`` (context and
              kernel load), each job's wall, rows/s, chunks by host and
              launches.  Logs in ``chiprun_out/multihost_*.log``.
10. serve_golden -- the LM serving path in f32 on the card against
              ``tests/data/torch_golden_serve.json`` (written from the JAX
              reference): ``qwen3_0_6b.reduced()`` and qwen3 at full width
              cut to 2 layers, the ``reduced()`` qwen2-moe, arctic, jamba
              and rwkv6, rwkv6 at full width cut to 2 layers and qwen2-moe
              at full width cut to 1 layer (60 experts), the ``reduced()``
              whisper and llama-vision, whisper at full width cut to 2
              decoder and 2 encoder layers over 1,500 frames and
              llama-vision at full width cut to one period of 5 layers
              (17.2 GB; the CPU tests skip this and the qwen2-moe cut),
              weights from ``interop.lm_params_numpy``, the stub front
              ends' inputs from ``interop.context_inputs_numpy`` with the
              file's ``stub_seed``.
              Teacher-forced logits of every step within the file's
              tolerance; ``ServeEngine``'s greedy tokens equal up to each
              request's first near-tie (counted and printed, with each MoE
              golden's smallest router top-k gap).
11. serve  -- the LM serving path at full size: ``qwen3_0_6b`` at its
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
12. serve_families -- the MoE, hybrid, SSM, encoder-decoder and
              vision-language families at their published widths in bf16
              through ``ServeEngine(batch=4)``, weights from ``Model.init``
              with a seeded generator on the card, one model at a time:
              ``qwen2_moe_a2_7b`` (24 layers, 1,024-token prompts),
              ``rwkv6_1_6b`` (24 layers, 256), ``jamba_v0_1_52b`` cut to one
              period of 8 layers (256), ``arctic_480b`` cut to 1 layer
              (1,024), ``whisper_small`` at its published config (12 + 12
              layers, 224; ``enc_frames`` of 1,500 frames) and
              ``llama3_2_vision_90b`` cut to 10 layers (1,024; ``img_embeds``
              of 1,601 patches), 8 requests of 32 new tokens each (two
              waves), the stub inputs seeded (``run(requests, extras)``).
              Checks: every request answered with tokens in the vocab, every
              logit finite, the attention kernel launched once a
              self-attention layer (and once an encoder layer) a wave (none
              for rwkv6), the kernel against its plain version on the real
              layer-0 q/k/v of qwen2-moe, whisper's encoder (non-causal, S
              1,500) and llama-vision, and the recurrence or cache: prefill
              of the prompt and one token equals prefill then decode of that
              token, for rwkv6 in bf16 within
              ``FAMILY_INVARIANT_FLOOR_FACTOR`` times bf16's own noise
              floor (the same prefill batched against one row at a time)
              and, for rwkv6 and whisper (``kv_src`` and the self K/V
              carried), in f32 (the weights widened) within
              ``FAMILY_INVARIANT_TOL_F32``.  Printed per config: init, prefill
              and decode seconds, prefill and decode tokens/s, peak memory,
              the kernels of one decode step and its idle share
              (``torch.profiler``), attention launches.
13. train_golden -- the LM training path in f32 on the card (TF32 off)
              against ``tests/data/torch_golden_train.json`` (written from
              the JAX reference): ``qwen3_0_6b.reduced()`` and qwen3 at full
              width cut to 2 layers, the ``reduced()`` qwen2-moe, arctic,
              jamba, rwkv6, whisper and llama-vision (the last two with the
              stub front ends' inputs from the file's ``context_seed``), and
              qwen2-moe at full width cut to 1 layer and a 1,024-token vocab
              (60 experts; ``card_only``: the CPU suite skips it), 3
              ``make_train_step`` steps each on seeded ``SyntheticLM``
              batches; losses and grad norms at the file's rtol (or a
              golden's own), the weights' leaf sums, norms and change norms
              at its tolerances.  Printed: each MoE golden's smallest router
              top-k gap, as the reference recorded it.
14. train  -- the LM training path at full size: ``qwen3_0_6b`` at its
              published widths and depth in bf16, weights from ``Model.init``
              with a seeded generator on the card, 30 steps of 8 x 1,024
              ``SyntheticLM`` tokens (ids below 8,192: over the whole vocab
              30 steps learn nothing) through ``run_supervised`` (remat, sync
              checkpoint at the end under ``build/train_ckpt``, timed and
              deleted).  Checks: ``attention_fwd`` on CUDA tensors that
              require grad raises; every parameter's gradient is finite after
              the first backward; every loss is finite and the mean of the
              last 5 is below the first 5's; the attention kernel launches
              0 times in the train steps; the checkpoint restores into the
              live model; the trained weights then serve through
              ``Model.forward`` with exactly ``n_layers`` kernel launches and
              logits within 2e-2 of the loss path's ``_sdpa`` logits.
              Printed: the median step's seconds and tokens/s, a host-clock
              split into forward + backward and optimizer, peak memory, the
              step's FLOPs from shapes and their share of 989 TFLOP/s, the
              card's idle share and its ms by kind of kernel and heaviest
              kernels over 3 steady steps (``torch.profiler``),
              the checkpoint's bytes, save and restore seconds.
15. train_ft -- the fault path at full width: qwen3 cut to 2 layers (4 x
              256 tokens, 12 steps, sync checkpoints every 4 steps, ~1.9 GB
              each, under ``build/``), then qwen2-moe cut to 1 layer and an
              8,192-token vocab (60 experts of (2,048, 1,408), bf16 stored
              as ``uint16``; ~6 GB a checkpoint): failures injected at steps
              5 and 9 must end with parameters and moments bit-equal to a
              clean run (checkpointed at its end only).
              ``torch.use_deterministic_algorithms`` is on for this phase
              only (the embedding's scatter-add backward is otherwise
              atomic); ``CUBLAS_WORKSPACE_CONFIG`` is set before torch
              loads, as cuBLAS reads it once.  Then ``python -m
              repro_torch.launch.train --layers 2 --steps 4`` and ``--arch
              qwen2_moe_a2_7b --layers 1 --steps 4 --batch 2 --seq 128`` as
              children, no ``--device`` (the card), must exit 0, the second
              printing its ``moe aux`` line (logs in
              ``chiprun_out/train_launch{,_moe}.log``).
16. train_families -- the MoE, SSM, hybrid, encoder-decoder and
              vision-language families trained at their published widths in
              bf16 (``FAMILY_TRAIN``), cut in depth only, one model at a
              time: ``qwen2_moe_a2_7b`` 4 of 24 layers (4 x 1,024 tokens),
              ``rwkv6_1_6b`` all 24 (4 x 256), ``jamba_v0_1_52b`` 2 of 32
              (mamba + MLP, mamba + MoE; 4 x 256), ``whisper_small`` at its
              published 12 + 12 layers (8 x 224, 1,500 frames) and
              ``llama3_2_vision_90b`` one period of 5 layers (4 self + 1
              cross; 2 x 512, 1,601 patches; m and v in bf16,
              ``aggressive``), 10 steps each (rwkv6 6: ~8.8 s a step), those
              between the first and the last through ``make_train_step``:
              weights from ``Model.init`` seeded on the card, ``SyntheticLM``
              ids below 8,192, the stub inputs seeded, remat on.  Arctic is
              reckoned (one layer, 14.07 B parameters, 168.8 GB at 12 B a
              parameter), not trained.  Checks: every loss finite and the
              mean of the last 3 below the first 3's; every gradient finite
              after the first backward, and for whisper and llama-vision no
              cross-attention or encoder leaf with an all-zero gradient; the
              MoE aux losses finite; the attention kernel launched 0 times in
              every training step (``families_train_launches``); each peak
              under 76 GB.  Printed per config: init s, the median step's
              seconds and tokens/s, a host-clock split into forward +
              backward and optimizer, peak GB beside the reckoning
              (``train_reckoning``), FLOPs from shapes (``train_flops``) and
              their share of 989 TFLOP/s, kernels a step, the idle share and
              device ms by kind over 2 steady steps (rwkv6 1;
              ``torch.profiler`` tracing the card only), the share of
              (token, slot) pairs the MoE capacity dropped and the last
              step's aux losses.
17. distributed -- the sharded steps on DTensor (``jit_train_step``,
              ``jit_serve_steps``) over a 1x1 NCCL mesh (one card: the whole
              DTensor path with trivial placements), made and destroyed in
              the phase.  (a) full-width ``qwen3_0_6b`` in bf16 with remat,
              3 steps of 8 x 1,024 ``SyntheticLM`` tokens sharded and 3
              unsharded (``make_train_step``) from the same seeded weights
              and batches under deterministic algorithms: losses and
              weights bit-equal (one rank runs the unsharded step's ops;
              the difference is printed), 0 attention launches; step
              seconds of both.  (b) the same model served, prefill of 4 x 1,024 tokens
              then 32 greedy decode steps, unsharded and through
              ``jit_serve_steps`` (B4 through the op
              ``repro_torch::flash_attention`` and its DTensor rule):
              greedy tokens equal, logits within ``DIST_LOGIT_TOL``, B4
              launches of the sharded run (> 0; counts reset before it),
              decode tok/s of both.  (c) the dry run, as a child process on
              the card's device type: ``qwen3_0_6b decode_32k single`` and
              ``arctic_480b train_4k single`` on a fake group of 256 ranks,
              per-rank FLOPs, bytes, collective bytes by op, peak bytes
              (arctic's against 80 GB), roofline terms and seconds.  (d)
              B4's op on DTensor inputs against the plain version.
18. kernels -- one line per ported kernel: launches on its path (and in
              the sweep's engines run, ``sweep_launches``, in the sweep
              server's workers, ``served_launches``, in the multi-host
              phase's hosts, ``multihost_launches``, and for attention in
              phase train's steps, ``train_launches`` (0), its serving
              of the trained weights, ``train_serve_launches``, phase
              serve_families' runs, ``families_launches``, and phase
              train_families' steps, ``families_train_launches`` (0), and
              phase distributed's sharded serving, ``distributed_launches``), its time at
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
              of ``lj/foregraph/bfs``'s calls, in ``foregraph_call``),
              attention also at whisper's encoder call (non-causal, (4,
              1,500, 12/12, hd 64), bf16, from phase serve_families, in
              ``encoder_call``) beside ``scaled_dot_product_attention(
              is_causal=False)``, with
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
# phase serve_families: the MoE, hybrid and SSM families at their published
# widths in bf16, (arch, layers or None for the published depth, prompt
# tokens); 2 waves of SERVE_BATCH requests, FAMILY_NEW new tokens each.
# jamba is cut to one period (8 layers: 51.4 B params, 103 GB, do not fit
# the card) and arctic to 1 of 35 layers; rwkv and jamba take 256-token
# prompts, as their time scans are eager per-token loops.
# Then the encoder-decoder and vision-language families, with
# the stub front ends' inputs seeded (normal x 0.05 at model width):
# whisper at its published config with 224-token prompts (prompt and new
# tokens within its 448-token text context), llama-vision cut to 2 of its
# 20 periods (10 layers: 8 self-attention, 2 image layers; 100 layers are
# 175 GB in bf16).
FAMILY_SERVE = (("qwen2_moe_a2_7b", None, 1024), ("rwkv6_1_6b", None, 256),
                ("jamba_v0_1_52b", 8, 256), ("arctic_480b", 1, 1024),
                ("whisper_small", None, 224), ("llama3_2_vision_90b", 10, 1024))
FAMILY_REQUESTS, FAMILY_NEW = 8, 32
# B4 against plain on the real layer-0 q/k/v of wave 1 (the largest call:
# whisper's is its encoder's, non-causal over 1,500 frames), causal or not
FAMILY_QKV = {"qwen2_moe_a2_7b": True, "whisper_small": False, "llama3_2_vision_90b": True}
FAMILY_STUB_SEED = 2026  # the stub front ends' inputs of phase serve_families
# rwkv6's recurrence: prefill(prompt + [t]) against prefill(prompt) then
# decode_step([t]).  In bf16 the two run matmuls of other shapes (S rows
# against one), whose outputs round apart by bf16 ulps through 24 layers:
# the same prefill batched and one row at a time differ by as much (0.17
# on logits of std 1 on an H100), so bf16 is held to a multiple of that
# floor, measured in the same run, and f32 (the same weights, widened) to
# an absolute tolerance (6.4e-5 measured there)
FAMILY_INVARIANT_FLOOR_FACTOR = 3.0
FAMILY_INVARIANT_TOL_F32 = 1e-3
# whisper's prefill(prompt + [t]) against prefill(prompt) then decode([t]),
# in f32 (the weights widened): kv_src and the self-attention K/V carried
# in the cache; held to the same absolute tolerance
FAMILY_INVARIANT = {"rwkv6_1_6b": ("bfloat16", "float32"), "whisper_small": ("float32",)}
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
# the reference's tab4 rows on lj (written by tests/test_torch_sweep.py)
SWEEP_GOLDEN = ROOT / "tests" / "data" / "torch_golden_sweep.json"
SWEEP_WORKERS = 2
# row columns that the host's numpy computes through libm's pow (the degree
# distribution's skewness), whose last bits follow the host's CPU and numpy
# build rather than anything the port runs: the card's host reads lj's one
# ulp away from the goldens' host.  The rows must carry the value the port's
# own graph gives on this host, within HOST_STAT_RTOL of the golden's.
HOST_STATS = ("degree_skewness",)
# phase search: bench_search's controller-sensitivity space on lj, a quarter
# of it a seed, proposals of 3 (its 5% band is reported, not gated, on lj)
SEARCH_ACCELS = ("accugraph", "foregraph", "hitgraph", "thundergp")
SEARCH_SEEDS = (0, 1, 2)
SEARCH_BUDGET_FRAC = 0.25
SEARCH_BATCH = 3
SEARCH_TOLERANCE = 0.05
SERVER_START_S = 120.0  # spawn to port file
# phase multihost: worker hosts of one seat each, all on the one card
MULTIHOST_HOSTS = ("h0", "h1")
HOST_STAT_RTOL = 1e-12
# LM training: full-width qwen3_0_6b in bf16 on seeded SyntheticLM batches
TRAIN_GOLDEN = ROOT / "tests" / "data" / "torch_golden_train.json"
TRAIN_ARCH = "qwen3_0_6b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 30
TRAIN_LR, TRAIN_WARMUP = 3e-4, 5
# SyntheticLM draws phase train's tokens from the first TRAIN_DATA_VOCAB ids
# of the model's 151,936: over the whole vocab each id is a label ~0.05
# times a step, so 30 steps learn nothing (the loss held at 11.98)
TRAIN_DATA_VOCAB = 8192
TRAIN_SPLIT_STEPS, TRAIN_PROFILE_STEPS = 3, 3  # steady steps split / profiled
TRAIN_SERVE_ROWS = 2  # rows of a batch the trained weights serve
# phase train_ft: full width cut to 2 layers (a checkpoint is ~1.9 GB)
FT_LAYERS, FT_BATCH, FT_SEQ, FT_STEPS, FT_EVERY = 2, 4, 256, 12, 4
FT_FAILURES = (5, 9)
LAUNCH_STEPS = 4
# phase train_ft's MoE resume: qwen2-moe at full width cut to 1 layer and an
# 8,192-token vocab (bf16 weights, f32 m and v: a checkpoint is ~6 GB); then
# the launcher on a MoE config as a child (1 layer, the published vocab)
FT_MOE_ARCH, FT_MOE_VOCAB = "qwen2_moe_a2_7b", 8192
LAUNCH_MOE = ("--arch", "qwen2_moe_a2_7b", "--layers", "1", "--steps", "4", "--batch", "2",
              "--seq", "128")
# phase train_families: the MoE, SSM, hybrid, encoder-decoder and
# vision-language families trained at their published widths in bf16, cut
# in depth only: (arch, layers or None for the published depth, batch, seq,
# moment dtype, steps).  bf16 weights and gradients with f32 m and v are 12
# B a parameter: qwen2-moe 4 of 24 layers, 34.9 GB; rwkv6 all 24, 19.0 GB;
# jamba 2 of 32 (mamba + MLP, mamba + MoE; the 5 layers that reach its
# attention layer need 86.5 GB), 44.9 GB; whisper 12 + 12 encoder layers,
# 4.0 GB.  llama-vision keeps m and v in bf16 (``aggressive``), 8 B a
# parameter: one period, 4 self + 1 cross of 100 layers, 51.0 GB.
# The last two fields: steps, and steady steps of them profiled
# (torch.profiler, the card only).
FAMILY_TRAIN = (("qwen2_moe_a2_7b", 4, 4, 1024, "float32", 10, 2),
                ("rwkv6_1_6b", None, 4, 256, "float32", 10, 2),
                ("jamba_v0_1_52b", 2, 4, 256, "float32", 10, 2),
                ("whisper_small", None, 8, 224, "float32", 10, 2),
                ("llama3_2_vision_90b", 5, 2, 512, "bfloat16", 10, 2))
FAMILY_LOSS_STEPS = 3  # the mean loss of the last 3 steps below the first 3's
FAMILY_PEAK_LIMIT_GB = 76.0
# not trained on the card: one layer of arctic is 14.07 B parameters
# (ArchConfig.param_count), 168.8 GB at 12 B a parameter and 112.6 GB with
# bf16 moments; it waits for sharding across cards
FAMILY_UNTRAINED = ("arctic_480b",)
# phase distributed: the sharded steps on a 1x1 NCCL mesh, full-width qwen3
DIST_STEPS = 3
DIST_LOGIT_TOL = 2e-2  # bf16 logits of two runs of the same ops, stated as ATTN_TOL's bf16
DIST_SERVE_BATCH, DIST_PROMPT, DIST_NEW = 4, 1024, 32
DIST_CELLS = (("qwen3_0_6b", "decode_32k"), ("arctic_480b", "train_4k"),
              ("rwkv6_1_6b", "train_4k"))
# phase sim_benches: the port's twins of the simulator benches in their
# --tiny modes, each a child on the card (no --device), and the kernels each
# must have launched there (the tiny chunk is bfs only: no PageRank, no SpMV)
SIM_BENCHES = (("bench_semexec_torch", ("edge_update",)),
               ("bench_engine_torch", ("dram_timing",)),
               ("bench_host_torch", ("dram_timing",)))
CARD_BYTES = 80e9


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
    max, where the add wraps, with int32-max sources), sizes (0, 1, 31,
    33, and 200,003 edges: not a multiple of 4) and, with the suffix
    ``-out``, a quarter of the destinations outside [0, n) (-5, -1, n and
    n + 7: vertex 0 for the negative ones, dropped edges for the rest),
    inside runs of equal dst too."""
    import numpy as np

    i32max = np.iinfo(np.int32).max

    def case(order: str, kind: str, m: int):
        out_of_range = order.endswith("-out")
        order = order.removesuffix("-out")
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
        if out_of_range:
            bad = rng.random(m) < 0.25
            dst[bad] = rng.choice(np.array([-5, -1, n, n + 7], np.int32), int(bad.sum()))
        return src, dst, delta, values

    kinds = ("f32-mixed", "f32-masked", "i32-wrap")
    cases = {f"{order}/{kind}/200003": case(order, kind, 200_003) for kind in kinds
             for order in ("random", "dst-runs5", "dst-runs32", "dst-runs77", "src-sorted")}
    cases.update({f"random/{kind}/{m}": case("random", kind, m) for kind in kinds
                  for m in (0, 1, 31, 33)})
    cases.update({f"one-dst/{kind}/1048579": case("one-dst", kind, 1_048_579)
                  for kind in ("f32-masked", "i32-wrap")})
    cases.update({f"{order}/{kind}/200003": case(order, kind, 200_003)
                  for kind in ("f32-masked", "i32-wrap")
                  for order in ("random-out", "dst-runs32-out")})
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

    def __init__(self, keep_inputs: bool = True):
        # (kernel, start, end, size of the call's inputs, host s in the call)
        self.events: list = []
        self.keep_inputs = keep_inputs  # clone the largest calls' inputs
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
                if (self.keep_inputs and _name != "dram_timing"
                        and size > self.largest.get(_name, (-1,))[0]):
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


def sweep_summary(per_scenario: list[dict], launches: dict) -> dict:
    """Seconds per scenario of one engine's run, split as phase ``main``
    splits them (kernel: CUDA events around the wrapper calls)."""
    n = len(per_scenario)
    wall = sum(r["wall_s"] for r in per_scenario)
    kernel_s = sum(r["kernel_ms"] for r in per_scenario) / 1e3
    return dict(scenarios=n, wall_s=wall, host_s=wall - kernel_s, kernel_s=kernel_s,
                s_per_scenario=wall / n, host_s_per_scenario=(wall - kernel_s) / n,
                kernel_s_per_scenario=kernel_s / n,
                kernel_ms_by_name={k: sum(r["kernel_ms_by_name"][k] for r in per_scenario)
                                   for k in KERNELS},
                launches={k: launches[k] for k in KERNELS})


def tab4_golden(graphs: dict) -> tuple[dict, list[dict], dict]:
    """The sweep goldens' axes (the paper's tab4 on lj), their rows with
    the host statistics of this host's graph (each within
    ``HOST_STAT_RTOL`` of the golden's, every other column exact), and the
    statistics' drift."""
    golden = json.loads(SWEEP_GOLDEN.read_text())
    axes = {k: tuple(v) for k, v in golden["spec"].items()}
    check(len(axes["graphs"]) == 1 and len(golden["rows"]) == 12,
          f"unexpected sweep goldens: {axes}, {len(golden['rows'])} rows")
    (graph,) = axes["graphs"]
    host_stats = {k: getattr(graphs[graph], k) for k in HOST_STATS}
    drift = {k: v - golden["rows"][0][k] for k, v in host_stats.items()}
    for k, v in host_stats.items():
        check(abs(drift[k]) <= HOST_STAT_RTOL * abs(golden["rows"][0][k]),
              f"sweep: the host's {k} {v!r} is not the golden's {golden['rows'][0][k]!r}")
    return axes, [{**row, **host_stats} for row in golden["rows"]], drift


def phase_sweep(graphs: dict, smi: str) -> dict:
    """The paper's tab4 on lj through ``repro_torch.sweep.run_sweep(...,
    device=None)``, each run on a fresh cache under ``build/`` and with the
    host caches cleared, the launch counts zeroed just before it and read
    just after: scenario mode, batch mode, batch mode on two spawn workers
    (each opens its own CUDA context), the last again on its cache (all
    cached, no launch), the numpy and device engines side by side, and each
    engine alone, in turns, for its seconds per scenario.  Rows must equal
    the reference's goldens; an error row or a ``timing_fallback`` record
    fails the script."""
    import contextlib
    import shutil

    import torch

    from repro_torch.core import hostcache, semexec
    from repro_torch.graph.generators import PAPER_GRAPHS
    from repro_torch.kernels import _platform
    from repro_torch.sweep import SweepSpec, result_rows, run_sweep, runner

    axes, want, drift = tab4_golden(graphs)
    (graph,) = axes["graphs"]
    runner._GRAPHS[PAPER_GRAPHS[graph]] = graphs[graph]  # graph generation is set-up
    cache_root = ROOT / "build" / "sweep_cache"
    shutil.rmtree(cache_root, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    runs: dict = {}

    def run(label: str, engines=("numpy",), cache: str | None = None,
            timed: bool = False, **kw):
        rec = KernelRecorder(keep_inputs=False) if timed else contextlib.nullcontext()
        marks = []  # (clock, recorded calls) as each scenario finishes

        def progress(msg: str) -> None:
            if " ok " in msg or " ERROR " in msg:
                marks.append((time.perf_counter(), len(rec.events) if timed else 0))

        hostcache.clear_all()  # each run pays its own semantic half
        _platform.reset_launches()
        with rec:
            t0 = time.perf_counter()
            result = run_sweep(SweepSpec(name="tab4", engines=engines, **axes),
                               cache_dir=str(cache_root / (cache or label)),
                               progress=progress, device=None, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = _platform.launch_counts()
        errors = [r for r in result.results if r.status == "error"]
        check(not errors, f"sweep {label}: {len(errors)} error rows, first: "
              + (errors[0].record.get("error") or "").strip()[-800:] if errors else "")
        fallback = [r.scenario.scenario_id for r in result.results
                    if "timing_fallback" in r.record]
        check(not fallback, f"sweep {label}: timing_fallback in {fallback}")
        per_scenario = []
        if timed:
            check(len(marks) == len(result.results), f"sweep {label}: {len(marks)} marks")
            prev_t, prev_n = t0, 0
            for (t, n), r in zip(marks, result.results):
                events = rec.events[prev_n:n]
                by_name = {k: sum(s.elapsed_time(e) for name, s, e, *_ in events if name == k)
                           for k in KERNELS}
                kernel_ms = sum(by_name.values())
                per_scenario.append(dict(
                    id=r.scenario.scenario_id, wall_s=t - prev_t, kernel_ms=kernel_ms,
                    host_s=t - prev_t - kernel_ms / 1e3, kernel_ms_by_name=by_name,
                    calls={k: sum(1 for e in events if e[0] == k) for k in KERNELS}))
                prev_t, prev_n = t, n
            check(counts["dram_timing"] == sum(r["calls"]["dram_timing"] for r in per_scenario),
                  f"sweep {label}: launches != wrapper calls")
        runs[label] = dict(mode=kw.get("mode", "scenario"), workers=kw.get("workers", 0),
                           engines=list(engines), wall_s=wall, executed=result.n_executed,
                           cached=result.n_cached, launches=counts,
                           per_scenario=per_scenario)
        return result, counts

    # 1. the golden rows in scenario mode, batch mode and on spawn workers
    for label, kw in (("scenario", dict(timed=True)), ("batch", dict(mode="batch")),
                      ("workers", dict(mode="batch", workers=SWEEP_WORKERS))):
        result, counts = run(label, **kw)
        check(result.n_executed == 12, f"sweep {label}: executed {result.n_executed}")
        rows = result_rows(result)
        check(rows == want, f"sweep {label}: rows differ from the goldens: "
              + next((f"{a} != {b}" for a, b in zip(rows, want) if a != b), "count"))
        if label != "workers":  # the workers' launches are theirs
            check(counts["dram_timing"] > 0, f"sweep {label}: no dram_timing launch")

    # 2. the same cache again: all cached, nothing runs
    result, counts = run("cached", cache="workers", mode="batch", workers=SWEEP_WORKERS)
    check(result.all_cached and result.n_executed == 0,
          f"sweep cached: {result.summary()}")
    check(not any(counts.values()), f"sweep cached: launches {counts}")
    check(result_rows(result) == want, "sweep cached: rows differ from the goldens")

    # 3. both semantic engines: device rows equal numpy rows but for engine
    result, engines_counts = run("engines", engines=("numpy", "device"))
    rows = result_rows(result)
    check(rows[0::2] == want, "sweep engines: numpy rows differ from the goldens")
    for n, d in zip(rows[0::2], rows[1::2]):
        pair = f"{d['accelerator']}/{d['problem']}"
        supported = d["problem"] in semexec.SUPPORTED.get(d["accelerator"], ())
        check(d["engine"] == ("device" if supported else "numpy"),
              f"sweep engines: {pair} ran on {d['engine']}")
        check({**d, "engine": "numpy"} == n, f"sweep engines: {pair} device row != numpy row")
    for name in ("dram_timing", "edge_update", "spmv"):
        check(engines_counts[name] > 0, f"sweep engines: no {name} launch")

    # 4. each engine alone in scenario mode, timed in turns (numpy, device,
    # device, numpy) so that a drift of the host reaches both alike
    turns: dict = {"numpy": [], "device": []}
    for i, engine in enumerate(("numpy", "device", "device", "numpy")):
        label = f"{engine}_{i}"
        result, counts = run(label, engines=(engine,), timed=True)
        check([{**r, "engine": "numpy"} for r in result_rows(result)] == want,
              f"sweep {label}: rows differ from the goldens but for engine")
        turns[engine].append(sweep_summary(runs[label]["per_scenario"], counts))
    engines = {engine: dict(turns=t, **{key: sum(x[key] for x in t) / len(t) for key in (
        "s_per_scenario", "host_s_per_scenario", "kernel_s_per_scenario")})
        for engine, t in turns.items()}
    import numpy

    info = dict(card=smi, spec=f"tab4 on {graph}", scenarios=len(want),
                host_stat_drift=drift, numpy=numpy.__version__,
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                runs={k: {kk: vv for kk, vv in v.items() if kk != "per_scenario"}
                      for k, v in runs.items()},
                engines=engines, device_over_numpy_wall=(
                    engines["device"]["s_per_scenario"] / engines["numpy"]["s_per_scenario"]))
    emit(dict(phase="sweep", **info))
    return dict(info, per_scenario={k: v["per_scenario"] for k, v in runs.items()
                                    if v["per_scenario"]},
                launches=engines_counts)


def lj_search_space():
    """``benchmarks/bench_search.py::search_space`` with the paper graph
    ``lj`` for its tiny graph: 4 accelerators x {hbm, hbm x4, hbm x8} x
    ``MEMORY_SENSITIVITY_AXES`` (mapping x page policy x pseudo-channels),
    bfs."""
    from repro_torch.configs.graphsim import MEMORY_SENSITIVITY_AXES
    from repro_torch.sweep import SweepSpec

    return SweepSpec(name="bench-search-lj", accelerators=SEARCH_ACCELS, graphs=("lj",),
                     problems=("bfs",), drams=("hbm", ("hbm", 4), ("hbm", 8)),
                     **MEMORY_SENSITIVITY_AXES)


def search_spec(space, seed: int):
    import math

    from repro_torch.sweep import SearchSpec

    return SearchSpec(space=space, budget=math.ceil(SEARCH_BUDGET_FRAC * len(space.scenarios())),
                      batch=SEARCH_BATCH, seed=seed)


def no_fallback(cache_dir: Path, scenarios, label: str) -> None:
    """The cached record of every scenario is ok and was timed in its
    batch (``timing_fallback`` is a record field, not a row column)."""
    from repro_torch.sweep import ResultCache, scenario_hash

    cache = ResultCache(str(cache_dir))
    for s in scenarios:
        rec = cache.get(scenario_hash(s))
        check(rec is not None and rec.get("status") == "ok",
              f"{label}: no ok record for {s.scenario_id}")
        check("timing_fallback" not in rec, f"{label}: timing_fallback in {s.scenario_id}: "
              f"{rec.get('timing_fallback')}")


def phase_search(graphs: dict, smi: str) -> dict:
    """Adaptive search (``repro_torch.sweep.search.run_search(...,
    device=None)``) in this process.  The tiny smoke: an exhaustive search
    over the 8 tiny golden scenarios with trace hashes on, every hash equal
    to ``benchmarks/golden_hashes_tiny.json``, every probe row equal to
    ``run_sweep``'s, a warm re-search with no execution and no launch.  On
    ``lj``: the full grid of ``lj_search_space()`` in batch mode, then a
    search a seed at a quarter of the grid, each on a fresh cache with the
    host caches cleared and the launch counts zeroed just before it; every
    probe row must equal the grid's row for its scenario hash.  The 5%
    band of ``bench_search`` is reported on ``lj``, not gated."""
    import shutil

    import torch

    from repro_torch.core import hostcache
    from repro_torch.graph.generators import PAPER_GRAPHS
    from repro_torch.kernels import _platform
    from repro_torch.sweep import (ResultCache, RunnerExecutor, SearchSpec, SweepSpec,
                                   result_rows, run_search, run_sweep, runner, scenario_hash)

    runner._GRAPHS[PAPER_GRAPHS["lj"]] = graphs["lj"]  # graph generation is set-up
    root = ROOT / "build" / "search_cache"
    shutil.rmtree(root, ignore_errors=True)

    # 1. the tiny smoke (bench_search --tiny through the port)
    tiny = SweepSpec(name="search-tiny", accelerators=SEARCH_ACCELS,
                     graphs=(graph_spec("tiny"),), problems=("bfs",), drams=("default", "hbm"))
    names = {scenario_hash(s): s.scenario_id for s in tiny.scenarios()}
    golden = json.loads(TINY_GOLDEN.read_text())
    cache = ResultCache(str(root / "tiny"), memo_capacity=256)
    _platform.reset_launches()
    res = run_search(SearchSpec(space=tiny, budget=len(names), batch=2, seed=0), cache=cache,
                     executor=RunnerExecutor(cache, with_trace_hash=True), device=None)
    tiny_launches = _platform.launch_counts()
    check(res.executed == len(names) == 8 and not res.errors, f"search tiny: {res.summary()}")
    check(tiny_launches["dram_timing"] > 0, "search tiny: no dram_timing launch")
    for p in res.probes:
        got = cache.get(p["hash"])["trace_hash"]
        check(got == golden[names[p["hash"]]],
              f"search tiny: trace hash of {names[p['hash']]} {got} != golden")
    grid = run_sweep(tiny, cache_dir=str(root / "tiny_grid"), device=None)
    by_hash = {r.hash: row for r, row in zip(grid.results, result_rows(grid))}
    check(all(p["row"] == by_hash[p["hash"]] for p in res.probes),
          "search tiny: a probe row differs from run_sweep's")
    _platform.reset_launches()
    warm = run_search(SearchSpec(space=tiny, budget=8, batch=2, seed=3), cache=cache,
                      device=None)
    warm_launches = _platform.launch_counts()
    check(warm.executed == 0 and warm.warm == 8, f"search tiny warm: {warm.summary()}")
    check(not any(warm_launches.values()), f"search tiny warm: launches {warm_launches}")

    # 2. lj: the full grid, then a quarter of it a seed
    space = lj_search_space()
    scenarios = space.scenarios()
    hostcache.clear_all()
    _platform.reset_launches()
    t0 = time.perf_counter()
    grid = run_sweep(space, cache_dir=str(root / "lj_grid"), mode="batch", device=None)
    torch.cuda.synchronize()
    grid_wall = time.perf_counter() - t0
    grid_launches = _platform.launch_counts()
    check(grid.n_errors == 0 and grid.n_executed == len(scenarios),
          f"search grid: {grid.summary()}")
    no_fallback(root / "lj_grid", scenarios, "search grid")
    by_hash = {r.hash: row for r, row in zip(grid.results, result_rows(grid))}
    optimum = min(row["runtime_s"] for row in by_hash.values())
    best_id = next(r.scenario.scenario_id for r, row in zip(grid.results, result_rows(grid))
                   if row["runtime_s"] == optimum)
    seeds = []
    for seed in SEARCH_SEEDS:
        hostcache.clear_all()
        _platform.reset_launches()
        t0 = time.perf_counter()
        sres = run_search(search_spec(space, seed), cache_dir=str(root / f"lj_seed{seed}"),
                          device=None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _platform.launch_counts()
        check(not sres.errors and sres.executed <= sres.budget,
              f"search seed {seed}: {sres.summary()}")
        check(launches["dram_timing"] > 0, f"search seed {seed}: no dram_timing launch")
        for p in sres.probes:
            check(p["row"] == by_hash[p["hash"]],
                  f"search seed {seed}: probe {p['scenario_id']} differs from the grid's row")
        no_fallback(root / f"lj_seed{seed}",
                    [s for s in scenarios if scenario_hash(s) in
                     {p["hash"] for p in sres.probes}], f"search seed {seed}")
        to_opt = next((h["executed"] for h in sres.history
                       if h["best"] is not None and h["best"] / optimum - 1 <= SEARCH_TOLERANCE),
                      None)
        seeds.append(dict(seed=seed, executed=sres.executed, rounds=sres.rounds,
                          best=sres.best["value"], best_scenario=sres.best["scenario_id"],
                          gap=sres.best["value"] / optimum - 1,
                          executions_to_optimum=to_opt, wall_s=wall,
                          wall_s_per_probe=wall / max(1, sres.executed), launches=launches,
                          answer=json.loads(json.dumps(dict(
                              best=sres.best, history=sres.history,
                              executed=sres.executed)))))
    info = dict(card=smi, tiny=dict(scenarios=8, trace_hashes="golden", rows="run_sweep",
                                    launches=tiny_launches, warm_executed=warm.executed,
                                    warm_launches=warm_launches),
                space=space.name, raw_points=space.n_points, pool=len(scenarios),
                budget=search_spec(space, 0).budget,
                grid=dict(wall_s=grid_wall, s_per_scenario=grid_wall / len(scenarios),
                          optimum=optimum, optimum_scenario=best_id, launches=grid_launches),
                seeds=[{k: v for k, v in x.items() if k != "answer"} for x in seeds],
                search_wall_s=sum(x["wall_s"] for x in seeds),
                search_executed=sum(x["executed"] for x in seeds))
    emit(dict(phase="search", **info))
    return dict(info, seed0=seeds[0]["answer"])


def serve_env() -> dict:
    import os

    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]))


def serve_child(log_name: str, *args: str):
    """``python -m repro_torch.serve <args>`` as a child with no
    ``--device`` (the card), stdout and stderr in ``chiprun_out/<log>``;
    returns it and its spawn's host and wall clocks."""
    OUT_DIR.mkdir(exist_ok=True)
    with open(OUT_DIR / log_name, "w") as log:
        t0, t0_wall = time.perf_counter(), time.time()
        proc = subprocess.Popen([sys.executable, "-m", "repro_torch.serve", *args], cwd=ROOT,
                                env=serve_env(), stdout=log, stderr=subprocess.STDOUT)
    return proc, t0, t0_wall


def start_server(label: str, cache: Path, *extra: str):
    """``python -m repro_torch.serve`` as a child process with no
    ``--device`` (the card) and its logs under ``chiprun_out/``; returns
    it, its address, the seconds from spawn to its port file, and the
    spawn's host and wall clocks."""
    import shutil

    shutil.rmtree(cache, ignore_errors=True)
    port_file = ROOT / "build" / "serve_port"
    port_file.unlink(missing_ok=True)
    proc, t0, t0_wall = serve_child(
        f"serve_{label}.log", "--port", "0", "--port-file", str(port_file.relative_to(ROOT)),
        "--cache", str(cache.relative_to(ROOT)), "--workers", str(SWEEP_WORKERS), *extra)
    while not (port_file.exists() and port_file.read_text().strip()):
        if proc.poll() is not None or time.perf_counter() - t0 > SERVER_START_S:
            proc.kill()
            fail(f"sweep_server {label}: no port file (exit {proc.poll()}); "
                 f"see chiprun_out/serve_{label}.log")
        time.sleep(0.05)
    return proc, port_file.read_text().strip(), time.perf_counter() - t0, t0, t0_wall


def worker_starts(label: str, t0_wall: float) -> list[dict]:
    """The ``worker_ready`` lines of a server's log: each worker's seconds
    from the server's spawn to ready, its CUDA context and kernel load."""
    out = []
    decoder = json.JSONDecoder()
    for line in (OUT_DIR / f"serve_{label}.log").read_text().splitlines():
        # the spawn workers share the log: two events can land on one line
        at = line.find("{")
        while at != -1:
            try:
                ev, end = decoder.raw_decode(line, at)
            except json.JSONDecodeError:
                at = line.find("{", at + 1)
                continue
            if isinstance(ev, dict) and ev.get("event") == "worker_ready":
                out.append(dict(ready_s_from_spawn=ev["ts"] - t0_wall,
                                **{k: ev.get(k) for k in ("context_s", "kernels_s", "built")}))
            at = line.find("{", end)
    return out


def stop_server(proc, label: str) -> float:
    """SIGTERM: the server drains and must exit 0; returns the seconds."""
    import signal

    t0 = time.perf_counter()
    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=120)
    except subprocess.TimeoutExpired:
        proc.kill()
        fail(f"sweep_server {label}: no exit within 120 s of SIGTERM")
    check(rc == 0, f"sweep_server {label}: exit {rc} after SIGTERM")
    return time.perf_counter() - t0


def served_job(client, spec, label: str, cache: Path):
    """Stream one sweep job; the rows must all arrive, none an error and
    none from a ``timing_fallback`` record.  ``label`` prefixes every
    failure (``"<phase> <job>"``)."""
    from repro_torch.serve import JobResult

    t0 = time.perf_counter()
    events, first = [], None
    for ev in client.submit(spec):
        if ev["type"] == "row" and first is None:
            first = time.perf_counter()
        events.append(ev)
    wall = time.perf_counter() - t0
    res = JobResult(events[0]["job_id"], events[0]["total"], events[0].get("skipped", []),
                    events, events[-1]["type"])
    check(res.outcome == "done" and len(res.rows) == res.total == len(spec.scenarios()),
          f"{label}: {res.outcome} with {len(res.rows)}/{res.total} rows")
    check(res.n_errors == 0, f"{label}: error rows: "
          + next((e["row"].get("error", "")[-800:] for e in res.row_events
                  if e["status"] == "error"), ""))
    no_fallback(cache, spec.scenarios(), label)
    return res, dict(wall_s=wall, rows=len(res.rows), rows_per_s=len(res.rows) / wall,
                     executed=res.statuses.count("ok"), cached=res.n_cached), first


def stats_delta(before: dict, after: dict) -> dict:
    keys = ("executed_ok", "cache_hits", "inflight_joins", "dedup_joins")
    return dict({k: after["counters"].get(k, 0) - before["counters"].get(k, 0) for k in keys},
                launches={k: after["launches"][k] - before["launches"][k]
                          for k in after["launches"]})


def compute_apps() -> list[str]:
    proc = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                           "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return [line.strip() for line in proc.stdout.splitlines() if line.strip()]


def phase_sweep_server(graphs: dict, smi: str, search: dict) -> dict:
    """The sweep server (``python -m repro_torch.serve``, 2 warm spawn
    workers on the card) driven through ``ServeClient``: (a) tab4 on lj
    against the goldens; (b) two overlapping jobs at once (numpy and device
    engines, and device alone: every unique scenario executes once, the
    rest join or hit, B2 and B3 run in the workers); (c) a search job equal
    to phase ``search``'s seed 0; (d) (a) again, all cached with no launch;
    SIGTERM, exit 0; (e) a second server whose dispatch 1 crashes its
    worker: a WorkerLost, one respawn, (a)'s rows; SIGTERM, exit 0.
    Launches are the workers', summed by the server (``/stats``)."""
    import threading

    from repro_torch.serve import ServeClient
    from repro_torch.sweep import SweepSpec

    axes, want, _ = tab4_golden(graphs)
    tab4 = SweepSpec(name="tab4", **axes)
    cache = ROOT / "build" / "serve_cache"
    apps_before = compute_apps()
    proc, address, port_s, t_spawn, t_wall = start_server("clean", cache)
    jobs: dict = {}
    try:
        client = ServeClient(address)
        client.wait_ready(deadline_s=60)
        base = client.stats()
        check(base["device"] == "cuda", f"sweep_server: device {base['device']}")
        # (a) tab4 on lj: the first rows pay each worker's start
        res_a, jobs["a"], first = served_job(client, tab4, "sweep_server a", cache)
        jobs["a"]["first_row_s_from_spawn"] = first - t_spawn
        check(res_a.rows == want, "sweep_server a: rows differ from the goldens: "
              + next((f"{x} != {y}" for x, y in zip(res_a.rows, want) if x != y), ""))
        apps = compute_apps()
        if apps_before:  # the server's parent opens no CUDA context
            check(len(apps) == len(apps_before) + SWEEP_WORKERS,
                  f"sweep_server: compute apps {apps_before} -> {apps}")
        after_a = client.stats()
        jobs["a"].update(stats_delta(base, after_a))
        check(jobs["a"]["launches"]["dram_timing"] > 0, "sweep_server a: no B1 in the workers")

        # (b) two overlapping jobs at once
        both = SweepSpec(name="tab4", engines=("numpy", "device"), **axes)
        device_only = SweepSpec(name="tab4", engines=("device",), **axes)
        out: dict = {}

        def run(key, spec):
            try:
                out[key] = served_job(client_b[key], spec, f"sweep_server b_{key}", cache)
            except SystemExit:
                out[key] = None

        client_b = {"both": ServeClient(address), "device": ServeClient(address)}
        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=("both", both)),
                   threading.Thread(target=run, args=("device", device_only))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall_b = time.perf_counter() - t0
        check(all(out.get(k) for k in ("both", "device")), "sweep_server b: a job failed")
        after_b = client.stats()
        jobs["b"] = dict(stats_delta(after_a, after_b), wall_s=wall_b,
                         rows=sum(out[k][1]["rows"] for k in out),
                         jobs={k: out[k][1] for k in out})
        jobs["b"]["rows_per_s"] = jobs["b"]["rows"] / wall_b
        rows_both, rows_device = out["both"][0].rows, out["device"][0].rows
        check(rows_both[0::2] == want, "sweep_server b: numpy rows differ from the goldens")
        check([{**r, "engine": "numpy"} for r in rows_device] == want,
              "sweep_server b: device rows differ from the goldens but for engine")
        check(rows_both[1::2] == rows_device, "sweep_server b: the two jobs' device rows differ")
        check(jobs["b"]["executed_ok"] == len(want),
              f"sweep_server b: executed {jobs['b']['executed_ok']}, not once each")
        check(jobs["b"]["inflight_joins"] + jobs["b"]["cache_hits"] == 2 * len(want),
              f"sweep_server b: joins {jobs['b']['inflight_joins']} + hits "
              f"{jobs['b']['cache_hits']}")
        for name in ("dram_timing", "edge_update", "spmv"):
            check(jobs["b"]["launches"][name] > 0, f"sweep_server b: no {name} in the workers")

        # (c) a search job: phase search's seed 0, answered by the server
        space = lj_search_space()
        t0 = time.perf_counter()
        res_c = client.run_search(search_spec(space, 0))
        wall_c = time.perf_counter() - t0
        after_c = client.stats()
        check(res_c.outcome == "done" and res_c.result is not None,
              f"sweep_server c: {res_c.outcome} {res_c.error}")
        for key in ("best", "history", "executed"):
            check(res_c.result[key] == search["seed0"][key],
                  f"sweep_server c: {key} differs from the in-process search")
        no_fallback(cache, [s for s in space.scenarios()
                            if s.scenario_id in {p["scenario_id"]
                                                 for p in res_c.result["probes"]}],
                    "sweep_server c")
        jobs["c"] = dict(stats_delta(after_b, after_c), wall_s=wall_c,
                         executed=res_c.result["executed"], rounds=res_c.result["rounds"],
                         best=res_c.result["best"]["value"],
                         wall_s_per_probe=wall_c / max(1, res_c.result["executed"]))

        # (d) (a) again: all cached, no launch in the workers
        res_d, jobs["d"], _ = served_job(client, tab4, "sweep_server d", cache)
        after_d = client.stats()
        jobs["d"].update(stats_delta(after_c, after_d))
        check(res_d.statuses == ["cached"] * len(want) and res_d.rows == res_a.rows,
              "sweep_server d: not all cached, or rows differ")
        check(not any(jobs["d"]["launches"].values()),
              f"sweep_server d: launches {jobs['d']['launches']}")
        clean_stats = after_d
    finally:
        drain_s = stop_server(proc, "clean") if proc.poll() is None else None

    # (e) a second server whose dispatch 1 crashes its worker
    plan = json.dumps(dict(seed=0, rules=[dict(site="worker.chunk", kind="crash", at=[1])]))
    fcache = ROOT / "build" / "serve_cache_faults"
    fproc, faddress, fport_s, ft_spawn, ft_wall = start_server("faults", fcache, "--faults",
                                                               plan)
    try:
        fclient = ServeClient(faddress)
        fclient.wait_ready(deadline_s=60)
        res_e, jobs["e"], first = served_job(fclient, tab4, "sweep_server e", fcache)
        jobs["e"]["first_row_s_from_spawn"] = first - ft_spawn
        fstats = fclient.stats()
        check(res_e.rows == res_a.rows, "sweep_server e: rows differ from the clean server's")
        faults = fstats["faults"]
        check(faults["faults_injected"] == 1 and faults["chunks_lost"] >= 1
              and faults["workers_lost"] == 1 and faults["worker_respawns"] == 1,
              f"sweep_server e: faults {faults}")
        jobs["e"].update(faults=faults, launches=fstats["launches"])
    finally:
        fdrain_s = stop_server(fproc, "faults") if fproc.poll() is None else None

    served = {k: clean_stats["launches"][k] + fstats["launches"][k] for k in KERNELS}
    info = dict(card=smi, workers=SWEEP_WORKERS, spec=f"tab4 on {axes['graphs'][0]}",
                port_file_s=port_s, faulted_port_file_s=fport_s,
                worker_starts=worker_starts("clean", t_wall),
                faulted_worker_starts=worker_starts("faults", ft_wall), jobs=jobs,
                compute_apps_before=apps_before, compute_apps=apps, drain_s=drain_s,
                faulted_drain_s=fdrain_s, served_launches=served,
                counters={k: clean_stats["counters"].get(k, 0) for k in (
                    "executed_ok", "cache_hits", "inflight_joins", "rows_streamed")})
    emit(dict(phase="sweep_server", **info))
    return info


def host_events(label: str, name: str) -> dict:
    """The first line of each structured event in a host's log."""
    out: dict = {}
    path = OUT_DIR / f"multihost_{label}_{name}.log"
    for line in path.read_text().splitlines() if path.exists() else ():
        if line.startswith("{"):
            try:
                ev = json.loads(line)
            except ValueError:
                continue
            out.setdefault(ev.get("event"), ev)
    return out


def start_multihost(label: str, cache: Path) -> dict:
    """A server with ``--worker-listen`` (it executes nothing) and the
    worker hosts ``MULTIHOST_HOSTS`` of one seat each, every process a
    child with no ``--device``; waits for both port files, then for every
    host's registration and its seat's ``worker_ready``."""
    import shutil

    from repro_torch.serve import ServeClient

    shutil.rmtree(cache, ignore_errors=True)
    files = [ROOT / "build" / f"multihost_{k}" for k in ("port", "worker_port")]
    for f in files:
        f.unlink(missing_ok=True)
    server, t0, _ = serve_child(
        f"multihost_{label}.log", "--port", "0", "--port-file", str(files[0].relative_to(ROOT)),
        "--worker-listen", "127.0.0.1:0", "--worker-port-file",
        str(files[1].relative_to(ROOT)), "--cache", str(cache.relative_to(ROOT)),
        "--chunk-size", "1", "--trace-hashes")
    top = dict(label=label, server=server, hosts={})
    while not all(f.exists() and f.read_text().strip() for f in files):
        if server.poll() is not None or time.perf_counter() - t0 > SERVER_START_S:
            stop_multihost(top)
            fail(f"multihost {label}: no port files (exit {server.poll()}); "
                 f"see chiprun_out/multihost_{label}.log")
        time.sleep(0.05)
    top["port_files_s"] = time.perf_counter() - t0
    top["address"], top["pool"] = (f.read_text().strip() for f in files)
    for name in MULTIHOST_HOSTS:
        proc, h0, h0_wall = serve_child(f"multihost_{label}_{name}.log", "worker", "--connect",
                                        top["pool"], "--seats", "1", "--name", name)
        top["hosts"][name] = dict(proc=proc, t0=h0, t0_wall=h0_wall)
    client = ServeClient(top["address"])
    client.wait_ready(deadline_s=60)
    while True:
        events = {name: host_events(label, name) for name in MULTIHOST_HOSTS}
        if all({"agent_registered", "worker_ready"} <= set(ev) for ev in events.values()):
            break
        dead = [n for n, h in top["hosts"].items() if h["proc"].poll() is not None]
        if dead or time.perf_counter() - t0 > SERVER_START_S:
            stop_multihost(top)
            fail(f"multihost {label}: hosts {dead or list(events)} never ready; see "
                 f"chiprun_out/multihost_{label}_*.log")
        time.sleep(0.1)
    hosts = client.stats()["workers"]["hosts"]
    check(sorted(hosts) == sorted(MULTIHOST_HOSTS), f"multihost {label}: hosts {sorted(hosts)}")
    for name, h in top["hosts"].items():
        check(hosts[name]["device"] == "cuda", f"multihost {label}: {name} on {hosts[name]}")
        ev = events[name]
        h.update(registered_s_from_spawn=ev["agent_registered"]["ts"] - h["t0_wall"],
                 ready_s_from_spawn=ev["worker_ready"]["ts"] - h["t0_wall"],
                 **{k: ev["worker_ready"].get(k) for k in ("context_s", "kernels_s", "built")})
    top["client"] = client
    return top


def stop_multihost(top: dict, expect: tuple = ()) -> float | None:
    """``python -m repro_torch.serve --shutdown``: the server drains and
    tells every host to shut down; the request, the server and the hosts
    in ``expect`` must exit 0.  Any process still up afterwards is killed.
    Returns the seconds from the request to the last exit, or None when
    the server was already gone."""
    procs = [top["server"]] + [h["proc"] for h in top["hosts"].values()]
    if top["server"].poll() is not None or "address" not in top:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        return None
    t0 = time.perf_counter()
    rcs = {}
    try:
        ask = subprocess.run([sys.executable, "-m", "repro_torch.serve", "--shutdown",
                              "--address", top["address"]], cwd=ROOT, env=serve_env(),
                             capture_output=True, text=True, timeout=120)
        rcs["--shutdown"] = ask.returncode
        rcs["server"] = top["server"].wait(timeout=120)
        for name in expect:
            rcs[name] = top["hosts"][name]["proc"].wait(timeout=60)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    wanted = ("--shutdown", "server", *expect)
    check(all(rcs.get(k) == 0 for k in wanted),
          f"multihost {top['label']}: exits {rcs}, want 0 for {wanted}")
    return time.perf_counter() - t0


def phase_multihost(graphs: dict, smi: str) -> dict:
    """Multi-host serving on the card: a server started with
    ``--worker-listen`` (it runs nothing) and two worker hosts (``python
    -m repro_torch.serve worker --connect ... --seats 1``), each seat its
    own CUDA context, none of the three given ``--device``.  (a) the 8
    tiny scenarios, trace hashes equal to the goldens, both hosts serving,
    then all cached; (b) tab4 on lj against the sweep goldens, B1 launched
    by the hosts (``/stats``); (c) tab4 with both engines, B2 and B3
    launched by the hosts; ``--shutdown``: everything exits 0.  Then a
    second server and two hosts on a fresh cache: (d) tab4 with h0
    SIGKILLed once it holds a chunk, the golden rows, a host lost; (e)
    ``--shutdown``: the server and h1 exit 0.  The server's and the
    agents' own processes open no CUDA context."""
    import os
    import signal
    import threading

    from repro_torch.serve import ServeClient
    from repro_torch.sweep import SweepSpec

    axes, want, _ = tab4_golden(graphs)
    tab4 = SweepSpec(name="tab4", **axes)
    tiny = SweepSpec(name="tiny", accelerators=SEARCH_ACCELS, graphs=(graph_spec("tiny"),),
                     problems=("bfs",), drams=("default", "hbm"))
    golden = json.loads(TINY_GOLDEN.read_text())
    jobs: dict = {}
    apps_before = compute_apps()
    cache = ROOT / "build" / "multihost_cache"
    top = start_multihost("clean", cache)
    try:
        client = top["client"]
        apps = compute_apps()
        if apps_before:  # one context a seat: the server and the agents open none
            check(len(apps) == len(apps_before) + len(MULTIHOST_HOSTS),
                  f"multihost: compute apps {apps_before} -> {apps}")
        base = client.stats()
        check(base["device"] == "cuda", f"multihost: the server's device {base['device']}")

        # (a) the tiny goldens from both hosts, then all cached
        res_a, jobs["a"], _ = served_job(client, tiny, "multihost a", cache)
        ids = [sc.scenario_id for sc in tiny.scenarios()]
        hashes = {ids[e["index"]]: e["trace_hash"] for e in res_a.row_events}
        check(hashes == {i: golden[i] for i in ids},
              f"multihost a: trace hashes differ from the goldens: {hashes}")
        after_a1 = client.stats()
        done = {n: h["chunks_done"] for n, h in after_a1["workers"]["hosts"].items()}
        check(all(done.get(n, 0) >= 1 for n in MULTIHOST_HOSTS),
              f"multihost a: chunks by host {done}")
        jobs["a"].update(stats_delta(base, after_a1), chunks_by_host=done)
        res_a2, jobs["a_cached"], _ = served_job(client, tiny, "multihost a cached", cache)
        after_a = client.stats()
        jobs["a_cached"].update(stats_delta(after_a1, after_a))
        check(res_a2.statuses == ["cached"] * len(ids)
              and [e["trace_hash"] for e in res_a2.row_events]
              == [e["trace_hash"] for e in res_a.row_events]
              and not any(jobs["a_cached"]["launches"].values()),
              "multihost a: the resubmission is not all cached with the same hashes "
              f"and no launch ({jobs['a_cached']['launches']})")

        # (b) tab4 on lj: the sweep goldens, B1 in the hosts
        res_b, jobs["b"], _ = served_job(client, tab4, "multihost b", cache)
        check(res_b.rows == want, "multihost b: rows differ from the goldens: "
              + next((f"{x} != {y}" for x, y in zip(res_b.rows, want) if x != y), ""))
        after_b = client.stats()
        jobs["b"].update(stats_delta(after_a, after_b), chunks_by_host={
            n: h["chunks_done"] for n, h in after_b["workers"]["hosts"].items()})
        check(jobs["b"]["launches"]["dram_timing"] > 0, "multihost b: no B1 in the hosts")

        # (c) both engines: the numpy rows cached, the device rows run B2 and B3
        both = SweepSpec(name="tab4", engines=("numpy", "device"), **axes)
        res_c, jobs["c"], _ = served_job(client, both, "multihost c", cache)
        check(res_c.rows[0::2] == want, "multihost c: numpy rows differ from the goldens")
        check([{**r, "engine": "numpy"} for r in res_c.rows[1::2]] == want,
              "multihost c: device rows differ from the goldens but for engine")
        after_c = client.stats()
        jobs["c"].update(stats_delta(after_b, after_c))
        for name in ("dram_timing", "edge_update", "spmv"):
            check(jobs["c"]["launches"][name] > 0, f"multihost c: no {name} in the hosts")
        clean_stats = after_c
    finally:
        drain_s = stop_multihost(top, expect=MULTIHOST_HOSTS)

    # (d) a fresh server and hosts; h0 SIGKILLed once it holds a chunk
    kcache = ROOT / "build" / "multihost_cache_kill"
    ktop = start_multihost("kill", kcache)
    victim = MULTIHOST_HOSTS[0]
    killed: dict = {}
    try:
        kclient = ktop["client"]

        def assassin():
            watcher = ServeClient(ktop["address"])
            deadline = time.perf_counter() + 300
            while time.perf_counter() < deadline:
                h = watcher.stats()["workers"]["hosts"].get(victim)
                if h and h.get("busy", 0) >= 1:
                    os.kill(ktop["hosts"][victim]["proc"].pid, signal.SIGKILL)
                    killed["at"] = time.perf_counter()
                    return
                time.sleep(0.02)

        t = threading.Thread(target=assassin, daemon=True)
        t0 = time.perf_counter()
        t.start()
        res_d, jobs["d"], _ = served_job(kclient, tab4, "multihost d", kcache)
        t.join(timeout=5)
        check("at" in killed, f"multihost d: {victim} never held a chunk")
        check(res_d.rows == want, "multihost d: rows differ from the goldens")
        kstats = kclient.stats()
        jobs["d"].update(faults=kstats["faults"], launches=kstats["launches"],
                         killed_s_from_submit=killed["at"] - t0,
                         chunks_by_host={n: h["chunks_done"]
                                         for n, h in kstats["workers"]["hosts"].items()})
        check(kstats["faults"]["workers_lost"] >= 1, f"multihost d: faults {kstats['faults']}")
        check(kstats["launches"]["dram_timing"] > 0, "multihost d: no B1 in the hosts")
    finally:
        kdrain_s = stop_multihost(ktop, expect=MULTIHOST_HOSTS[1:])
    # every context goes with its process, the killed host's orphaned seat
    # too (its next heartbeat finds the pipe closed)
    deadline = time.perf_counter() + 30
    while len(apps_after := compute_apps()) > len(apps_before) \
            and time.perf_counter() < deadline:
        time.sleep(0.5)
    check(len(apps_after) == len(apps_before),
          f"multihost: compute apps {apps_before} after the phase: {apps_after}")

    def starts(t: dict) -> dict:
        return dict(port_files_s=t["port_files_s"], hosts={
            n: {k: h[k] for k in ("registered_s_from_spawn", "ready_s_from_spawn",
                                  "context_s", "kernels_s", "built")}
            for n, h in t["hosts"].items()})

    launches = {k: clean_stats["launches"][k] + kstats["launches"][k] for k in KERNELS}
    info = dict(card=smi, hosts=list(MULTIHOST_HOSTS), seats_per_host=1,
                spec=f"tab4 on {axes['graphs'][0]}", starts=starts(top),
                kill_starts=starts(ktop), jobs=jobs, compute_apps_before=apps_before,
                compute_apps=apps, compute_apps_after=apps_after, drain_s=drain_s,
                kill_drain_s=kdrain_s, multihost_launches=launches)
    emit(dict(phase="multihost", **info))
    return info


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
             (2, 256, 4, 2, 64, False),  # non-causal
             # non-causal at a ragged S: whisper's encoder (1,500 frames) and
             # a tail of 32 keys past the 128-row block
             (4, 1500, 12, 12, 64, False), (1, 160, 4, 2, 64, False)]
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

    import gc

    from repro_torch.configs.base import ArchConfig
    from repro_torch.interop import context_inputs_numpy, lm_params_numpy, load_lm_params
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
        # the stub front ends' inputs, as the writer seeded them
        extras = {k: torch.from_numpy(v).to(dev) for k, v in
                  context_inputs_numpy(cfg, n, g["stub_seed"]).items()}
        check({k: list(v.shape) for k, v in extras.items()} == g["stub_inputs"],
              f"serve golden {g['name']}: stub inputs {extras.keys()} != {g['stub_inputs']}")
        cache = model.init_cache(n, s + max_new)
        logits, cache = model.prefill({"tokens": torch.from_numpy(prompts).to(dev), **extras},
                                      cache)
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
            [Request(rid=i, prompt=p, max_new=max_new) for i, p in enumerate(prompts)], extras)
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
                              tokens=n * max_new, router_min_gap=g.get("router_min_gap"),
                              stub_inputs=g["stub_inputs"])
        del model, cache, logits, extras
        gc.collect()  # the full-width vision cut holds 17.2 GB
        torch.cuda.empty_cache()
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


def recurrence_invariant(model, toks, nxt, extras: dict, dtypes) -> dict:
    """The last logits of ``prefill(toks + nxt)`` against ``prefill(toks)``
    then ``decode_step(nxt)``, with the batch's ``extras`` (the stub front
    ends' inputs) in both prefills: in the model's bf16 beside bf16's noise
    floor (the extended prefill batched against one row at a time), and in
    f32 with the same weights widened (the model is left in f32), as
    ``dtypes`` asks."""
    import dataclasses

    import torch

    arch, vocab, s = model.cfg.arch, model.cfg.vocab, toks.shape[1]

    def last(tokens, extra=None, rows=slice(None)):
        cache = model.init_cache(tokens.shape[0], s + 2)
        logits, cache = model.prefill(
            {"tokens": tokens, **{k: v[rows] for k, v in extras.items()}}, cache)
        if extra is not None:
            logits, _ = model.decode_step(extra, cache, s)
        return logits[:, -1, :vocab].float()

    ext = torch.cat([toks, nxt], dim=1)
    out = {}
    for dtype in dtypes:
        if dtype == "float32":
            model.float()
            model.cfg = dataclasses.replace(model.cfg, dtype="float32")
        whole, stepped = last(ext), last(toks, nxt)
        err = float((whole - stepped).abs().max())
        out[f"invariant_{dtype}"] = dict(
            max_abs_err=err, logit_std=float(whole.std()),
            argmax_equal=bool(torch.equal(whole.argmax(-1), stepped.argmax(-1))))
        if dtype == "bfloat16":
            rows = torch.cat([last(ext[i:i + 1], rows=slice(i, i + 1))
                              for i in range(ext.shape[0])])
            floor = float((whole - rows).abs().max())
            out[f"invariant_{dtype}"].update(noise_floor=floor,
                                             floor_factor=FAMILY_INVARIANT_FLOOR_FACTOR)
            check(err <= FAMILY_INVARIANT_FLOOR_FACTOR * floor,
                  f"{arch} bf16: prefill(prompt + [t]) != prefill(prompt) + decode([t]): "
                  f"{err} > {FAMILY_INVARIANT_FLOOR_FACTOR} x the noise floor {floor}")
        else:
            out[f"invariant_{dtype}"]["tolerance"] = FAMILY_INVARIANT_TOL_F32
            check(err <= FAMILY_INVARIANT_TOL_F32,
                  f"{arch} f32: prefill(prompt + [t]) != prefill(prompt) + decode([t]): "
                  f"{err} > {FAMILY_INVARIANT_TOL_F32}")
    return out


def phase_serve_families(dev, card: str) -> dict:
    """The MoE, hybrid, SSM, encoder-decoder and vision-language families in
    bf16 through ``ServeEngine.run``, one model at a time (each freed before
    the next is built); the launch counts are zeroed just before each run
    and read just after."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.interop import context_inputs_numpy
    from repro_torch.kernels import _platform
    from repro_torch.models import Model
    from repro_torch.models.transformer import layer_program
    from repro_torch.serve.legacy.engine import Request, ServeEngine

    out = {}
    t_phase = time.perf_counter()
    for arch, layers, prompt_len in FAMILY_SERVE:
        cfg = get_arch(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        # B4 a wave: each self-attention layer's prefill, each encoder layer
        n_attn = cfg.n_enc_layers + sum(1 for spec in layer_program(cfg)
                                        if spec.mixer in ("attn", "self_cross"))
        max_seq = prompt_len + FAMILY_NEW
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = Model(cfg).init(torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        params = sum(p.numel() for p in model.parameters())
        rng = np.random.default_rng(2026)
        prompts = [rng.integers(0, cfg.vocab, prompt_len).astype(np.int32)
                   for _ in range(FAMILY_REQUESTS)]
        extras = {k: torch.from_numpy(v).to(dev) for k, v in
                  context_inputs_numpy(cfg, SERVE_BATCH, FAMILY_STUB_SEED).items()}
        engine = ServeEngine(model, batch=SERVE_BATCH, max_seq=max_seq)
        # set-up: one short wave warms cuBLAS and the lazily loaded kernels
        engine.run([Request(rid=0, prompt=prompts[0][:64], max_new=2)], extras)

        phases: list = []  # (kind, seconds) of every prefill / decode call
        finite: list = []  # a 0-d bool tensor a call: its logits are finite
        prefill, decode = engine.prefill, engine.decode

        def timed(kind, fn):
            def call(*args):
                torch.cuda.synchronize()
                t = time.perf_counter()
                logits, cache = fn(*args)
                torch.cuda.synchronize()
                phases.append((kind, time.perf_counter() - t))
                finite.append(torch.isfinite(logits[..., : cfg.vocab]).all())
                return logits, cache
            return call

        engine.prefill, engine.decode = timed("prefill", prefill), timed("decode", decode)
        requests = [Request(rid=i, prompt=p, max_new=FAMILY_NEW) for i, p in enumerate(prompts)]
        waves = -(-FAMILY_REQUESTS // SERVE_BATCH)
        with KernelRecorder(keep_inputs=arch in FAMILY_QKV) as rec:
            _platform.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            done = engine.run(requests, extras)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _platform.launch_counts()
        calls = sum(1 for e in rec.events if e[0] == "attention")
        engine.prefill, engine.decode = prefill, decode
        check(sorted(r.rid for r in done) == list(range(FAMILY_REQUESTS)),
              f"{arch}: served {len(done)} of {FAMILY_REQUESTS} requests")
        for r in done:
            check(r.out is not None and len(r.out) == FAMILY_NEW
                  and bool(np.all((r.out >= 0) & (r.out < cfg.vocab))),
                  f"{arch}: request {r.rid} got {r.out}")
        check(bool(torch.stack(finite).all()), f"{arch}: non-finite logits on the path")
        check(counts["attention"] == n_attn * waves == calls,
              f"{arch}: attention launches {counts['attention']} (calls {calls}) != "
              f"{n_attn} attention layers x {waves} waves")
        check((counts["attention"] > 0) == (arch != "rwkv6_1_6b"),
              f"{arch}: attention launches {counts['attention']}")

        prefill_s = sum(t for k, t in phases if k == "prefill")
        decode_s = sum(t for k, t in phases if k == "decode")
        decode_steps = sum(1 for k, _ in phases if k == "decode")
        # one decode step of a prefilled wave, profiled: kernels and idle share
        cache = model.init_cache(SERVE_BATCH, max_seq)
        toks = torch.from_numpy(np.stack(prompts[:SERVE_BATCH])).to(dev)
        logits, cache = model.prefill({"tokens": toks, **extras}, cache)
        nxt = torch.argmax(logits[:, -1, : cfg.vocab], dim=-1).to(torch.int32)[:, None]
        step = device_profile(lambda: model.decode_step(nxt, cache, prompt_len), reps=3)
        info = dict(arch=arch, dtype=cfg.dtype, n_layers=cfg.n_layers,
                    n_enc_layers=cfg.n_enc_layers,
                    stub_inputs={k: list(v.shape) for k, v in extras.items()},
                    published_layers=get_arch(arch).n_layers, params=params,
                    requests=FAMILY_REQUESTS, batch=SERVE_BATCH, waves=waves,
                    prompt_tokens=prompt_len, new_tokens=FAMILY_NEW, init_s=init_s,
                    wall_s=wall, prefill_s=prefill_s, decode_s=decode_s,
                    prefill_tok_per_s=waves * SERVE_BATCH * prompt_len / prefill_s,
                    decode_tok_per_s=decode_steps * SERVE_BATCH / decode_s,
                    decode_steps=decode_steps, attention_launches=counts["attention"],
                    decode_step_kernels=step.get("device_events"),
                    decode_step_idle_share=step.get("idle_share"),
                    decode_step_busy_ms=step.get("busy_ms"),
                    decode_step_window_ms=step.get("window_ms"),
                    peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        if arch in FAMILY_QKV:
            # B4 against its plain version on the real layer-0 q/k/v of wave 1
            q, k, v = rec.largest["attention"][1]
            causal = FAMILY_QKV[arch]
            info["real_qkv_err"] = compare_attention(
                q, k, v, causal, f"{arch}'s layer 0 in serving (causal={causal})")
            info["real_qkv_shape"] = [list(q.shape), list(k.shape)]
            info["real_qkv_causal"] = causal
            if arch == "whisper_small":  # the encoder's call, timed in phase kernels
                check(q.shape[1] == cfg.n_frames,
                      f"{arch}: the largest B4 call has S {q.shape[1]}, not the encoder's "
                      f"{cfg.n_frames}")
                info["encoder_call"] = (q, k, v)
        if arch in FAMILY_INVARIANT:  # last: it widens the weights to f32
            info.update(recurrence_invariant(model, toks, nxt, extras, FAMILY_INVARIANT[arch]))
        emit(dict(phase="serve_families", card=card, **{
            k: round(v, 6) if isinstance(v, float) else v for k, v in info.items()
            if k != "encoder_call"}))
        out[arch] = info
        # the engine's bound methods hold the model too
        del model, engine, prefill, decode, rec, cache, logits, toks, nxt, extras
        gc.collect()
        torch.cuda.empty_cache()
    emit(dict(phase="serve_families", configs=len(out),
              seconds=round(time.perf_counter() - t_phase, 3)))
    return out


# ---------------------------------------------------------------------------
# LM training
# ---------------------------------------------------------------------------


def leaf_stats(tree: dict, init: dict) -> dict:
    """path -> sum, sum of |w|, norm and norm of the change from ``init``,
    in f64, over every leaf of a reference-layout numpy tree (as
    ``tests/test_torch_train.py`` writes them into the train goldens)."""
    import numpy as np

    from repro_torch.interop import tree_leaves

    out, init = {}, dict(tree_leaves(init))
    for key, w in tree_leaves(tree):
        w, w0 = np.asarray(w, np.float64), np.asarray(init[key], np.float64)
        out[key] = dict(sum=float(w.sum()), abs_sum=float(np.abs(w).sum()),
                        norm=float(np.linalg.norm(w)), delta_norm=float(np.linalg.norm(w - w0)))
    return out


def phase_train_golden(dev) -> dict:
    """The training path in f32 on the card against the reference's goldens
    (``tests/data/torch_golden_train.json``): 3 train steps of each config,
    the stub front ends' inputs from the file's ``context_seed`` where the
    config needs them, losses and grad norms at the file's rtol (or the
    golden's own), the weights' leaf sums, norms and change norms at its
    tolerances.  The MoE goldens' smallest router top-k gap, as the
    reference recorded it, is printed beside them."""
    import torch

    from repro_torch.configs.base import ArchConfig
    from repro_torch.interop import (
        context_inputs_numpy,
        lm_params_numpy,
        lm_params_to_numpy,
        load_lm_params,
    )
    from repro_torch.models import Model
    from repro_torch.train import optimizer as opt
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.train_step import TrainConfig, make_train_step

    golden = json.loads(TRAIN_GOLDEN.read_text())
    t0 = time.perf_counter()
    out = {}
    for g in golden["configs"]:
        t_config = time.perf_counter()
        tol = {**golden["tolerance"], **g.get("tolerance", {})}
        cfg = ArchConfig(**g["config"])
        init = lm_params_numpy(cfg, g["weight_seed"])
        model = load_lm_params(Model(cfg), init)
        tcfg = TrainConfig(optimizer=opt.OptimizerConfig(**golden["optimizer"]))
        state = opt.init(tcfg.optimizer, dict(model.named_parameters()))
        step = make_train_step(model, tcfg)
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, global_batch=golden["batch"],
                                      seq_len=golden["seq"], seed=g["data_seed"]))
        context = (context_inputs_numpy(cfg, golden["batch"], g["context_seed"])
                   if "context_seed" in g else {})
        worst = dict.fromkeys(("loss", "grad_norm", "lr"), 0.0)
        for i, want in enumerate(g["steps"]):
            state, got = step(state, {**data.batch(i), **context})
            for key in worst:
                worst[key] = max(worst[key], abs(float(got[key]) - want[key]) / abs(want[key]))
        check(worst["loss"] <= tol["loss_rtol"] and worst["grad_norm"] <= tol["grad_norm_rtol"]
              and worst["lr"] <= 1e-6, f"train golden {g['name']}: relative errors {worst}")
        stats = leaf_stats(lm_params_to_numpy(model), init)
        for key, want in g["leaves"].items():
            got = stats[key]
            check(abs(got["norm"] - want["norm"]) <= tol["norm_rtol"] * want["norm"]
                  and abs(got["sum"] - want["sum"]) <= tol["sum_abs_frac"] * want["abs_sum"]
                  and abs(got["delta_norm"] - want["delta_norm"])
                  <= tol["delta_norm_rtol"] * want["delta_norm"],
                  f"train golden {g['name']}: leaf {key} {got} != {want}")
        out[g["name"]] = dict(worst_rel_err=worst, leaves=len(stats),
                              context=sorted(context) or None,
                              router_min_gap=g.get("router_min_gap"),
                              card_only=g.get("card_only", False),
                              tolerance=g.get("tolerance"),
                              seconds=round(time.perf_counter() - t_config, 3))
        del model, state, step, init
    torch.cuda.empty_cache()
    emit(dict(phase="train_golden", configs=out, tolerance=golden["tolerance"],
              dtype="float32", seconds=round(time.perf_counter() - t0, 3)))
    return out


def device_profile(fn, reps: int, warmup: bool = True, host: bool = True) -> dict:
    """The card over ``reps`` calls of ``fn()`` (after one warm-up unless
    ``warmup`` is false), by ``torch.profiler``: its idle share (one less
    the union of the device activities' intervals over the window from the
    first event to the last), its ms a call by kind of kernel (matmuls,
    softmax, the rest) and its heaviest kernels.  With ``host`` false only
    the card is traced, so the window runs from its first activity to its
    last, and the device activities are read from the profiler's raw
    events (``kineto_results``): built into ``FunctionEvent``s, a trace of
    ~280,000 kernels a call (rwkv6's training step) took 53 s to read."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] if host else []
    with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    if not host:
        return _device_spans_profile(prof.profiler.kineto_results.events(), reps)
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start)
    if not spans:
        return dict(idle_share=None, note="not measured: the trace holds no device activity")
    window = (max(e.time_range.end for e in events) - min(e.time_range.start for e in events))
    ms = {}  # the kernels' own rows (the ops that launch them carry their time too)
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0:
            ms[evt.key[:90]] = ms.get(evt.key[:90], 0.0) + us / reps / 1e3
    return _profile_summary(_union_length(spans), window, len(spans), reps, ms)


def _union_length(spans: list) -> float:
    """The length of the union of sorted (start, end) intervals."""
    busy, cur_start, cur_end = 0.0, *spans[0]
    for start, end in spans[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    return busy + cur_end - cur_start


def _device_spans_profile(raw_events, reps: int) -> dict:
    """``device_profile``'s numbers from the profiler's raw events of a
    trace of the card alone: each device activity's name, start and end
    (in us, as ``FunctionEvent``s hold them), the window from the first
    start to the last end."""
    from torch.autograd import DeviceType

    rows = [(e.name(), e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
            for e in raw_events if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0]
    if not rows:
        return dict(idle_share=None, note="not measured: the trace holds no device activity")
    spans = sorted((start, end) for _, start, end in rows)
    window = max(end for _, end in spans) - spans[0][0]
    ms: dict = {}
    for name, start, end in rows:
        ms[name[:90]] = ms.get(name[:90], 0.0) + (end - start) / reps / 1e3
    return _profile_summary(_union_length(spans), window, len(spans), reps, ms)


def _profile_summary(busy: float, window: float, n_spans: int, reps: int, ms: dict) -> dict:
    """Idle share, busy and window ms a call, device events a call, and the
    kernels' ms a call by kind (matmul, softmax, the rest) and the heaviest,
    from the union of the device intervals (us) and each kernel's ms."""
    kinds = dict.fromkeys(("matmul", "softmax", "other"), 0.0)
    for name, t in ms.items():
        low = name.lower()
        kind = ("matmul" if any(w in low for w in ("gemm", "xmma", "cutlass", "nvjet"))
                else "softmax" if "softmax" in low else "other")
        kinds[kind] += t
    top = sorted(ms.items(), key=lambda kv: -kv[1])[:10]
    return dict(idle_share=1.0 - busy / window, busy_ms=busy / 1e3 / reps,
                window_ms=window / 1e3 / reps, device_events=n_spans // reps, reps=reps,
                device_ms_by_kind=kinds, top_kernels_ms=dict(top))


def train_flops(cfg, batch: int, seq: int) -> dict:
    """Operations of one train step from shapes, a multiply-add as two: 6 x
    the weight-matmul parameters a token passes through x tokens, plus the
    attention scores' QKᵀ and PV forward and backward.  The parameters a
    token uses: each layer's mixer (attention's q/k/v/o, a cross layer's
    q/o for the text and k/v for each context token; mamba's and rwkv's
    projections) and ffn (the dense MLP; a MoE layer's router, its top-k
    routed experts, its shared or dense MLP; rwkv's channel mix), the
    unembedding, and whisper's encoder layers for each of its frames.
    Scores: 6·B·nq·hd·S² a causal layer (the half of the matrix it needs),
    12·B·nq·hd·Sq·Sk a non-causal encoder or cross-attention layer.  The
    recurrent scans' elementwise work, the routing and remat's recompute
    are not counted; nor are the capacity slots an expert computes empty."""
    from repro_torch.models.model import context_input, padded_vocab
    from repro_torch.models.ssm import RWKV_DECAY_LORA, mamba_dims
    from repro_torch.models.transformer import layer_program

    d, hd, nq, nkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q_o, k_v = 2 * d * nq * hd, 2 * d * nkv * hd
    eff = cfg.expert_d_ff or cfg.d_ff
    d_in, dt_rank = mamba_dims(cfg)
    mixer_params = {"attn": q_o + k_v, "attn_nc": q_o + k_v, "cross": q_o,
                    "self_cross": 2 * q_o + k_v,
                    "mamba": 2 * d * d_in + d_in * (dt_rank + 2 * cfg.ssm_d_state)
                    + dt_rank * d_in + d_in * d,
                    "rwkv": 5 * d * d + 2 * d * RWKV_DECAY_LORA}
    ffn_params = {"mlp": 3 * d * cfg.d_ff, "rwkv_ffn": 2 * d * cfg.d_ff + d * d,
                  "moe": d * cfg.n_experts + (cfg.top_k + cfg.n_shared_experts) * 3 * d * eff
                  + (3 * d * cfg.d_ff if cfg.dense_residual else 0)}
    ctx = context_input(cfg)
    ctx_len = ctx[1] if ctx else 0
    program = layer_program(cfg)
    matmul_params = sum(mixer_params[p.mixer] + ffn_params[p.ffn] for p in program)
    matmul_params += d * padded_vocab(cfg.vocab)
    tokens, ctx_tokens = batch * seq, batch * ctx_len
    dense = 6 * matmul_params * tokens
    attn = 0
    for p in program:
        if p.mixer in ("attn", "self_cross"):
            attn += 6 * batch * nq * hd * seq * seq
        if p.mixer in ("cross", "self_cross"):
            dense += 6 * k_v * ctx_tokens  # the context's keys and values
            attn += 12 * batch * nq * hd * seq * ctx_len
    encoder = 0
    if cfg.n_enc_layers:
        encoder = cfg.n_enc_layers * (6 * (mixer_params["attn_nc"] + ffn_params["mlp"])
                                      * ctx_tokens + 12 * batch * nq * hd * ctx_len ** 2)
    return dict(matmul_params=matmul_params, dense_flops=dense, attention_flops=attn,
                encoder_flops=encoder, flops=dense + attn + encoder)


def phase_train(dev, card: str) -> dict:
    """Full-width, full-depth qwen3_0_6b in bf16 through ``run_supervised``
    on seeded ``SyntheticLM`` batches; then the trained weights serve
    through ``Model.forward`` (the attention kernel)."""
    import shutil
    import statistics

    import numpy as np
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import _platform
    from repro_torch.kernels.attention import attention_fwd
    from repro_torch.models import Model
    from repro_torch.train import optimizer as opt
    from repro_torch.train.checkpoint import Checkpointer
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.fault_tolerance import SupervisorConfig, run_supervised
    from repro_torch.train.train_step import TrainConfig, make_train_step

    cfg = get_arch(TRAIN_ARCH)
    t0 = time.perf_counter()
    model = Model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    params = dict(model.named_parameters())
    tcfg = TrainConfig(optimizer=opt.OptimizerConfig(
        lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS))
    state = opt.init(tcfg.optimizer, params)
    source = SyntheticLM(DataConfig(vocab=TRAIN_DATA_VOCAB, global_batch=TRAIN_BATCH,
                                    seq_len=TRAIN_SEQ, seed=2026))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    # the kernel refuses to be differentiated
    q = torch.randn(1, 256, cfg.n_heads, cfg.head_dim, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    kv = torch.randn(1, 256, cfg.n_kv_heads, cfg.head_dim, device=dev, dtype=torch.bfloat16)
    try:
        attention_fwd(q, kv, kv)
        fail("attention_fwd on CUDA tensors that require grad did not raise")
    except RuntimeError as e:
        check("no backward" in str(e), f"attention_fwd raised something else: {e}")
    with torch.no_grad():
        attention_fwd(q, kv, kv)  # and launches under no_grad
    del q, kv

    # every parameter has a finite gradient after the first backward
    batch0 = {k: torch.as_tensor(v, device=dev) for k, v in source.batch(0).items()}
    _platform.reset_launches()
    loss0, _ = model.loss(batch0)
    grads = torch.autograd.grad(loss0, list(params.values()))
    bad = [n for n, g in zip(params, grads) if not bool(torch.isfinite(g).all())]
    check(not bad, f"non-finite gradients after the first backward: {bad[:5]}")
    check(_platform.launch_counts()["attention"] == 0,
          "the attention kernel launched in a backward pass")
    del grads, loss0

    step_s: list = []
    step = make_train_step(model, tcfg)

    def timed_step(opt_state, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step(opt_state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        return out

    ckpt_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt = Checkpointer(str(ckpt_dir), keep=1)
    torch.cuda.reset_peak_memory_stats()
    _platform.reset_launches()
    t0 = time.perf_counter()
    _, state, history = run_supervised(
        train_step=timed_step, params=model, opt_state=state, data_source=source,
        n_steps=TRAIN_STEPS, ckpt=ckpt,
        cfg=SupervisorConfig(checkpoint_every=TRAIN_STEPS, async_checkpoint=False),
        log_every=0, log=lambda s: None)
    wall = time.perf_counter() - t0
    train_launches = _platform.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [loss for _, loss in history]
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)), f"losses {losses}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(last < first, f"the loss did not fall: first 5 {first}, last 5 {last}")
    check(train_launches["attention"] == 0,
          f"the attention kernel launched {train_launches['attention']} times in training")
    save = dict(ckpt.last_save)
    check(save.get("step") == TRAIN_STEPS, f"no checkpoint at step {TRAIN_STEPS}: {save}")
    saved = {n: params[n].detach().clone() for n in ("final_norm.scale", "blocks.0.attn.wq")}
    saved_step = int(state["step"])

    # host-clock split of steady steps, then the card's idle share
    batch = {k: torch.as_tensor(v, device=dev) for k, v in source.batch(TRAIN_STEPS).items()}
    fwd_bwd_s, opt_s = [], []
    for _ in range(TRAIN_SPLIT_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, _ = model.loss(batch)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        torch.cuda.synchronize()
        fwd_bwd_s.append(time.perf_counter() - t)
        t = time.perf_counter()
        opt.update(tcfg.optimizer, grads, state, params)
        torch.cuda.synchronize()
        opt_s.append(time.perf_counter() - t)
        del grads, loss
    idle = device_profile(lambda: step(state, batch), reps=TRAIN_PROFILE_STEPS)

    # the checkpoint restores into the live model and state
    t = time.perf_counter()
    ckpt.restore((model, state))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    check(int(state["step"]) == saved_step
          and all(torch.equal(params[n], w) for n, w in saved.items()),
          "the restored checkpoint differs from the weights it saved")
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    # the trained weights serve through Model.forward: the kernel, once a layer
    serve_batch = {"tokens": batch["tokens"][:TRAIN_SERVE_ROWS]}
    _platform.reset_launches()
    served = model.forward(serve_batch)
    serve_launches = _platform.launch_counts()["attention"]
    check(serve_launches == cfg.n_layers,
          f"serving the trained weights launched the kernel {serve_launches} times, "
          f"not {cfg.n_layers}")
    with torch.no_grad():
        trained = model.train_forward(serve_batch)
    tol = ATTN_TOL["bfloat16"]
    a, b = served[..., : cfg.vocab].float(), trained[..., : cfg.vocab].float()
    serve_err = float((a - b).abs().max())
    check(torch.allclose(a, b, rtol=tol, atol=tol),
          f"served logits differ from the loss path's by {serve_err} (tolerance {tol})")
    del served, trained, a, b

    median_s = statistics.median(step_s)
    flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    info = dict(arch=cfg.arch, dtype=cfg.dtype, n_layers=cfg.n_layers,
                params=sum(p.numel() for p in params.values()), batch=TRAIN_BATCH,
                data_vocab=TRAIN_DATA_VOCAB,
                seq=TRAIN_SEQ, tokens_per_step=tokens, steps=TRAIN_STEPS, remat=cfg.remat,
                lr=TRAIN_LR, init_s=init_s, wall_s=wall, step_s=step_s,
                median_step_s=median_s, tokens_per_s=tokens / median_s,
                fwd_bwd_s=statistics.median(fwd_bwd_s), optimizer_s=statistics.median(opt_s),
                loss_first=losses[0], loss_last=losses[-1], loss_first5=first,
                loss_last5=last, losses=losses, peak_mem_gb=peak_gb, **flops,
                flop_share_of_bf16_peak=flops["flops"] / median_s / PEAK_BF16_OPS_PER_S,
                checkpoint_bytes=save["bytes"], checkpoint_snapshot_s=save["snapshot_s"],
                checkpoint_write_s=save["write_s"], checkpoint_restore_s=restore_s,
                train_launches=train_launches["attention"], serve_launches=serve_launches,
                serve_vs_loss_path_max_abs_err=serve_err, **idle)
    if idle.get("busy_ms") is not None:
        # the profiler slows the host and so widens its window: the busy
        # time against the unprofiled median step too
        info["idle_share_of_median_step"] = 1.0 - idle["busy_ms"] / 1e3 / median_s
    emit(dict(phase="train", card=card, **{k: round(v, 6) if isinstance(v, float) else v
                                           for k, v in info.items()
                                           if k not in ("losses", "step_s")}))
    del model, state, params, batch, batch0, serve_batch
    torch.cuda.empty_cache()
    return info


def train_reckoning(model, batch: int, seq: int, ocfg) -> dict:
    """The memory a train step needs from shapes, in GB: weights and
    gradients (each leaf's own dtype: the router, SSM decays and mixes are
    f32), m and v (``ocfg``'s dtypes), the f32 logits and their gradient,
    and the larger of two transients on the largest leaf: the optimizer's
    f32 temporaries on a slice of ``UPDATE_CHUNK`` elements (nine at once)
    and ``global_norm``'s widened square of its gradient (two).  An upper
    bound for the step, as the logits are gone before the update."""
    from repro_torch.train.optimizer import UPDATE_CHUNK

    params = list(model.parameters())
    n = sum(p.numel() for p in params)
    weights = sum(p.numel() * p.element_size() for p in params)
    m_bytes = 2 if ocfg.moment_dtype == "bfloat16" else 4
    v_bytes = m_bytes if ocfg.aggressive else 4
    largest = max(p.numel() for p in params)
    out = dict(params=n, weights_gb=weights / 1e9, grads_gb=weights / 1e9,
               moments_gb=n * (m_bytes + v_bytes) / 1e9,
               logits_gb=2 * batch * seq * model.vocab_padded * 4 / 1e9,
               largest_leaf=largest,
               transient_gb=max(9 * 4 * min(largest, UPDATE_CHUNK), 2 * 4 * largest) / 1e9)
    out["reckoned_gb"] = sum(v for k, v in out.items() if k.endswith("_gb"))
    return out


def moe_drop_share(model, batch: dict) -> float | None:
    """The share of (token, slot) pairs that the MoE layers' capacity
    dropped in one forward pass of the training path over ``batch`` (no
    gradient), or None without experts: ``moe.route``'s kept mask,
    recorded."""
    import torch

    from repro_torch.models import moe as moe_mod

    if not model.cfg.n_experts:
        return None
    kept, route = [], moe_mod.route

    def recording(*args, **kw):
        r = route(*args, **kw)
        kept.append(r.keep)
        return r

    moe_mod.route = recording
    try:
        with torch.no_grad():
            model.train_forward(batch)
    finally:
        moe_mod.route = route
    return 1.0 - float(sum(k.sum() for k in kept)) / sum(k.numel() for k in kept)


def phase_train_families(dev, card: str) -> dict:
    """The MoE, SSM, hybrid, encoder-decoder and vision-language families
    trained at their published widths in bf16 (``FAMILY_TRAIN``), one model
    at a time: seeded ``Model.init`` on the card, ``SyntheticLM`` batches
    with ids below ``TRAIN_DATA_VOCAB`` and the stub front ends' inputs,
    remat on.  The steps between the first and the last run through
    ``make_train_step``; those two take its three calls one by one, to
    hold the first gradients and to time the last one's parts.  Arctic is
    reckoned, not trained (``FAMILY_UNTRAINED``)."""
    import dataclasses
    import gc
    import statistics

    import numpy as np
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.interop import context_inputs_numpy
    from repro_torch.kernels import _platform
    from repro_torch.models import Model
    from repro_torch.models.model import context_input
    from repro_torch.train import optimizer as opt
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.train_step import TrainConfig, make_train_step

    t_phase = time.perf_counter()
    out = {}
    for arch in FAMILY_UNTRAINED:
        cfg = dataclasses.replace(get_arch(arch), n_layers=1)
        n = cfg.param_count()
        out[arch] = dict(arch=arch, trained=False, n_layers=1, params=n,
                         f32_moments_gb=12 * n / 1e9, bf16_moments_gb=8 * n / 1e9)
        emit(dict(phase="train_families", card=card, **{
            k: round(v, 6) if isinstance(v, float) else v for k, v in out[arch].items()}))
    for arch, layers, batch_size, seq, moments, steps, profiled in FAMILY_TRAIN:
        base = get_arch(arch)
        cfg = dataclasses.replace(base, n_layers=layers) if layers else base
        ocfg = opt.OptimizerConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=steps,
                                   moment_dtype=moments, aggressive=moments == "bfloat16")
        t0 = time.perf_counter()
        model = Model(cfg).init(torch.Generator(device=dev).manual_seed(0))
        params = dict(model.named_parameters())
        state = opt.init(ocfg, params)
        source = SyntheticLM(DataConfig(vocab=TRAIN_DATA_VOCAB, global_batch=batch_size,
                                        seq_len=seq, seed=2026))
        context = {k: torch.as_tensor(v, device=dev) for k, v in
                   context_inputs_numpy(cfg, batch_size, FAMILY_STUB_SEED).items()}

        def batch_at(i):
            return {**{k: torch.as_tensor(v, device=dev) for k, v in source.batch(i).items()},
                    **context}

        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        reckoning = train_reckoning(model, batch_size, seq, ocfg)
        # the leaves that read the context: the encoder's, a cross layer's
        # attention, a self_cross layer's cross-attention and its norm
        prefixes = ["enc."]
        for i, spec in enumerate(model.program):
            if spec.mixer == "cross":
                prefixes.append(f"blocks.{i}.attn.")
            elif spec.mixer == "self_cross":
                prefixes += [f"blocks.{i}.cross.", f"blocks.{i}.norm_cross."]
        watched = [n for n in params if n.startswith(tuple(prefixes))]
        check(bool(watched) == bool(context), f"{arch}: context leaves {watched[:5]}")

        def split_step(batch, first: bool = False) -> tuple:
            """One train step as ``make_train_step``'s, its forward +
            backward and its update timed apart on the host's clock; the
            first also holds its gradients: all finite, and no
            context leaf's all zero."""
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss, aux = model.loss(batch)
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
            torch.cuda.synchronize()
            fwd_bwd = time.perf_counter() - t
            if first:
                bad = [n for n, g in grads.items() if not bool(torch.isfinite(g).all())]
                check(not bad, f"{arch}: non-finite gradients after the first backward: "
                      f"{bad[:5]}")
                zero = [n for n in watched if not bool(grads[n].ne(0).any())]
                check(not zero, f"{arch}: cross-attention or encoder leaves with a zero "
                      f"gradient: {zero[:5]}")
            t = time.perf_counter()
            _, opt_metrics = opt.update(ocfg, grads, state, params)
            torch.cuda.synchronize()
            metrics = {k: float(v.detach()) for k, v in {"loss": loss, **aux,
                                                         **opt_metrics}.items()}
            return fwd_bwd, time.perf_counter() - t, metrics

        # step 0 holds the first gradients, steps 1 .. n-2 run through
        # make_train_step, the last is split into forward + backward and
        # update; then steady steps profiled and a forward for the drops
        torch.cuda.reset_peak_memory_stats()
        _platform.reset_launches()
        step = make_train_step(model, TrainConfig(optimizer=ocfg))
        losses, step_s = [], []
        for i in range(steps):
            batch = batch_at(i)
            if i in (0, steps - 1):
                fwd_bwd_s, opt_s, metrics = split_step(batch, first=i == 0)
                step_s.append(fwd_bwd_s + opt_s)
            else:
                torch.cuda.synchronize()
                t = time.perf_counter()
                state, metrics = step(state, batch)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t)
            losses.append(float(metrics["loss"]))
        last = {k: float(v) for k, v in metrics.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(all(np.isfinite(losses)), f"{arch}: losses {losses}")
        first = float(np.mean(losses[:FAMILY_LOSS_STEPS]))
        final = float(np.mean(losses[-FAMILY_LOSS_STEPS:]))
        check(final < first, f"{arch}: the loss did not fall: first {first}, last {final}")
        aux = {k: last[k] for k in ("moe_lb_loss", "moe_z_loss")} if cfg.n_experts else {}
        check(all(np.isfinite(list(aux.values()))), f"{arch}: MoE aux losses {aux}")
        check(peak_gb < FAMILY_PEAK_LIMIT_GB, f"{arch}: peak {peak_gb:.2f} GB")
        t = time.perf_counter()
        idle = device_profile(lambda: step(state, batch), reps=profiled, warmup=False,
                              host=False)
        profile_s = time.perf_counter() - t
        dropped = moe_drop_share(model, batch)
        # none in any step: the split, timed and profiled ones
        launches = _platform.launch_counts()["attention"]
        check(launches == 0, f"{arch}: the attention kernel launched {launches} times "
              f"in training")

        median_s = statistics.median(step_s[1:])  # the first step warms up
        flops = train_flops(cfg, batch_size, seq)
        tokens = batch_size * seq
        info = dict(arch=arch, trained=True, dtype=cfg.dtype, n_layers=cfg.n_layers,
                    n_enc_layers=cfg.n_enc_layers, batch=batch_size, seq=seq,
                    context=context_input(cfg), moment_dtype=moments,
                    aggressive=ocfg.aggressive, steps=steps, remat=cfg.remat, init_s=init_s,
                    step_s=step_s, median_step_s=median_s, tokens_per_s=tokens / median_s,
                    fwd_bwd_s=fwd_bwd_s, optimizer_s=opt_s, losses=losses,
                    loss_first3=first, loss_last3=final, peak_gb=peak_gb, **reckoning,
                    **flops,
                    flop_share_of_bf16_peak=flops["flops"] / median_s / PEAK_BF16_OPS_PER_S,
                    train_launches=launches, moe_aux_last=aux or None,
                    moe_dropped_share=dropped, watched_leaves=len(watched),
                    profile_s=profile_s, **idle)
        if idle.get("busy_ms") is not None:
            info["idle_share_of_median_step"] = 1.0 - idle["busy_ms"] / 1e3 / median_s
        emit(dict(phase="train_families", card=card, **{
            k: round(v, 6) if isinstance(v, float) else v for k, v in info.items()
            if k not in ("step_s", "top_kernels_ms")}))
        out[arch] = info
        del model, params, state, step, batch, context
        gc.collect()
        torch.cuda.empty_cache()
    launches = sum(f.get("train_launches", 0) for f in out.values())
    emit(dict(phase="train_families", configs=len(out), families_train_launches=launches,
              seconds=round(time.perf_counter() - t_phase, 3)))
    out["families_train_launches"] = launches
    return out


def supervised_resume(dev, cfg, source, label: str) -> dict:
    """``cfg`` through ``run_supervised`` for ``FT_STEPS`` steps with sync
    checkpoints every ``FT_EVERY`` steps (under ``build/``) and failures
    injected at ``FT_FAILURES``, then again with no failure and a checkpoint
    only at the end: parameters and moments must be bit-equal.  Run under
    deterministic algorithms."""
    import shutil

    import torch

    from repro_torch.models import Model
    from repro_torch.train import optimizer as opt
    from repro_torch.train.checkpoint import Checkpointer
    from repro_torch.train.fault_tolerance import SupervisorConfig, run_supervised
    from repro_torch.train.train_step import TrainConfig, make_train_step

    tcfg = TrainConfig(optimizer=opt.OptimizerConfig(
        lr=TRAIN_LR, warmup_steps=2, total_steps=FT_STEPS))

    def run(run_label: str, failures: set, every: int):
        model = Model(cfg).init(torch.Generator(device=dev).manual_seed(0))
        state = opt.init(tcfg.optimizer, dict(model.named_parameters()))
        directory = ROOT / "build" / f"train_ft_{label}_{run_label}"
        shutil.rmtree(directory, ignore_errors=True)
        ckpt = Checkpointer(str(directory), keep=2)
        saves: list = []
        save = ckpt.save

        def counted_save(step, tree, meta=None):
            save(step, tree, meta)
            saves.append(dict(ckpt.last_save))

        ckpt.save = counted_save

        def fail_at(step):
            if step in failures:
                failures.discard(step)
                return True
            return False

        log: list = []
        t0 = time.perf_counter()
        _, state, history = run_supervised(
            train_step=make_train_step(model, tcfg), params=model, opt_state=state,
            data_source=source, n_steps=FT_STEPS, ckpt=ckpt,
            cfg=SupervisorConfig(checkpoint_every=every, async_checkpoint=False),
            fail_at=fail_at, log_every=0, log=log.append)
        wall = time.perf_counter() - t0
        shutil.rmtree(directory, ignore_errors=True)
        return model, state, history, dict(wall_s=wall, saves=saves, log=log)

    torch.use_deterministic_algorithms(True)
    try:
        failures = set(FT_FAILURES)
        model, state, history, faulted = run("faults", failures, FT_EVERY)
        check(not failures, f"{label}: failures {failures} were not injected")
        steps = [s for s, _ in history]
        check(steps[-1] == FT_STEPS and set(range(1, FT_STEPS + 1)) <= set(steps),
              f"{label}: supervised steps {steps}")
        clean_model, clean_state, clean_history, clean = run("clean", set(), FT_STEPS)
    finally:
        torch.use_deterministic_algorithms(False)
    for (name, a), b in zip(model.named_parameters(), clean_model.parameters()):
        check(torch.equal(a, b), f"{label}: parameter {name} differs from the clean run")
    check(int(state["step"]) == int(clean_state["step"]) == FT_STEPS,
          f"{label}: steps {int(state['step'])} and {int(clean_state['step'])}")
    for moment in ("m", "v"):
        for name, a in state[moment].items():
            check(torch.equal(a, clean_state[moment][name]),
                  f"{label}: moment {moment} of {name} differs from the clean run")
    restarts = sum(1 for line in faulted["log"] if "-> restart" in line)
    check(restarts == len(FT_FAILURES), f"{label}: {restarts} restarts: {faulted['log']}")
    info = dict(arch=cfg.arch, n_layers=cfg.n_layers, vocab=cfg.vocab,
                params=sum(p.numel() for p in model.parameters()),
                batch=source.cfg.global_batch, seq=source.cfg.seq_len, steps=FT_STEPS,
                checkpoint_every=FT_EVERY, failures=list(FT_FAILURES), restarts=restarts,
                checkpoint_bytes=faulted["saves"][0]["bytes"],
                saves_faulted=len(faulted["saves"]), saves_clean=len(clean["saves"]),
                save_s=[s["snapshot_s"] + s["write_s"] for s in faulted["saves"]],
                faulted_wall_s=faulted["wall_s"], clean_wall_s=clean["wall_s"],
                loss_last=clean_history[-1][1])
    del model, state, clean_model, clean_state
    torch.cuda.empty_cache()
    return info


def launch_child(label: str, *args: str) -> dict:
    """``python -m repro_torch.launch.train *args`` as a child on the card
    (no ``--device``), its checkpoints under ``build/``, its log in
    ``chiprun_out/<label>.log``; it must exit 0 and print ``done:``."""
    import shutil

    launch_dir = ROOT / "build" / f"{label}_ckpt"
    shutil.rmtree(launch_dir, ignore_errors=True)
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args, "--ckpt-dir",
         str(launch_dir)], cwd=ROOT, env=serve_env(), capture_output=True, text=True,
        timeout=600)
    seconds = time.perf_counter() - t
    shutil.rmtree(launch_dir, ignore_errors=True)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / f"{label}.log").write_text(proc.stdout + proc.stderr)
    check(proc.returncode == 0, f"{label}: the launcher exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    check("done: " in proc.stdout and "device=cuda" in proc.stdout,
          f"{label}: the launcher printed {proc.stdout[-1000:]}")
    return dict(args=list(args), seconds=seconds, stdout=[
        line for line in proc.stdout.splitlines() if line.startswith(("done:", "moe aux"))])


def phase_sim_benches(card: str) -> dict:
    """``benchmarks/bench_{semexec,engine,host}_torch.py --tiny`` as children
    on the card (no ``--device``): each must exit 0 (its own equivalence
    checks passed), match the 8 golden tiny trace hashes where it checks
    them, and have launched its kernels; the results and logs go to
    ``chiprun_out/bench_torch/``."""
    out_dir = OUT_DIR / "bench_torch"
    out_dir.mkdir(parents=True, exist_ok=True)
    info = {}
    t_phase = time.perf_counter()
    for module, kernels in SIM_BENCHES:
        out = out_dir / f"{module}_tiny.json"
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", f"benchmarks.{module}", "--tiny",
                               "--out", str(out)], cwd=ROOT, env=serve_env(),
                              capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t
        (out_dir / f"{module}_tiny.log").write_text(proc.stdout + proc.stderr)
        check(proc.returncode == 0, f"{module} --tiny exited {proc.returncode}: "
              f"{proc.stdout[-1500:]}{proc.stderr[-1500:]}")
        res = json.loads(out.read_text())
        check(res["device"].startswith("cuda") and res["card"], f"{module}: device {res['device']}")
        if module != "bench_engine_torch":  # its tiny chunk is not the golden one
            check(res.get("golden_match") == "8/8", f"{module}: golden {res.get('golden_match')}")
        if module == "bench_semexec_torch":
            launches = res["launches_per_pass"]
        else:
            key = "sequential" if module == "bench_engine_torch" else "overhauled"
            launches = {"dram_timing": res[key]["dram_timing_launches"]}
        check(all(launches[k] > 0 for k in kernels), f"{module}: launches {launches}")
        info[module] = dict(seconds=seconds, launches={k: launches[k] for k in kernels},
                            golden_match=res.get("golden_match"))
        emit(dict(phase="sim_benches", bench=module, card=card, **info[module]))
    info["seconds"] = time.perf_counter() - t_phase
    return info


def phase_train_ft(dev, card: str) -> dict:
    """The fault path at full width: qwen3 cut to 2 layers, then qwen2-moe
    cut to 1 layer and an 8,192-token vocab (the experts in the
    checkpoints); failures injected at steps 5 and 9 with sync checkpoints
    every 4 steps must end bit-equal to a clean run (deterministic
    algorithms on, for this phase only).  Then the launcher as a child
    process on the card, on qwen3 and on qwen2-moe (its MoE aux line)."""
    import dataclasses

    from repro_torch.configs.base import get_arch
    from repro_torch.train.data import DataConfig, SyntheticLM

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), n_layers=FT_LAYERS)
    dense = supervised_resume(dev, cfg, SyntheticLM(DataConfig(
        vocab=cfg.vocab, global_batch=FT_BATCH, seq_len=FT_SEQ, seed=7)), "dense")
    moe_cfg = dataclasses.replace(get_arch(FT_MOE_ARCH), n_layers=1, vocab=FT_MOE_VOCAB)
    moe = supervised_resume(dev, moe_cfg, SyntheticLM(DataConfig(
        vocab=FT_MOE_VOCAB, global_batch=FT_BATCH, seq_len=FT_SEQ, seed=7)), "moe")
    launcher = launch_child("train_launch", "--layers", str(FT_LAYERS),
                            "--steps", str(LAUNCH_STEPS))
    check(f"done: {LAUNCH_STEPS} steps" in launcher["stdout"][0],
          f"the launcher printed {launcher['stdout']}")
    launcher_moe = launch_child("train_launch_moe", *LAUNCH_MOE)
    check(any(line.startswith("moe aux, last step: moe_lb_loss") for line in
              launcher_moe["stdout"]), f"the MoE launcher printed {launcher_moe['stdout']}")
    info = dict(dense, moe=moe, launcher=launcher, launcher_moe=launcher_moe,
                seconds=time.perf_counter() - t0)
    emit(dict(phase="train_ft", card=card, bit_equal=True, **{
        k: round(v, 6) if isinstance(v, float) else v for k, v in info.items()}))
    return info


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_distributed(dev, card: str) -> dict:
    """The sharded train and serve steps on a 1x1 NCCL mesh against the
    unsharded ones, B4 on DTensors, and the dry run of three production
    cells, a child each."""
    import statistics

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.configs.base import get_arch
    from repro_torch.distributed.context import whole
    from repro_torch.kernels import _platform
    from repro_torch.kernels.attention import attention_fwd, attention_plain
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.models import Model
    from repro_torch.serve.legacy.serve_step import (jit_serve_steps, make_decode_step,
                                                     make_prefill_step)
    from repro_torch.train import optimizer as opt
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.train_step import TrainConfig, jit_train_step, make_train_step

    t_phase = time.perf_counter()
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{free_port()}", rank=0, world_size=1)
    info: dict = {}
    try:
        mesh = make_dev_mesh(1, model=1, device=dev.type)

        # (d) B4's op on DTensor inputs, placed on the mesh, against plain
        rng = np.random.default_rng(2027)
        worst = 0.0
        for b, s, nq, nkv, hd, causal in ((4, 1024, 16, 8, 128, True), (2, 256, 4, 2, 64, False)):
            q, k, v = (torch.from_numpy(rng.standard_normal((b, s, n, hd), np.float32))
                       .to(dev, torch.bfloat16) for n in (nq, nkv, nkv))
            dq, dk, dv = (distribute_tensor(t, mesh, (Replicate(), Replicate()),
                                            src_data_rank=None) for t in (q, k, v))
            with torch.no_grad():
                _platform.reset_launches()
                got = attention_fwd(dq, dk, dv, causal=causal).full_tensor()
                check(_platform.launch_counts()["attention"] == int(dev.type == "cuda"),
                      "B4's op on DTensors did not launch the kernel once")
                want = attention_plain(q, k, v, causal=causal)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            check(err <= ATTN_TOL["bfloat16"], f"B4 op on DTensors != plain: {err}")
            worst = max(worst, err)
        info["dtensor_attention_err"] = worst

        # (a) training: the same seeded weights and batches, unsharded then sharded
        cfg = get_arch(TRAIN_ARCH)
        tcfg = TrainConfig(optimizer=opt.OptimizerConfig(
            lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS))
        source = SyntheticLM(DataConfig(vocab=TRAIN_DATA_VOCAB, global_batch=TRAIN_BATCH,
                                        seq_len=TRAIN_SEQ, seed=2031))
        def train(sharded: bool) -> dict:
            """DIST_STEPS steps from seeded weights; the weights after them
            on the host."""
            model = Model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
            step = (jit_train_step(model, mesh, tcfg)(source.batch(0)) if sharded
                    else make_train_step(model, tcfg))
            state = opt.init(tcfg.optimizer, dict(model.named_parameters()))
            losses, secs = [], []
            _platform.reset_launches()
            for i in range(DIST_STEPS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                state, metrics = step(state, source.batch(i))
                losses.append(float(metrics["loss"]))
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t)
            return dict(losses=losses, step_s=secs, median_step_s=statistics.median(secs[1:]),
                        attention_launches=_platform.launch_counts()["attention"],
                        params={n: whole(p).detach().cpu() for n, p in model.named_parameters()})

        torch.use_deterministic_algorithms(True)
        try:
            runs = {"unsharded": train(False)}
            torch.cuda.empty_cache()
            runs["sharded"] = train(True)
            torch.cuda.empty_cache()
        finally:
            torch.use_deterministic_algorithms(False)
        want, got = (runs[k].pop("params") for k in ("unsharded", "sharded"))
        diff = max(float((got[n].float() - w.float()).abs().max()) for n, w in want.items())
        del want, got
        # one rank runs the unsharded step's ops under deterministic
        # algorithms, so the runs are held bit-equal: 3 Adam steps at this
        # lr move a weight by at most ~4e-4, and any looser bound would
        # pass a sharded step that never updated the weights
        check(runs["sharded"]["losses"] == runs["unsharded"]["losses"],
              f"sharded losses {runs['sharded']['losses']} != unsharded "
              f"{runs['unsharded']['losses']}")
        check(diff == 0.0, f"sharded weights differ from unsharded by {diff}")
        check(runs["sharded"]["attention_launches"] == 0,
              "the attention kernel launched in training")
        info["train"] = dict(runs, max_param_diff=diff, bit_equal=True)

        # (b) serving: unsharded, then the same weights through jit_serve_steps
        model = Model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(1))
        prompt = torch.from_numpy(np.random.default_rng(2032).integers(
            0, cfg.vocab, (DIST_SERVE_BATCH, DIST_PROMPT))).to(dev)
        max_seq = DIST_PROMPT + DIST_NEW

        def serve(prefill, decode):
            cache = model.init_cache(DIST_SERVE_BATCH, max_seq)
            torch.cuda.synchronize()
            t = time.perf_counter()
            last, cache = prefill({"tokens": prompt}, cache)
            tok = torch.argmax(last[:, -1, :], dim=-1).to(torch.int32)[:, None]
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t
            toks, logits = [tok], []
            t = time.perf_counter()
            for i in range(DIST_NEW - 1):
                tok, lg, cache = decode(tok, cache, DIST_PROMPT + i)
                toks.append(tok)
                logits.append(lg.float())
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t
            return dict(tokens=torch.cat(toks, 1), logits=torch.stack(logits),
                        prefill_s=prefill_s, decode_s=decode_s,
                        decode_tok_s=DIST_SERVE_BATCH * (DIST_NEW - 1) / decode_s)

        with torch.no_grad():
            plain = serve(make_prefill_step(model), make_decode_step(model))
            prefill, decode, _ = jit_serve_steps(model, mesh, DIST_SERVE_BATCH, max_seq)
            _platform.reset_launches()
            sharded = serve(prefill, decode)
            launches = _platform.launch_counts()["attention"]
        logit_diff = float((sharded["logits"] - plain["logits"]).abs().max())
        check(torch.equal(sharded["tokens"], plain["tokens"]),
              "sharded greedy tokens differ from unsharded")
        check(logit_diff <= DIST_LOGIT_TOL, f"sharded logits differ by {logit_diff}")
        check(launches > 0, "no B4 launch through the op in sharded serving")
        info["serve"] = {label: {k: r[k] for k in ("prefill_s", "decode_s", "decode_tok_s")}
                         for label, r in (("unsharded", plain), ("sharded", sharded))}
        info["serve"].update(max_logit_diff=logit_diff, attention_launches=launches,
                             tokens_equal=True)
        del model, plain, sharded, prefill, decode
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # (c) the dry run, a child a cell (each its own fake process group of
    # 256 ranks), all started together
    out_dir = OUT_DIR / "dryrun_smoke"
    t = time.perf_counter()
    children = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a, "--shape", s_,
         "--mesh", "single", "--force", "--out", str(out_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=serve_env(), cwd=ROOT)
        for a, s_ in DIST_CELLS]
    logs = []
    try:
        for (a, s_), child in zip(DIST_CELLS, children):
            log = child.communicate(timeout=600)[0]
            logs.append(f"== {a} {s_}: exit {child.returncode}\n{log}")
            check(child.returncode == 0, f"the dry run of {a} {s_} failed: {log[-3000:]}")
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
                child.wait()
        (OUT_DIR / "dryrun_smoke.log").write_text("\n".join(logs))
    info["dryrun_s"] = time.perf_counter() - t
    cells = {}
    for arch, shape in DIST_CELLS:
        rec = json.loads((out_dir / "single" / f"{arch}__{shape}.json").read_text())
        check(rec["status"] == "ok" and rec["chips"] == 256, f"dry run {arch} {shape}: {rec}")
        ops = rec["op_analysis"]
        cells[f"{arch}__{shape}"] = dict(
            flops_per_device=ops["flops_per_device"], bytes_per_device=ops["bytes_per_device"],
            collectives_by_op=ops["collectives_by_op"], peak_bytes=rec["memory"]["peak_bytes"],
            argument_bytes=rec["memory"]["argument_bytes"],
            peak_over_card=rec["memory"]["peak_bytes"] / CARD_BYTES,
            roofline=rec["roofline"], setup_s=rec["setup_s"], run_s=rec["run_s"],
            useful_flops_ratio=rec["useful_flops_ratio"])
    info["dryrun"] = cells
    info["seconds"] = time.perf_counter() - t_phase
    emit(dict(phase="distributed", card=card, **info))
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
    import os

    # cuBLAS reads this when its first handle is made: phase train_ft's
    # deterministic algorithms need it, so it is set before torch loads
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    if not (ROOT / "src" / "repro_torch").is_dir() or not GOLDEN.exists() \
            or not SERVE_GOLDEN.exists() or not SWEEP_GOLDEN.exists() \
            or not TRAIN_GOLDEN.exists():
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

    # 6. the sweep runner: the paper's tab4 on lj, every mode and engine
    sweep = phase_sweep(graphs, smi)

    # 7. adaptive search in this process: the tiny smoke, then lj
    search = phase_search(graphs, smi)

    # 8. the sweep server: warm spawn workers on the card, five jobs
    sweep_server = phase_sweep_server(graphs, smi, search)

    # 9. multi-host serving: two worker hosts on the card
    multihost = phase_multihost(graphs, smi)

    # 9b. the port's twins of the simulator benches, as a user runs them
    sim_benches = phase_sim_benches(smi)

    # 10. the LM serving path in f32 against the reference's goldens
    serve_golden = phase_serve_golden(dev)

    # 11. the LM serving path at full size
    serve = phase_serve(dev, smi)
    worst["attention"] = max(worst["attention"], serve["real_qkv_err"])

    # 12. the MoE, hybrid, SSM, encoder-decoder and vision-language families
    families = phase_serve_families(dev, smi)
    worst["attention"] = max(worst["attention"],
                             *(families[arch]["real_qkv_err"] for arch in FAMILY_QKV))
    families_launches = sum(f["attention_launches"] for f in families.values())
    encoder_call = families["whisper_small"].pop("encoder_call")

    # 13. the LM training path in f32 against the reference's goldens
    train_golden = phase_train_golden(dev)

    # 14. the LM training path at full size, then its weights served
    train = phase_train(dev, smi)

    # 15. the fault path at full width, bit-equal to a clean run; the launcher
    train_ft = phase_train_ft(dev, smi)

    # 16. the MoE, SSM, hybrid, encoder-decoder and vision-language families
    # trained at full width
    train_families = phase_train_families(dev, smi)

    # 17. the sharded steps on DTensor over a 1x1 NCCL mesh; the dry run
    distributed = phase_distributed(dev, smi)
    worst["attention"] = max(worst["attention"], distributed["dtensor_attention_err"])

    # 18. kernel timing at each path's largest call
    timing = {"dram_timing": phase_kernel_timing(dev, info["batch"]),
              "edge_update": phase_edge_update_timing(
                  device_info["largest"]["edge_update"][1], device_info["foregraph_call"]),
              "spmv": phase_spmv_timing(device_info["largest"]["spmv"][1]),
              "attention": phase_attention_timing(*serve.pop("largest"))}
    # B4 on whisper's encoder (non-causal, S 1,500) beside its largest causal call
    timing["attention"]["encoder_call"] = phase_attention_timing(*encoder_call, causal=False)
    worst["attention"] = max(worst["attention"],
                             timing["attention"]["encoder_call"]["max_abs_err"])
    launches = {"dram_timing": info["counts"]["dram_timing"],
                "edge_update": device_info["counts"]["edge_update"],
                "spmv": device_info["counts"]["spmv"],
                "attention": serve["launches"]}
    for name in KERNELS:
        emit(dict(phase="kernel_timing", kernel=name, launches=launches[name],
                  **timing[name]))

    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        dict(card=smi, scenarios=rows, device_pairs=device_rows, sweep=sweep,
             search=search, sweep_server=sweep_server, multihost=multihost,
             sim_benches=sim_benches, serve_golden=serve_golden, serve=serve,
             serve_families=families,
             train_golden=train_golden, train=train, train_ft=train_ft,
             train_families=train_families, distributed=distributed,
             kernel_timing=timing, attention_sass=sass),
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
        sweep_launches=sweep["launches"][name],
        served_launches=sweep_server["served_launches"][name],
        multihost_launches=multihost["multihost_launches"][name],
        **({"train_launches": train["train_launches"],
            "train_serve_launches": train["serve_launches"],
            "families_launches": families_launches,
            "families_train_launches": train_families["families_train_launches"],
            "distributed_launches": distributed["serve"]["attention_launches"],
            "encoder_call": {key: timing[name]["encoder_call"][key] for key in (
                "shape", "ms", "graph_ms", "bound_ms", "bound_by", "library_ms",
                "graph_library_ms", "plain_ms", "max_abs_err")}}
           if name == "attention" else {}),
        **{key: timing[name][key] for key in EXTRA_KEYS if key in timing[name]},
        card=smi) for name in KERNELS]))
    print(smi, flush=True)
    emit(dict(ok=True, device=dict(platform="gpu", kind=kind,
                                   count=torch.cuda.device_count())))


if __name__ == "__main__":
    main()
