"""The port's dry run (``python -m repro_torch.launch.dryrun``) on the CPU.

Each run is a child process (the fake process group of 256 ranks is
process-wide state).  On the reference's own test cell, ``qwen3_0_6b
decode_32k single``: status ``ok``, 256 chips, a dominant roofline term
from the reference's set, and the record's keys; ``benchmarks/run_torch.py
--benches roofline`` summarises it.  On it and on ``train_4k`` the
counted FLOPs per device are within ``FLOPS_TOL`` of a closed-form
reckoning from the config (every matmul of the step, 256-way sharded; in
training the blocks three times under remat plus their backward, whose
attention recomputes QK^T, and the unembedding once plus its backward): a
product that DTensor runs on the
whole batch or on every "model" column of a rank counts many times over.
The decode cell takes its cache placed before the counted step (no op
touches the cache's batch-shard shape; its bytes within a closed form),
and on the multi-pod mesh (512 ranks) the decode and train cells count
half the single pod's FLOPs a rank.  Without a card and without
``--device`` the CLI exits 2.
"""
from __future__ import annotations

import csv
import json
import os
import subprocess
import sys

import pytest

from benchmarks import run_torch
from repro_torch.configs.base import SHAPES, get_arch
from repro_torch.launch import dryrun

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
FLOPS_TOL = 0.05


def _dryrun(tmp_path, *args):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                           "--out", str(tmp_path), "--force"],
                          capture_output=True, text=True, env=env, timeout=600)


# ``python -m repro_torch.launch.dryrun`` with the op counter watched: the
# shapes of every tensor a counted op read or made, to the file argv[1]
_WATCHED = """
import json, runpy, sys
from repro_torch.roofline import counter
seen, count = set(), counter.OpCounter.__torch_dispatch__
def watched(self, func, types, args=(), kwargs=None):
    out = count(self, func, types, args, kwargs)
    if out is not NotImplemented and not self._paused:
        seen.update(tuple(t.shape) for t in counter._tensors((args, kwargs, out)))
    return out
counter.OpCounter.__torch_dispatch__ = watched
path, sys.argv = sys.argv[1], ["dryrun"] + sys.argv[2:]
try:
    runpy.run_module("repro_torch.launch.dryrun", run_name="__main__")
finally:
    json.dump(sorted(seen), open(path, "w"))
"""


@pytest.fixture(scope="module")
def decode_cell(tmp_path_factory):
    """(out dir, record, the shapes its counted ops touched) of
    ``qwen3_0_6b decode_32k single`` on the CPU."""
    tmp_path = tmp_path_factory.mktemp("decode")
    shapes = tmp_path_factory.mktemp("shapes") / "shapes.json"
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _WATCHED, str(shapes), "--arch", "qwen3_0_6b",
                          "--shape", "decode_32k", "--mesh", "single", "--device", "cpu",
                          "--out", str(tmp_path), "--force"],
                         capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.load(open(tmp_path / "single" / "qwen3_0_6b__decode_32k.json"))
    return tmp_path, rec, {tuple(s) for s in json.load(open(shapes))}


@pytest.fixture(scope="module")
def multi_decode_cell(tmp_path_factory):
    """The record of ``qwen3_0_6b decode_32k multi`` (2x16x16, 512 ranks)."""
    tmp_path = tmp_path_factory.mktemp("decode_multi")
    out = _dryrun(tmp_path, "--arch", "qwen3_0_6b", "--shape", "decode_32k", "--mesh",
                  "multi", "--device", "cpu")
    assert out.returncode == 0, out.stderr[-3000:]
    return json.load(open(tmp_path / "multi" / "qwen3_0_6b__decode_32k.json"))


@pytest.fixture(scope="module")
def train_cells(tmp_path_factory):
    """The records of ``qwen3_0_6b train_4k`` on both meshes: {mesh: record}."""
    tmp_path = tmp_path_factory.mktemp("train")
    out = _dryrun(tmp_path, "--arch", "qwen3_0_6b", "--shape", "train_4k", "--mesh", "both",
                  "--device", "cpu")
    assert out.returncode == 0, out.stderr[-3000:]
    return {m: json.load(open(tmp_path / m / "qwen3_0_6b__train_4k.json"))
            for m in ("single", "multi")}


def test_dryrun_cli_single_cell(decode_cell):
    tmp_path, rec, _ = decode_cell
    assert rec["status"] == "ok"
    assert rec["chips"] == 256
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    for key in ("memory", "roofline", "model_flops_total", "model_flops_per_device",
                "useful_flops_ratio", "op_analysis", "step_kind", "tokens_per_step"):
        assert key in rec
    ops = rec["op_analysis"]
    assert ops["flops_per_device"] > 0 and ops["n_loops"] == 0
    assert ops["collective_bytes_per_device"] == sum(ops["collectives_by_op"].values())
    assert 0 < rec["memory"]["argument_bytes"] < rec["memory"]["peak_bytes"]
    assert rec["step_kind"] == "serve_step" and rec["tokens_per_step"] == 128

    bench_out = tmp_path / "bench"
    run_torch.bench_roofline([], str(bench_out), validation := {}, None,
                             dryrun_dir=str(tmp_path))
    rows = list(csv.DictReader(open(bench_out / "roofline_summary.csv")))
    assert [(r["arch"], r["shape"], r["mesh"]) for r in rows] == \
        [("qwen3_0_6b", "decode_32k", "single")]
    assert validation["roofline_cells"] == 1


def _closed_form_forward_flops(cfg, b: int, sq: int, sk: int) -> tuple[float, float, float]:
    """Matmul FLOPs of a dense config's forward of ``b`` sequences of ``sq``
    queries over ``sk`` keys, whole: (the blocks' weight products, their
    attention products QK^T and PV, the unembedding)."""
    d, hd, nq, nkv, ff, layers = (cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.d_ff, cfg.n_layers)
    vocab = -(-cfg.vocab // 256) * 256
    tokens = b * sq
    per_layer = d * nq * hd + 2 * d * nkv * hd + nq * hd * d + 3 * d * ff
    attention = 4 * b * nq * sq * sk * hd * layers
    return 2 * tokens * per_layer * layers, attention, 2 * tokens * d * vocab


def _closed_form_train_flops(cfg, shape) -> float:
    """Matmul FLOPs of one train step of a dense config, per device of 256:
    forward, recompute (remat) and a backward of twice the forward, and
    the attention backward's recomputed QK^T (half of its forward)."""
    s = shape.seq_len
    dense, attention, unembed = _closed_form_forward_flops(cfg, shape.global_batch, s, s)
    return (4 * dense + 4.5 * attention + 3 * unembed) / 256


def test_decode_cell_flops_match_a_closed_form(decode_cell):
    _, rec, _ = decode_cell
    cfg, shape = get_arch("qwen3_0_6b"), SHAPES["decode_32k"]
    want = sum(_closed_form_forward_flops(cfg, shape.global_batch, 1, shape.seq_len)) / 256
    got = rec["op_analysis"]["flops_per_device"]
    assert abs(got - want) <= FLOPS_TOL * want, (got, want)


def test_train_cell_flops_match_a_closed_form(train_cells):
    cfg = get_arch("qwen3_0_6b")
    assert cfg.remat and cfg.remat_policy == "full"
    rec = train_cells["single"]
    assert rec["status"] == "ok" and rec["step_kind"] == "train_step"
    want = _closed_form_train_flops(cfg, SHAPES["train_4k"])
    got = rec["op_analysis"]["flops_per_device"]
    assert abs(got - want) <= FLOPS_TOL * want, (got, want)
    assert rec["op_analysis"]["collective_bytes_per_device"] > 0


def test_decode_cell_counts_no_cache_placement(decode_cell):
    """The cache is an argument placed before the counted step, as the
    reference's ``in_shardings`` take it: no counted op touches a tensor of
    its batch shard's shape (a rank's 8 rows at the whole 32,768 positions,
    which ``distribute_tensor`` split into the sequence shards inside the
    step, 70.34 GB a rank).  The bytes stay within a closed form: the
    cache C a rank, read by the attention products and copied once for
    them by ``einsum`` (read and write), 3 C; each weight's rank shard W,
    gathered over the data ranks and read by its product, 2 W; the rest,
    at most a fifth,
    the decode step's activations (norms, RoPE, scores, casts)."""
    _, rec, shapes = decode_cell
    cfg, shape = get_arch("qwen3_0_6b"), SHAPES["decode_32k"]
    rows, tp = shape.global_batch // 16, 16  # the 16x16 mesh: data x model
    assert (rows, shape.seq_len, cfg.n_kv_heads, cfg.head_dim) not in shapes
    assert (rows, shape.seq_len // tp, cfg.n_kv_heads, cfg.head_dim) in shapes
    cache = 2 * cfg.n_layers * rows * (shape.seq_len // tp) * cfg.n_kv_heads * cfg.head_dim * 2
    weights = cfg.param_count() * 2 / tp
    want = 3 * cache + 2 * weights
    got = rec["op_analysis"]["bytes_per_device"]
    assert want <= got <= 1.2 * want, (got, want)
    # the arguments: the placed cache beside the parameters' shards of 256
    assert rec["memory"]["argument_bytes"] >= cache + weights / 16


@pytest.mark.parametrize("cells", ["decode", "train"])
def test_multi_pod_cells_halve_the_single_pod_flops(cells, request):
    """The 2x16x16 mesh (512 ranks) takes the same step with twice the data
    ranks: each rank counts half the single pod's FLOPs."""
    if cells == "decode":
        single = request.getfixturevalue("decode_cell")[1]
        multi = request.getfixturevalue("multi_decode_cell")
    else:
        single, multi = (request.getfixturevalue("train_cells")[m] for m in ("single", "multi"))
    assert multi["status"] == "ok" and multi["mesh"] == "multi" and multi["chips"] == 512
    want = single["op_analysis"]["flops_per_device"] / 2
    got = multi["op_analysis"]["flops_per_device"]
    assert abs(got - want) <= FLOPS_TOL * want, (got, want)
    assert multi["memory"]["peak_bytes"] < single["memory"]["peak_bytes"]


def test_scan_train_cell_finishes(tmp_path):
    """``rwkv6_1_6b train_4k``: 4,096 tokens a sequence through 24 layers of
    the time mix, forward, remat and backward, on 256 fake ranks; with the
    per-token scan it did not finish in 600 s on the card's machine."""
    out = _dryrun(tmp_path, "--arch", "rwkv6_1_6b", "--shape", "train_4k", "--mesh",
                  "single", "--device", "cpu")
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.load(open(tmp_path / "single" / "rwkv6_1_6b__train_4k.json"))
    assert rec["status"] == "ok" and rec["step_kind"] == "train_step"
    assert rec["op_analysis"]["flops_per_device"] > 0
    assert 0 < rec["memory"]["peak_bytes"] < 80e9


def test_dryrun_without_a_card_or_device_exits_2(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    out = _dryrun(tmp_path, "--arch", "qwen3_0_6b", "--shape", "decode_32k")
    assert out.returncode == 2
    assert out.stdout.startswith("error:")


def test_cells_and_optimizer_config():
    cells = list(dryrun.cells("both"))
    assert len(cells) == 10 * len(SHAPES) * 2
    assert dryrun.optimizer_config_for(get_arch("arctic_480b")).moment_dtype == "bfloat16"
    assert dryrun.optimizer_config_for(get_arch("qwen3_0_6b")).moment_dtype == "float32"
    assert dryrun.BIG_MODEL_PARAMS == 100e9
    skipped = dryrun.lower_cell("qwen3_0_6b", "long_500k", False, "cpu")
    assert skipped["status"] == "skipped"
