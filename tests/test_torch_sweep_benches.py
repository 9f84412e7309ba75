"""The port's twins of the sweep benches, ``benchmarks/bench_memory_torch.py``,
``bench_partition_torch.py``, ``bench_search_torch.py`` and
``bench_serve_torch.py``, in their ``--tiny`` smoke on the CPU
(``--device cpu``), run as a user runs them (``python -m``).  Each bench
asserts its own invariants and exits non-zero when one fails; the tests
read the result file back and hold it against the reference bench beside
it, run here on the same tiny grid:

- memory: the rows, the sensitivity ratios and the scan-vs-fast errors
  equal the reference's;
- partition: the rows and the deltas equal the reference's, and the 8
  identity-layout trace hashes equal ``benchmarks/golden_hashes_tiny.json``;
- search: the tiny result's keys and values but the wall equal the
  reference's (golden probe hashes, rows equal to ``run_sweep``'s, a warm
  re-search executing nothing), and the full bench's seeds, regret curves
  and executions to the optimum equal the committed ``BENCH_search.json``;
- serve: the golden hashes served, a resubmission all cached, a clean
  drain, and the scheduler's counters equal the reference server's (but
  the workers' host-cache hits, which depend on which worker took a chunk);
- without a card and without ``--device`` each exits 2 with ``error:``.

No kernel launches on the CPU.  Tolerance: exact.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from test_torch_golden import _FORBIDDEN, _imported_roots
from test_torch_sim_benches import GOLDEN, run_twin

ROOT = Path(__file__).resolve().parent.parent
TWINS = ("bench_memory_torch", "bench_partition_torch", "bench_search_torch",
         "bench_serve_torch")
NO_LAUNCH = {"dram_timing": 0, "edge_update": 0, "spmv": 0, "attention": 0,
             "attention_bwd": 0, "ssm_scan": 0}


def run_tiny(module: str, out: Path, *args: str) -> dict:
    proc = run_twin(module, "--device", "cpu", "--out", str(out), *args)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return json.loads(out.read_text())


def reference_tiny(module: str, out: Path) -> dict:
    import importlib

    assert importlib.import_module(f"benchmarks.{module}").main(
        ["--tiny", "--out", str(out)]) == 0
    return json.loads(out.read_text())


def _without_wall(workload: dict) -> dict:
    return {k: v for k, v in workload.items() if k != "wall_s"}


def test_bench_memory_torch_tiny_matches_reference(tmp_path):
    res = run_tiny("bench_memory_torch", tmp_path / "memory.json")
    ref = reference_tiny("bench_memory", tmp_path / "ref.json")
    assert res["rows"] == ref["rows"] and len(res["rows"]) == 16
    assert res["sensitivity"] == ref["sensitivity"]
    assert res["scan_vs_fast"] == ref["scan_vs_fast"]
    assert _without_wall(res["workload"]) == _without_wall(ref["workload"])
    assert res["device"] == "cpu" and res["card"] is None and res["launches"] == NO_LAUNCH


def test_bench_partition_torch_tiny_matches_reference(tmp_path):
    res = run_tiny("bench_partition_torch", tmp_path / "partition.json")
    ref = reference_tiny("bench_partition", tmp_path / "ref.json")
    assert res["rows"] == ref["rows"] and len(res["rows"]) == 64
    assert res["deltas"] == ref["deltas"]
    assert res["golden_identity_hashes_checked"] == ref["golden_identity_hashes_checked"] == 8
    assert _without_wall(res["workload"]) == _without_wall(ref["workload"])
    assert res["device"] == "cpu" and res["launches"] == NO_LAUNCH


def test_bench_search_torch_tiny_matches_reference(tmp_path):
    res = run_tiny("bench_search_torch", tmp_path / "search.json")
    ref = reference_tiny("bench_search", tmp_path / "ref.json")
    assert {k: v for k, v in res.items() if k in ref and k != "wall_s"} == \
        {k: v for k, v in ref.items() if k != "wall_s"}
    assert res["golden_hashes_checked"] == 8 and res["golden_ok"]
    assert res["rows_byte_identical"] and res["warm_research_zero_executions"]
    assert res["device"] == "cpu" and res["dram_timing_launches"] == 0


def test_bench_search_torch_full_matches_committed_result(tmp_path):
    """The full bench (64-point grid, 3 seeds at a quarter budget) on the
    CPU against the reference's committed ``BENCH_search.json``."""
    out = tmp_path / "search_full.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "benchmarks.bench_search_torch", "--device",
                           "cpu", "--out", str(out)], cwd=str(ROOT), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    res = json.loads(out.read_text())
    ref = json.loads((ROOT / "BENCH_search.json").read_text())
    for key in ("space", "tolerance", "budget", "seeds", "per_seed", "regret_curves",
                "mean_executions_to_optimum", "cost_fraction"):
        assert res[key] == ref[key], key
    assert res["full_grid"]["optimum"] == ref["full_grid"]["optimum"]
    assert res["full_grid"]["executions"] == ref["full_grid"]["executions"] == 64
    assert res["mode"] == "full" and res["device"] == "cpu"


def test_bench_serve_torch_tiny_matches_reference(tmp_path):
    res = run_tiny("bench_serve_torch", tmp_path / "serve.json")
    ref = reference_tiny("bench_serve", tmp_path / "ref.json")
    for key in ("mode", "scenarios", "golden_hashes_checked", "golden_ok",
                "resubmit_all_cached", "clean_shutdown"):
        assert res[key] == ref[key], key
    assert res["golden_hashes_checked"] == len(GOLDEN) == 8

    def scheduled(counters):
        return {k: v for k, v in counters.items() if not k.startswith("worker_")}

    assert scheduled(res["counters"]) == scheduled(ref["counters"])
    assert res["device"] == "cpu" and res["launches"] == NO_LAUNCH
    assert res["counters"]["worker_launches_dram_timing"] == 0


@pytest.mark.parametrize("module", TWINS)
def test_twin_without_a_card_or_device_exits_2(module):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    proc = run_twin(module, timeout=120)
    assert proc.returncode == 2
    assert proc.stderr.startswith("error:"), proc.stderr[-2000:]


def test_twins_import_nothing_of_jax_or_the_reference():
    for m in TWINS:
        f = ROOT / "benchmarks" / f"{m}.py"
        assert not _imported_roots(f) & set(_FORBIDDEN), f
