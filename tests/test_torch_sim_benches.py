"""The port's twins of the simulator benches, ``benchmarks/bench_semexec_torch.py``,
``bench_engine_torch.py`` and ``bench_host_torch.py``, in their ``--tiny``
smoke on the CPU (``--device cpu``), run as a user runs them (``python -m``).
Each bench asserts its own invariants (trace hashes, values, reports
between its two variants) and exits non-zero when one fails; the tests
read the result file back and hold it against the reference:

- semexec: both engines' 8 tiny trace hashes equal
  ``benchmarks/golden_hashes_tiny.json``, every round's check passed, no
  kernel launch on the CPU;
- engine: the batched ``TimingReport`` s equal the reference's
  ``repro.core.engine.simulate_many`` on the same tiny chunk;
- host: the 8 ``SimReport`` s equal the reference bench's ``_run_chunk``
  on the same chunk, and the trace hashes the goldens;
- without a card and without ``--device`` each exits 2 with ``error:``.

Tolerance: exact (hashes, integer counts and the same host arithmetic).
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

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = json.loads((ROOT / "benchmarks" / "golden_hashes_tiny.json").read_text())
TWINS = ("bench_semexec_torch", "bench_engine_torch", "bench_host_torch")


def run_twin(module: str, *args: str, timeout: float = 300) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", f"benchmarks.{module}", "--tiny", *args],
                          cwd=str(ROOT), env=env, capture_output=True, text=True,
                          timeout=timeout)


def run_tiny(module: str, out: Path, *args: str) -> dict:
    proc = run_twin(module, "--device", "cpu", "--out", str(out), *args)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return json.loads(out.read_text())


def test_bench_semexec_torch_tiny(tmp_path):
    res = run_tiny("bench_semexec_torch", tmp_path / "semexec.json", "--rounds", "3")
    assert res["workload"]["scenarios"] == 8 and res["golden_match"] == "8/8"
    assert res["golden_trace_hashes"] == {k: GOLDEN[k] for k in res["golden_trace_hashes"]}
    assert res["rounds"] == 3 and len(res["numpy"]["passes_s"]) == 3
    assert len(res["device_engine"]["passes_s"]) == 3
    for spread in (res["numpy"], res["device_engine"]):
        assert spread["min_s"] <= spread["median_s"] <= spread["max_s"]
    assert res["device_over_numpy"] > 0 and isinstance(res["ranges_overlap"], bool)
    assert res["traces_identical"] and res["values_identical"]
    assert res["device"] == "cpu" and res["card"] is None
    assert not any(res["launches_per_pass"].values())  # the CPU runs the plain versions


def _reference_tiny_items():
    from benchmarks import bench_engine as ref_bench
    from repro.graph.generators import GraphSpec
    from repro.sweep.spec import SweepSpec

    spec = SweepSpec(name="bench-tiny", accelerators=("accugraph", "foregraph"),
                     graphs=(GraphSpec("tiny", "uniform", 256, 1024, True, 1, 0),),
                     problems=("bfs",))
    return ref_bench._prepare_chunk(spec)[0]


def test_bench_engine_torch_tiny_matches_reference(tmp_path):
    from repro.core.engine import simulate_many

    res = run_tiny("bench_engine_torch", tmp_path / "engine.json")
    items = _reference_tiny_items()
    assert res["workload"]["traces"] == len(items) == len(res["reports"])
    assert res["reports"] == [r.to_dict() for r in simulate_many(items)]
    seq, bat = res["sequential"], res["batched"]
    assert seq["device_dispatches"] > bat["device_dispatches"] >= 1
    assert seq["traces"] == bat["traces"] == len(items)
    assert seq["dram_timing_launches"] == bat["dram_timing_launches"] == 0
    assert res["reports_identical"] and res["device"] == "cpu"


def test_bench_host_torch_tiny_matches_reference(tmp_path):
    from benchmarks import bench_host as ref_bench

    res = run_tiny("bench_host_torch", tmp_path / "host.json")
    args = ref_bench.argparse.Namespace(tiny=True)
    scenarios = ref_bench._build_spec(args).scenarios()
    ref_bench.hostcache.clear_all()
    reports, walls, hashes = ref_bench._run_chunk(scenarios)
    assert res["reports"] == [r.to_dict() for r in reports]
    assert res["golden_match"] == "8/8"
    assert res["golden_trace_hashes"] == {s.scenario_id: h[:16]
                                          for s, h in zip(scenarios, hashes)}
    for variant in ("sequential_host", "overhauled"):
        w = res[variant]
        assert w["traces"] == walls["traces"] and w["requests"] == walls["requests"]
        assert w["total_s"] >= w["host_prepare_s"] + w["device_timing_s"] - 1e-9
    assert res["traces_identical"] and res["reports_identical"]


@pytest.mark.parametrize("module", TWINS)
def test_twin_without_a_card_or_device_exits_2(module):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    proc = run_twin(module, timeout=120)
    assert proc.returncode == 2
    assert proc.stderr.startswith("error:"), proc.stderr[-2000:]


def test_twins_import_nothing_of_jax_or_the_reference():
    for f in [ROOT / "benchmarks" / f"{m}.py" for m in TWINS] + \
            [ROOT / "benchmarks" / "torch_common.py"]:
        assert not _imported_roots(f) & set(_FORBIDDEN), f
