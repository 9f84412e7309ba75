"""The port's twins of the serve benches, ``benchmarks/bench_multihost_torch.py``
and ``benchmarks/bench_faults_torch.py``, in their ``--tiny`` smoke on the
CPU (``--device cpu``), run as a user runs them (``python -m``).  Each
bench asserts its own invariants and exits non-zero when one fails; the
tests also read them back from the result file:

- multi-host: the 8 tiny golden trace hashes served by two worker hosts,
  both hosts served chunks, a resubmission all cached, every process
  exits 0;
- faults: the baseline's golden trace hashes, the poison row quarantined
  and every other row identical to the baseline under the chaos plan, the
  rows after a SIGKILL and a journal restart equal to the baseline.

Tolerance: exact (the benches compare canonical JSON rows and hashes).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def run_bench(module: str, out: Path, timeout: float) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", f"benchmarks.{module}", "--tiny", "--device", "cpu",
         "--out", str(out)],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return json.loads(out.read_text())


def test_bench_multihost_torch_tiny(tmp_path):
    res = run_bench("bench_multihost_torch", tmp_path / "multihost.json", timeout=300)
    assert res["mode"] == "tiny" and res["scenarios"] == 8 and res["hosts"] == 2
    assert res["golden_hashes_checked"] == 8 and res["golden_ok"]
    assert res["both_hosts_served"] and res["resubmit_all_cached"]
    assert res["clean_shutdown"]
    assert res["device"] == "cpu" and set(res["host_devices"].values()) == {"cpu"}
    assert not any(res["launches"].values())  # the CPU runs the plain versions


def test_bench_faults_torch_tiny(tmp_path):
    res = run_bench("bench_faults_torch", tmp_path / "faults.json", timeout=600)
    assert res["mode"] == "tiny" and res["scenarios"] == 8
    assert res["baseline"]["golden_checked"] == 8
    assert res["baseline"]["device"] == "cpu"
    chaos = res["chaos"]
    assert chaos["rows_identical"] == 7 and chaos["poison_scenario"]
    assert chaos["faults"]["scenarios_poisoned"] == 1
    assert chaos["faults"]["corrupt_records"] >= 1
    restart = res["restart"]
    assert restart["recovered_cached"] >= restart["rows_before_kill"] >= 2
    assert restart["recovered_cached"] + restart["recovered_executed"] == 8
