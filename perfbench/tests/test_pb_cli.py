"""``perfbench/run.py`` as a benchmark runner starts it: without a CUDA card, or in
a directory holding only the benchmark's files, it exits with another
code than 0 and prints no result; on the card (marked ``card``) one short
run of a cell prints a correct result line."""
import json
import shutil
import subprocess
import sys

import pytest

from perfbench import harness as hx

ARGS = ["--workload", "qwen3_0_6b.prefill_8k", "--seed", "3000000001", "--seconds", "1",
        "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, "perfbench/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=600)


def test_no_result_without_the_card_or_the_program(tmp_path):
    import torch

    if torch.cuda.is_available():  # the card's machine: only the bare directory applies
        pass
    else:
        p = _run(hx.ROOT)
        assert p.returncode != 0 and p.stdout.strip() == ""
    shutil.copytree(hx.PERFBENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(hx.ROOT / "BENCHMARK.json", tmp_path)
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.card
def test_one_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = _run(hx.ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
