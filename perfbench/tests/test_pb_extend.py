"""A later change adds a configuration, a cell and a per-layer metric as new
files and new manifest entries only; the harness finds them with no file
it already had edited."""
import hashlib
import json
import shutil

import pytest

from perfbench import harness as hx

from pb_tiny import TINY_DENSE


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "perfbench").rglob("*") if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture
def copy(tmp_path):
    shutil.copytree(hx.PERFBENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(hx.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def test_new_config_cell_and_metric_by_new_files(copy):
    before = _digests(copy)
    base = hx.load_json(copy / "perfbench/configs/qwen3_0_6b.json")
    arch = dict(base["arch"], **TINY_DENSE, dtype="float32", arch="throwaway")
    (copy / "perfbench/configs/throwaway.json").write_text(json.dumps(
        dict(base, name="throwaway", arch=arch, reduced=["num_hidden_layers"])))
    (copy / "perfbench/workloads/throwaway.train_tiny.json").write_text(json.dumps({
        "name": "throwaway.train_tiny", "config": "throwaway", "kind": "train",
        "traffic": {"batch": 2, "seq": 32, "checked_steps": 3,
                    "optimizer": hx.find_cell("qwen3_0_6b.train_4k").traffic["optimizer"]},
        "limits": {"loss_gap": 1e-3, "grad_gap": 1e-3, "change_gap": 1e-3}, "why": "a test"}))
    (copy / "perfbench/metrics/train.tokens_a_step.py").write_text(
        "def read(rec, peak):\n    return rec.get('tokens_a_step')\n")
    man = json.loads((copy / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "throwaway", "source": base["source"],
                           "file": "perfbench/configs/throwaway.json",
                           "reduced": ["num_hidden_layers"], "why": "a test"})
    man["workloads"].append({"name": "throwaway.train_tiny", "config": "throwaway",
                             "traffic": "train_tiny", "chips": 1, "why": "a test"})
    man["end_to_end"][0]["workloads"].append("throwaway.train_tiny")
    man["per_layer"].append({"name": "train.tokens_a_step", "unit": "tokens", "better": "higher",
                             "source": "program_counter", "layer": "train step",
                             "moves": "train_tokens_per_s",
                             "workloads": ["throwaway.train_tiny"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(man))

    cell = hx.find_cell("throwaway.train_tiny", copy)
    assert cell.arch["arch"] == "throwaway"
    assert {m["name"] for m in cell.end_to_end} == {"train_tokens_per_s", "peak_gb", "setup_s"}
    assert "train.tokens_a_step" in [m["name"] for m in cell.per_layer]
    assert hx.reader("train.tokens_a_step", copy).read({"tokens_a_step": 64}, None) == 64
    assert hasattr(hx.driver(cell.workload["kind"], copy), "run")

    from perfbench.run import run_cell

    r = run_cell(cell.name, 7, 0.1, False, device="cpu", root=copy, cell=cell, t_start=0.0)
    assert r["correct"] and set(r["metrics"]) == {"train_tokens_per_s", "peak_gb", "setup_s"}
    after = _digests(copy)
    assert {k: v for k, v in after.items() if k in before} == before
