"""The port's examples, ``examples/{quickstart,dram_study,serve_lm,train_lm}_torch.py``,
run as a user runs them (``python examples/<name>.py``) on the CPU
(``--device cpu``) at a cut size, held to the reference scripts beside
them:

- quickstart (R-MAT scale 10) and dram_study (2,000 vertices): every
  printed line but the last two (a blank and the kernels' launches) equals the reference
  script's at the same cut, run here with its generator cut to the same
  size: graph sizes, reachability, runtimes, MTEPS, iterations,
  bytes/edge, bandwidth shares, updates written;
- serve_lm: the requests and tokens served and the prompts equal the
  reference script's (the generated tokens follow each package's own
  seeded weights);
- train_lm: the parameter count equals the reference config's, the
  restart resumes from the checkpoint before the dropped one and ends at
  the first run's loss;
- without a card and without ``--device`` each exits 2 with ``error:``.

Tolerance: exact (the printed text).  One thread a child, so the numbers
do not depend on how many tests share the machine.
"""
from __future__ import annotations

import contextlib
import importlib.util
import io
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from test_torch_golden import _FORBIDDEN, _imported_roots

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ("quickstart_torch", "dram_study_torch", "serve_lm_torch", "train_lm_torch")


def run_example(name: str, *args: str, cwd: Path = ROOT, timeout: float = 300):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, str(ROOT / "examples" / f"{name}.py"), *args],
                          cwd=str(cwd), env=env, capture_output=True, text=True,
                          timeout=timeout)


def run_on_cpu(name: str, *args: str, **kw) -> list[str]:
    proc = run_example(name, "--device", "cpu", *args, **kw)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return proc.stdout.splitlines()


def reference_lines(name: str, monkeypatch, **cut) -> list[str]:
    """The reference script's printed lines, its module's names in ``cut``
    replaced (the generators, cut to the test's size)."""
    spec = importlib.util.spec_from_file_location(f"ref_{name}", ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    for attr, value in cut.items():
        monkeypatch.setattr(module, attr, value)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        module.main()
    return out.getvalue().splitlines()


def _port_lines(lines: list[str]) -> list[str]:
    """The port's lines but its last two (a blank line, then the device and
    the kernels' launches)."""
    assert lines[-1].startswith("device cpu, kernel launches:"), lines[-1]
    assert "'dram_timing': 0" in lines[-1] and lines[-2] == ""
    return lines[:-2]


def test_quickstart_matches_reference(monkeypatch):
    from repro.graph.generators import rmat

    got = run_on_cpu("quickstart_torch", "--scale", "10")
    want = reference_lines("quickstart", monkeypatch,
                           rmat=lambda scale, **kw: rmat(10, **kw))
    assert _port_lines(got) == want
    assert sum(line.endswith("OK") for line in want) == 4


def test_dram_study_matches_reference(monkeypatch):
    from repro.graph.generators import preferential

    got = run_on_cpu("dram_study_torch", "--n", "2000")
    want = reference_lines("dram_study", monkeypatch,
                           preferential=lambda n, *a, **kw: preferential(2000, *a, **kw))
    assert _port_lines(got) == want
    assert any("updates written" in line for line in want)


def test_serve_lm_matches_reference(monkeypatch):
    got = run_on_cpu("serve_lm_torch")
    want = reference_lines("serve_lm", monkeypatch)
    assert got[0].split(" in ")[0] == want[0].split(" in ")[0] == "served 10 requests, 120 tokens"
    for g, w in zip(got[1:4], want[1:4]):
        assert g.split(" -> ")[0] == w.split(" -> ")[0]
    assert got[-1].startswith("kernel launches:") and "'attention': 0" in got[-1]


def test_train_lm_checkpoints_and_restarts(tmp_path):
    import dataclasses

    from repro.configs.base import get_arch

    lines = run_on_cpu("train_lm_torch", "--steps", "6", cwd=tmp_path)
    cfg = dataclasses.replace(get_arch("qwen3_0_6b").reduced(), d_model=256, d_ff=1024,
                              n_heads=4, n_kv_heads=2, d_head=64, n_layers=6)
    assert lines[0] == f"arch=qwen3_0_6b params={cfg.param_count() / 1e6:.1f}M device=cpu"
    assert "restart: dropped the checkpoint of step 6, resuming from step 3" in lines
    assert "[ft] resumed from checkpoint step 3" in lines
    done = [line for line in lines if line.startswith("done:")]
    assert done[0].startswith("done: 6 steps") and done[1].startswith("done: 3 steps")
    first, again = (d.rsplit("-> ", 1)[1] for d in done)
    assert lines[-1] == f"restart: last loss {again} (first run {first})" and again == first
    assert (tmp_path / "results" / "train_lm_torch_ckpt" / "step_00000006").is_dir()


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_without_a_card_or_device_exits_2(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    proc = run_example(name, cwd=tmp_path, timeout=120)
    assert proc.returncode == 2
    assert proc.stderr.startswith("error:"), proc.stderr[-2000:]


def test_examples_import_nothing_of_jax_or_the_reference():
    for name in EXAMPLES:
        f = ROOT / "examples" / f"{name}.py"
        assert not _imported_roots(f) & set(_FORBIDDEN), f
