"""The paper benches through the port (``benchmarks/run_torch.py --device
cpu``) against the same benches through the reference
(``benchmarks/run.py``): each bench, on the paper graph ``sd`` (``tab7``
and ``tab8`` fall back to ``db`` and ``rd``), with its own cache, must
write equal CSV rows (``wall_s`` aside: it is a clock) and an equal
``validation.json``.  Also: the kernel micro-bench runs on the CPU.

The port's CPU path times DRAM traces with the kernel's plain version, a
Python loop over requests, so ``tab7`` and ``tab8`` take most of the time;
``tab8`` runs from ``test_torch_benches_tab8.py`` so that ``--dist
loadfile`` gives it a worker of its own."""
from __future__ import annotations

import csv
import json
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))  # the benchmarks package

from benchmarks import run as ref_run  # noqa: E402
from benchmarks import run_torch  # noqa: E402

PAPER_BENCHES = ("tab4", "tab5", "tab6", "tab7", "tab8", "fig9", "fig10")


def _rows(path: Path) -> list[dict]:
    with open(path, newline="") as f:
        return [{k: v for k, v in r.items() if k != "wall_s"} for r in csv.DictReader(f)]


def check_bench(bench: str, tmp_path: Path, monkeypatch) -> None:
    """``bench`` through both harnesses, each with its own cache: equal
    CSV rows and ``validation.json``."""
    ref_out, port_out = tmp_path / "ref", tmp_path / "port"
    monkeypatch.setattr(sys, "argv", [
        "run.py", "--benches", bench, "--graphs", "sd", "--out", str(ref_out),
        "--cache", str(tmp_path / "ref_cache")])
    ref_run.main()
    run_torch.main(["--benches", bench, "--graphs", "sd", "--out", str(port_out),
                    "--cache", str(tmp_path / "port_cache"), "--device", "cpu"])
    ref_csvs = sorted(p.name for p in ref_out.glob("*.csv"))
    assert ref_csvs and sorted(p.name for p in port_out.glob("*.csv")) == ref_csvs
    for name in ref_csvs:
        want = _rows(ref_out / name)
        assert want and _rows(port_out / name) == want, name
    assert json.loads((port_out / "validation.json").read_text()) == \
        json.loads((ref_out / "validation.json").read_text())


# tab8, the slowest on the CPU, has a file of its own (test_torch_benches_tab8.py)
@pytest.mark.parametrize("bench", [b for b in PAPER_BENCHES if b != "tab8"])
def test_bench_writes_the_reference_s_rows_and_validation(bench, tmp_path, monkeypatch):
    check_bench(bench, tmp_path, monkeypatch)


def test_bench_set_is_the_reference_s_but_roofline(capsys):
    # the roofline bench came with the port's dry run: the sets are equal now
    assert set(run_torch.BENCHES) == set(ref_run.BENCHES)
    with pytest.raises(SystemExit):
        run_torch.main(["--help"])
    assert "roofline" in capsys.readouterr().out


def test_kernel_microbench_runs_on_the_cpu(tmp_path):
    run_torch.main(["--benches", "kernels", "--out", str(tmp_path), "--device", "cpu"])
    rows = list(csv.DictReader(open(tmp_path / "kernels_microbench.csv")))
    assert [r["name"] for r in rows] == [
        f"{k}_{side}" for k in ("spmv", "edge_update", "dram_timing", "flash_attention")
        for side in ("cpu", "plain")]
    assert all(float(r["us_per_call"]) > 0 for r in rows)
