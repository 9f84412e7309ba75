"""The control (the plain reference in float8, in the program's place)
goes through the same comparison as the program, with the cell's own
limits.  For the training cells it reads well above the program in
bfloat16 at a tiny size on the CPU (at least three times on some number)
and comes out not correct.  A tiny served wave has too few tokens for
float8 to flip one reliably, so the serving cells' control is shown to
fail at their own size on the card (PERF.md gives the readings)."""
import pytest

from perfbench import harness as hx
from perfbench.run import run_cell

from pb_tiny import tiny_cell

CELLS = ["qwen3_0_6b.train_4k", "qwen2_moe_a2_7b.train_1k", "qwen3_0_6b.prefill_8k",
         "qwen2_moe_a2_7b.prefill_4k"]


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_above_the_program(name):
    cell = tiny_cell(name, "bfloat16")
    r = run_cell(name, 4_000_000_017, 0.2, False, device="cpu", cell=cell, control=True,
                 t_start=0.0)
    program = {k: c["value"] for k, c in r["checks"].items()}
    control = r["control_numbers"]
    assert set(control) >= set(program)
    assert (r["control_correct"], r["control_checks"]) == hx.judge(
        control, cell.workload["limits"])
    if "train" in name:
        assert any(control[k] >= 3 * program[k] for k in program), (program, control)
        assert r["control_correct"] is False, r["control_checks"]
