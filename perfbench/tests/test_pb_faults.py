"""The check has to catch a broken timed path: a run of each cell, tiny
and on the CPU but otherwise whole (the look for a card skipped), with a
fault planted underneath the window comes out not correct; the same run
without the fault comes out correct.  The limits are the cells' own."""
import pytest

from perfbench.run import run_cell

from pb_tiny import tiny_cell

FAULTS = {"train": ("stale_state", "half_batch"),
          "serve": ("stale_state", "half_batch", "token_altered")}
CELLS = ["qwen3_0_6b.train_4k", "qwen2_moe_a2_7b.train_1k", "qwen3_0_6b.prefill_8k",
         "qwen2_moe_a2_7b.prefill_4k"]
CASES = [(c, f) for c in CELLS
         for f in (None,) + FAULTS["train" if "train" in c else "serve"]]


@pytest.mark.parametrize("name,fault", CASES, ids=[f"{c}-{f}" for c, f in CASES])
def test_fault_is_caught(name, fault):
    cell = tiny_cell(name)
    r = run_cell(name, 2_147_483_647 + 12_345, 0.2, False, device="cpu", cell=cell,
                 fault=fault, t_start=0.0)
    assert r["correct"] is (fault is None), r["checks"]
