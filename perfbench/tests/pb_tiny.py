"""Tiny cells for the CPU tests: a cell of the manifest with its widths,
depth and traffic cut so that a run takes seconds on the CPU."""
import copy

from perfbench import harness as hx

TINY_DENSE = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32, d_ff=256,
                  vocab=512)
TINY_MOE = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_head=32, d_ff=64,
                vocab=512, n_experts=8, top_k=2, n_shared_experts=2, expert_d_ff=64)
TINY_TRAFFIC = {"train": dict(batch=2, seq=64), "serve": dict(batch=4, prompt=64, new=4)}


def tiny_cell(name: str, dtype: str = "float32", root=hx.ROOT) -> hx.Cell:
    cell = hx.find_cell(name, root)
    arch = dict(cell.arch)
    arch.update(TINY_MOE if arch.get("n_experts") else TINY_DENSE, dtype=dtype)
    cell.config = dict(cell.config, arch=arch)
    cell.workload = copy.deepcopy(cell.workload)
    cell.workload["traffic"].update(TINY_TRAFFIC[cell.workload["kind"]])
    return cell
