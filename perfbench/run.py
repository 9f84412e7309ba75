"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``; its workload
file names its driver (``perfbench/drivers/<kind>.py``).  With ``--trace
0`` the result holds the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, each read by ``perfbench/metrics/<metric>.py``.  The
last lines on standard error, and the result's last key, give each number
the check compared beside its limit.  Exits 2 without a CUDA card (or with
fewer than the cell asks for), 3 if JAX or the JAX package got loaded, 1
on any other failure; 0 otherwise, whether or not the output was correct.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from perfbench import harness as hx  # noqa: E402


def run_cell(name: str, seed: int, seconds: float, trace: bool, device=None,
             root: Path = ROOT, fault: str | None = None, cell=None,
             t_start: float | None = None, control: bool = False) -> dict:
    """One run of cell ``name``: the result line's object, with the compared
    numbers and their limits under ``checks``.  ``device`` defaults to the
    card; ``cell`` replaces the manifest's (tests run a tiny one on the CPU);
    ``fault`` plants one of the faults the check has to catch; ``control``
    also reads the control's numbers (``perfbench/calibrate.py``)."""
    import torch

    cell = cell if cell is not None else hx.find_cell(name, root)
    device = torch.device(device if device is not None else "cuda")
    drv = hx.driver(cell.workload["kind"], root)
    out = drv.run(cell, seed, seconds, trace, device,
                  T_START if t_start is None else t_start, fault=fault, control=control)
    if trace:
        rec = out["record"]
        peak = hx.peak_of(torch.cuda.get_device_name(device) if device.type == "cuda" else None)
        metrics = {}
        for m in cell.per_layer:
            value = hx.reader(m["name"], root).read(rec, peak)
            if hx.finite(value):
                metrics[m["name"]] = hx.metric_value(value, m["unit"])
    else:
        metrics = {m["name"]: hx.metric_value(out[m["name"]], m["unit"])
                   for m in cell.end_to_end}
    correct, checks = hx.judge(out["numbers"], cell.workload["limits"])
    correct = correct and out["failed"] == 0
    dev = hx.device_block(device, cell.entry["chips"], out["memory_peak"])
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    if trace:
        bw = hx.busy_and_window(rec["trace"])
        if bw is not None:
            dev["busy_s"], dev["window_s"] = bw
        result["breakdown"] = hx.breakdown(rec["trace"])
    t0 = T_START if t_start is None else t_start
    result["readings"] = dict(out.get("readings", {}), **{
        k: v for k, v in out["numbers"].items() if k not in cell.workload["limits"]})
    result["readings"]["setup_marks_s"] = {k: v - t0 for k, v in hx.MARKS.items() if v >= t0}
    if control:  # the control goes through the same comparison as the program
        result["control_numbers"] = out["control_numbers"]
        result["control_correct"], result["control_checks"] = hx.judge(
            out["control_numbers"], cell.workload["limits"])
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    hx.set_cache_dirs(ROOT)
    cell = hx.find_cell(args.workload, ROOT)
    import torch

    hx.mark("torch_imported")
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.zeros(1, device="cuda")
    hx.mark("cuda_context")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), cell=cell)
    bad = hx.forbidden_modules()
    if bad:
        print(f"error: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    card = hx.card_line()
    if card:
        print(f"card: {card}", file=sys.stderr)
    for key, c in result["checks"].items():
        print(f"{key}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
