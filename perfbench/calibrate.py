"""Readings the check's limits are set from, on the card, in one process:

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--faults half_batch,token_altered --fault-seeds 7,8,9] \\
        [--seconds 3]

Each seed runs the cell as ``run.py`` does (weights, inputs, a short
window, the check) and prints one JSON line with the numbers compared: the
program's for ``--seeds``; with ``--control-seeds`` also the control's (the
plain reference in float8, in the program's place, against the float32
reference) and whether the cell's limits judge it correct; with
``--faults`` the program with each of those faults planted, on each of
``--fault-seeds``.  The
benchmark's own runs never run the control or a fault.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from perfbench import harness as hx  # noqa: E402
from perfbench.run import run_cell  # noqa: E402


def _ints(text: str) -> list:
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--faults", type=lambda t: [f for f in t.split(",") if f], default=[])
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    hx.set_cache_dirs(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs = ([(s, None, False) for s in args.seeds] + [(s, None, True) for s in args.control_seeds]
            + [(s, f, False) for f in args.faults for s in args.fault_seeds])
    for seed, fault, control in runs:
        t = time.perf_counter()
        r = run_cell(args.workload, seed, args.seconds, False, fault=fault, control=control,
                     t_start=t)
        line = {"workload": args.workload, "seed": seed, "fault": fault,
                "numbers": {k: c["value"] for k, c in r["checks"].items()},
                "all_numbers": {k: v for k, v in r["readings"].items()
                                if "gap" in k or k == "worst_leaves"},
                "control": r.get("control_numbers"), "control_correct": r.get("control_correct"),
                "correct": r["correct"], "metrics": r["metrics"],
                "readings": r["readings"], "wall_s": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
