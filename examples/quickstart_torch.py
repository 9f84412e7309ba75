"""Quickstart through the PyTorch port: compare the four graph-processing
accelerators on one graph.

    PYTHONPATH=src python examples/quickstart_torch.py                 # the CUDA card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu --scale 9

The twin of ``examples/quickstart.py``.  Builds a scaled R-MAT graph, runs
BFS through all four accelerator models (AccuGraph, ForeGraph, HitGraph,
ThunderGP) on their paper DRAM configs on ``--device`` (DRAM timing in
``csrc/dram_timing.cu`` on the card), validates every result against the
port's reference solver, and prints the paper's key metrics (runtime,
MTEPS, iterations, bytes/edge), then the kernels' launches.  ``--scale``
cuts the graph (default 13, the reference script's).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None,
                    help="device of the simulation (default: the CUDA card)")
    ap.add_argument("--scale", type=int, default=13, help="R-MAT scale (2^scale vertices)")
    args = ap.parse_args(argv)

    from repro_torch.configs.graphsim import default_config
    from repro_torch.core.accelerators.base import run_accelerator
    from repro_torch.graph.generators import rmat
    from repro_torch.graph.problems import BFS, reference_solve
    from repro_torch.kernels._platform import LAUNCHES, resolve_device

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    g = rmat(args.scale, edge_factor=12, seed=1, name=f"rmat{args.scale}")
    root = 42
    print(f"graph: n={g.n} m={g.m} avg_deg={g.avg_degree:.1f} "
          f"skew={g.degree_skewness:.1f}\n")

    ref_values, ref_iters = reference_solve(g, BFS, root=root, device=dev)
    reached = int(np.isfinite(ref_values).sum())
    print(f"reference BFS: {reached}/{g.n} reachable, {ref_iters} sync iterations\n")

    print(f"{'accelerator':12s} {'runtime':>10s} {'MTEPS':>8s} {'iters':>6s} "
          f"{'bytes/edge':>10s} {'bw_util':>8s}")
    for accel in ("accugraph", "foregraph", "hitgraph", "thundergp"):
        rep = run_accelerator(accel, g, BFS, root=root, config=default_config(accel),
                              device=dev)
        ok = np.array_equal(rep.values, ref_values)
        print(f"{accel:12s} {rep.runtime_s*1e3:8.2f}ms {rep.mteps:8.1f} "
              f"{rep.iterations:6d} {rep.bytes_per_edge:10.2f} "
              f"{rep.timing.bw_utilization:8.2%}  "
              f"{'OK' if ok else 'MISMATCH'}")
    print(f"\ndevice {dev}, kernel launches: {dict(LAUNCHES)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
