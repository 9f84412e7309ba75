"""Memory-technology study (paper Sect. 4.4) through the PyTorch port: one
graph, three DRAM types, plus the optimization ablation (Sect. 4.5).

    PYTHONPATH=src python examples/dram_study_torch.py                 # the CUDA card
    PYTHONPATH=src python examples/dram_study_torch.py --device cpu --n 2000

The twin of ``examples/dram_study.py``, on ``--device`` (DRAM timing in
``csrc/dram_timing.cu`` on the card); it ends with the kernels' launches.
``--n`` cuts the preferential-attachment graph (default 20,000 vertices,
the reference script's ``social20k``).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None,
                    help="device of the simulation (default: the CUDA card)")
    ap.add_argument("--n", type=int, default=20000, help="vertices of the graph")
    args = ap.parse_args(argv)

    from repro_torch.configs.graphsim import NONE, default_config
    from repro_torch.core.accelerators.base import AccelConfig, run_accelerator
    from repro_torch.core.dram import dram_config
    from repro_torch.graph.generators import preferential
    from repro_torch.graph.problems import BFS
    from repro_torch.kernels._platform import LAUNCHES, resolve_device

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    g = preferential(args.n, 12, seed=5, name=f"social{args.n // 1000}k")
    root = 9
    print(f"graph: n={g.n} m={g.m}\n")

    print("--- DRAM types (BFS, all optimizations) ---")
    print(f"{'accelerator':12s} {'DDR4':>10s} {'DDR3':>10s} {'HBM':>10s}  (runtime; insight 6)")
    for accel in ("accugraph", "foregraph", "hitgraph", "thundergp"):
        times = []
        for dram in ("default", "ddr3", "hbm"):
            rep = run_accelerator(accel, g, BFS, root=root, dram=dram_config(dram),
                                  config=default_config(accel), device=dev)
            times.append(rep.runtime_s)
        print(f"{accel:12s} {times[0]*1e3:8.2f}ms {times[1]*1e3:8.2f}ms "
              f"{times[2]*1e3:8.2f}ms")

    print("\n--- HitGraph optimization ablation (BFS, DDR4) ---")
    for name, opts in [("none", NONE),
                       ("edge_sorting", frozenset({"edge_sorting"})),
                       ("+update_combining", frozenset({"edge_sorting", "update_combining"})),
                       ("all", frozenset({"all"}))]:
        cfg = AccelConfig(interval_size=16384, optimizations=opts)
        rep = run_accelerator("hitgraph", g, BFS, root=root, dram="default", config=cfg,
                              device=dev)
        print(f"{name:20s} {rep.runtime_s*1e3:8.2f}ms  "
              f"(updates written: {sum(s.updates_written for s in rep.per_iteration)})")
    print(f"\ndevice {dev}, kernel launches: {dict(LAUNCHES)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
