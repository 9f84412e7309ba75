"""Dry-run profile of one (arch x shape x mesh) cell (port of
``repro/roofline/profile.py``): runs the cell as ``launch/dryrun.py`` does
and prints the op counter's totals and its top ops by traffic, collective
bytes or FLOPs, per device; by FLOPs also by local operand shapes, which
show how DTensor placed each product.

  PYTHONPATH=src python -m repro_torch.roofline.profile --arch qwen3_0_6b \\
      --shape decode_32k [--mesh single] [--by traffic|collective|flops] [--device cpu]
"""
from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--by", default="traffic", choices=["traffic", "collective", "flops"])
    ap.add_argument("--top", type=int, default=18)
    ap.add_argument("--device", default=None,
                    help="device type of the fake tensors (default: the card, cuda)")
    args = ap.parse_args(argv)

    from repro_torch.kernels._platform import resolve_device
    from repro_torch.launch.dryrun import lower_cell

    try:
        device = resolve_device(args.device).type
    except RuntimeError as e:
        print(f"error: {e}")
        return 2
    rec = lower_cell(args.arch, args.shape, args.mesh == "multi", device, top=args.top)
    if rec["status"] != "ok":
        print(f"{rec['status']}: {rec.get('reason', '')}")
        return 0
    a = rec["op_analysis"]
    print(f"flops/dev {a['flops_per_device']:.3e}  traffic/dev "
          f"{a['bytes_per_device'] / 2**30:.2f} GiB  coll/dev "
          f"{a['collective_bytes_per_device'] / 2**30:.2f} GiB  peak "
          f"{rec['memory']['peak_bytes'] / 2**30:.2f} GiB")
    print("collectives by op: "
          f"{ {k: round(v / 2**30, 3) for k, v in a['collectives_by_op'].items()} } GiB")
    unit, div = ("GFLOP", 1e9) if args.by == "flops" else ("GiB", 2**30)
    print(f"\ntop {args.top} by {args.by}:")
    for r in a["top_ops"][args.by]:
        print(f"  {r['value'] / div:12.3f} {unit}  x{r['count']:>6d}  {r['op']}")
    if args.by == "flops":  # how DTensor placed each product: its local shapes
        print(f"\ntop {args.top} by flops and local operand shapes:")
        for r in a["top_shapes"]:
            print(f"  {r['value'] / div:12.3f} {unit}  x{r['count']:>6d}  {r['op']} "
                  f"{' @ '.join(str(tuple(s)) for s in r['shapes'])}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
