"""Where the rwkv6 launcher run's falling loss comes from: the launcher's
training run (``python -m repro_torch.launch.train --arch rwkv6_1_6b
--reduced --device cpu --batch 4 --seq 64 --lr 2e-2``) with the time mix's
chunked scan (``ssm._rwkv_scan``) or a per-token loop of ``ssm._rwkv_step``,
in f32 or in f64, at a thread count; prints the loss of every step as one
JSON line.  Two scans whose curves agree in f64 and part in f32 differ by
rounding, which Adam amplifies; curves that part in f64 show a fault.

    PYTHONPATH=src python benchmarks/rwkv_drift_torch.py --precision f64 --scan token
    PYTHONPATH=src python benchmarks/rwkv_drift_torch.py --threads 8 --steps 40

f64 is a diagnostic: this process aliases ``torch.float32`` and
``Tensor.float`` to f64 before the port is imported, so every f32 tensor
of the model, its state and the optimizer is f64 (the weights are drawn in
f64 too, so the f32 and f64 runs start from different draws).  The CPU
only; checkpoints go to a temporary directory.
"""
from __future__ import annotations

import argparse
import json
import tempfile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--precision", choices=("f32", "f64"), default="f32")
    ap.add_argument("--scan", choices=("chunked", "token"), default="chunked")
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(args.threads)
    if args.precision == "f64":
        torch.float32 = torch.float64
        torch.Tensor.float = lambda self: self.double()
    from repro_torch.launch import train
    from repro_torch.models import ssm

    if args.scan == "token":
        def per_token(rh, kh, vh, wh, u, state):
            ys = []
            for t in range(rh.shape[1]):
                y, state = ssm._rwkv_step(rh[:, t], kh[:, t], vh[:, t], wh[:, t], u, state)
                ys.append(y)
            return torch.stack(ys, 1), state

        ssm._rwkv_scan = per_token
    history = []
    supervised = train.run_supervised

    def recorded(**kwargs):
        out = supervised(**kwargs)
        history.extend(loss for _, loss in out[2])
        return out

    train.run_supervised = recorded
    with tempfile.TemporaryDirectory() as tmp:
        rc = train.main(["--arch", "rwkv6_1_6b", "--reduced", "--device", "cpu",
                         "--steps", str(args.steps), "--batch", "4", "--seq", "64",
                         "--lr", "2e-2", "--ckpt-dir", tmp])
    print(json.dumps(dict(vars(args), losses=history)))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
