"""Batched serving through the PyTorch port: a small model answering a
queue of requests through the prefill/decode engine (static-shape waves).

    PYTHONPATH=src python examples/serve_lm_torch.py                   # the CUDA card
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu

The twin of ``examples/serve_lm.py``: the reduced ``qwen3_0_6b`` with
seeded weights on ``--device``, served by ``repro_torch``'s
``ServeEngine``; prefill attends through ``csrc/attention.cu`` on the
card.  It ends with the kernels' launches.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None,
                    help="device of the model (default: the CUDA card)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.kernels._platform import LAUNCHES, resolve_device
    from repro_torch.models.model import Model
    from repro_torch.serve.legacy.engine import Request, ServeEngine

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    cfg = get_arch("qwen3_0_6b").reduced()
    model = Model(cfg, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(0))
    engine = ServeEngine(model, batch=4, max_seq=64)

    rng = np.random.default_rng(0)
    requests = [
        Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=16).astype(np.int32),
                max_new=12)
        for i in range(10)
    ]
    t0 = time.perf_counter()
    done = engine.run(requests)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    total_new = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests, {total_new} tokens in {dt:.2f}s "
          f"({total_new/dt:.1f} tok/s on {dev})")
    for r in done[:3]:
        print(f"  req {r.rid}: prompt[:4]={r.prompt[:4].tolist()} "
              f"-> out[:6]={r.out[:6].tolist()}")
    print(f"kernel launches: {dict(LAUNCHES)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
