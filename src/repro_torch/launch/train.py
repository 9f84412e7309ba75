"""End-to-end training launcher (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_0_6b --reduced \
        --steps 200 --batch 8 --seq 256 --device cpu

Builds the model with seeded weights on ``--device`` (default: the CUDA
card; without one it prints ``error: ...`` and exits 2), streams the
deterministic synthetic corpus, and runs supervised (checkpoint/restart,
straggler-monitored) training.  There is no mesh: the port trains on one
device.  A config with experts also reports the last step's MoE aux losses
(``moe_lb_loss``, ``moe_z_loss``).  The encoder-decoder and
vision-language configs need ``enc_frames`` or ``img_embeds``, which the
synthetic corpus does not make: the launcher prints ``error: ...`` naming
the missing input and exits 2 (the reference fails on the missing key).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from repro_torch.configs.base import get_arch
from repro_torch.kernels._platform import resolve_device
from repro_torch.models.model import Model, context_input
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.data import DataConfig, make_source
from repro_torch.train.fault_tolerance import SupervisorConfig, run_supervised
from repro_torch.train.train_step import TrainConfig, make_train_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_0_6b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the small same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--micro-steps", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="results/train_ckpt",
                    help="checkpoint directory; a checkpoint found there is resumed")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--d-model", type=int, default=0,
                    help="override width (e.g. ~100M-param config)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="device to train on (default: the CUDA card, raising "
                         "without one)")
    args = ap.parse_args(argv)

    try:
        device = resolve_device(args.device)
        cfg = get_arch(args.arch)
    except (RuntimeError, ValueError, ImportError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.reduced:
        cfg = cfg.reduced()
    if args.d_model:
        cfg = dataclasses.replace(cfg, d_model=args.d_model,
                                  d_ff=4 * args.d_model,
                                  n_heads=max(4, args.d_model // 64),
                                  n_kv_heads=max(2, args.d_model // 128),
                                  d_head=64)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)

    if context_input(cfg) is not None:
        print(f"error: {cfg.arch} needs {context_input(cfg)[0]!r} in every batch, which "
              f"the synthetic corpus does not make", file=sys.stderr)
        return 2
    model = Model(cfg, device=device)
    model.init(torch.Generator(device=device).manual_seed(0))
    print(f"arch={cfg.arch} params={cfg.param_count()/1e6:.1f}M device={device}")

    tcfg = TrainConfig(
        optimizer=opt.OptimizerConfig(lr=args.lr, warmup_steps=20,
                                      total_steps=args.steps),
        micro_steps=args.micro_steps,
    )
    state = opt.init(tcfg.optimizer, dict(model.named_parameters()))
    source = make_source(DataConfig(vocab=cfg.vocab, global_batch=args.batch,
                                    seq_len=args.seq))

    ckpt = Checkpointer(args.ckpt_dir, keep=2)
    step = make_train_step(model, tcfg)
    last: dict = {}

    def train_step(opt_state, batch):
        opt_state, metrics = step(opt_state, batch)
        last.update(metrics)
        return opt_state, metrics

    t0 = time.time()
    tokens_per_step = args.batch * args.seq
    _, state, history = run_supervised(
        train_step=train_step,
        params=model,
        opt_state=state,
        data_source=source,
        n_steps=args.steps,
        ckpt=ckpt,
        cfg=SupervisorConfig(checkpoint_every=args.ckpt_every),
    )
    dt = time.time() - t0
    if not history:
        print(f"done: nothing to run, {args.ckpt_dir} already holds step {args.steps}")
        return 0
    losses = [l for _, l in history]
    print(f"done: {len(history)} steps in {dt:.1f}s "
          f"({len(history)*tokens_per_step/dt:.0f} tok/s) | "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if cfg.n_experts and "moe_lb_loss" in last:  # accumulated steps report the loss alone
        print(f"moe aux, last step: moe_lb_loss {float(last['moe_lb_loss']):.4f} "
              f"moe_z_loss {float(last['moe_z_loss']):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
