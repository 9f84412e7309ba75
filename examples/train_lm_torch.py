"""End-to-end LM training through the PyTorch port: a small qwen3-family
model for a few hundred steps on the synthetic corpus, with a checkpoint
and a restart.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 200]      # the CUDA card
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 20

The twin of ``examples/train_lm.py``: the same driver as the launcher
(``python -m repro_torch.launch.train``), d_model 256 and 6 layers, 8
sequences of 128 tokens a step, checkpoints every 50 steps (every half
run when it is shorter) under ``results/train_lm_torch_ckpt``.  Then the
restart: the run's last checkpoint is dropped, as if the job had died
after its last update and before that save, and the same command resumes
from the one before and trains to the end again; on the CPU its last loss
equals the first run's.
"""
import argparse
import contextlib
import io
import os
import shutil
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

CKPT_DIR = os.path.join("results", "train_lm_torch_ckpt")


def _launch(argv: list) -> tuple[int, str]:
    """The launcher's exit code and its last ``done:`` line, echoing its output."""
    from repro_torch.launch import train as train_mod

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train_mod.main(argv)
    print(out.getvalue(), end="")
    done = [line for line in out.getvalue().splitlines() if line.startswith("done:")]
    return rc, done[-1] if done else ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default=None,
                    help="device to train on (default: the CUDA card)")
    args = ap.parse_args(argv)

    from repro_torch.train.checkpoint import Checkpointer

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    every = max(1, min(50, args.steps // 2))
    launch = [
        "--arch", "qwen3_0_6b", "--reduced",
        "--d-model", "256", "--layers", "6",
        "--steps", str(args.steps), "--batch", "8", "--seq", "128",
        "--ckpt-dir", CKPT_DIR, "--ckpt-every", str(every),
    ] + ([] if args.device is None else ["--device", args.device])
    rc, first = _launch(launch)
    if rc:
        return rc

    ckpt = Checkpointer(CKPT_DIR, keep=2)
    steps = ckpt.all_steps()
    shutil.rmtree(os.path.join(CKPT_DIR, f"step_{steps[-1]:08d}"))
    print(f"restart: dropped the checkpoint of step {steps[-1]}, resuming from "
          f"step {steps[-2]}")
    rc, again = _launch(launch)
    if rc:
        return rc
    last, last_again = (line.rsplit("-> ", 1)[1] for line in (first, again))
    print(f"restart: last loss {last_again} (first run {last})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
