"""Data pipeline: deterministic, shardable token streams with prefetch
(the port's copy of ``repro/train/data.py``, numpy only; batches are
bit-equal to the reference's).

Two sources:
- ``SyntheticLM``: seeded synthetic token batches — the batch for step ``i``
  is a pure function of (seed, i), so a restarted job resumes bit-identically
  mid-epoch without data-state checkpointing (the step counter in the train
  checkpoint IS the data cursor).  Markov-chain structure (not iid uniform)
  so the loss curve actually falls.
- ``MemmapCorpus``: file-backed pre-tokenized corpora (np.memmap of int32),
  deterministic strided sampling per step.

Both yield host numpy; ``Prefetcher`` overlaps host batch assembly with
device compute (a background thread and a bounded queue).  The train step
moves a batch to the model's device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    global_batch: int
    seq_len: int
    seed: int = 1234
    kind: str = "synthetic"  # synthetic | memmap
    path: Optional[str] = None  # memmap file (int32 tokens)


class SyntheticLM:
    """Deterministic synthetic LM stream with learnable structure.

    Tokens follow a per-sequence random affine recurrence
    ``t_{i+1} = (a * t_i + b + noise) mod vocab`` with a small noise rate, so
    next-token prediction is learnable and loss decreases quickly.
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b, s = cfg.global_batch, cfg.seq_len
        a = rng.integers(1, 8, size=(b, 1))
        off = rng.integers(0, cfg.vocab, size=(b, 1))
        start = rng.integers(0, cfg.vocab, size=(b, 1))
        idx = np.arange(s + 1)[None, :]
        # affine progression, occasionally reseeded by noise
        toks = (start + a * idx + off * (idx // 17)) % cfg.vocab
        noise = rng.random((b, s + 1)) < 0.02
        toks = np.where(noise, rng.integers(0, cfg.vocab, size=(b, s + 1)), toks)
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class MemmapCorpus:
    """Pre-tokenized flat corpus (int32 binary file), strided deterministic
    sampling: step i reads global_batch windows at deterministic offsets."""

    def __init__(self, cfg: DataConfig):
        if not cfg.path:
            raise ValueError("memmap corpus needs a path")
        self.cfg = cfg
        self.data = np.memmap(cfg.path, dtype=np.int32, mode="r")
        self.n_windows = max(1, (len(self.data) - 1) // cfg.seq_len)

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        idx = rng.integers(0, self.n_windows, size=cfg.global_batch)
        tokens = np.stack(
            [self.data[i * cfg.seq_len : i * cfg.seq_len + cfg.seq_len] for i in idx]
        ).astype(np.int32)
        labels = np.stack(
            [self.data[i * cfg.seq_len + 1 : i * cfg.seq_len + cfg.seq_len + 1] for i in idx]
        ).astype(np.int32)
        return {"tokens": tokens, "labels": np.ascontiguousarray(labels)}


def make_source(cfg: DataConfig):
    return MemmapCorpus(cfg) if cfg.kind == "memmap" else SyntheticLM(cfg)


class Prefetcher:
    """Bounded background prefetch of per-step batches."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self):
        step, batch = self.q.get()
        return step, batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
