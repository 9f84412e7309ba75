"""Batched serving engine (port of ``repro/serve/legacy/engine.py``).

Static-shape serving: the engine keeps a fixed decode batch of ``batch``
slots and serves requests in waves of ``batch``, padding the last wave with
dummy requests.  Prompts are right-padded to the wave's longest, prefilled
in one call, then decoded greedily (argmax over ``logits[:, -1, :vocab]``)
one token per step for the whole wave.

The port's model holds its weights, so the engine takes the model alone,
and runs eagerly (the reference's ``jit`` flag has no counterpart).  It
runs on the model's device, for every family: the cache holds each
self-attention layer's K/V, each mamba or rwkv layer's recurrent state and
the cross-attention context ``kv_src``, which prefill fills and decode
carries.  ``run(requests, extras)`` gives every wave's prefill the
``extras`` arrays as well (the stub front ends' ``enc_frames`` or
``img_embeds``, batch-sized), as the reference's does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.models.model import Model


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (len,) int32
    max_new: int = 16
    out: Optional[np.ndarray] = None


class ServeEngine:
    def __init__(self, model: Model, batch: int = 4, max_seq: int = 128):
        self.model = model
        self.batch = batch
        self.max_seq = max_seq
        self.prefill = model.prefill
        self.decode = model.decode_step

    def _pad_prompts(self, prompts: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
        lens = np.array([len(p) for p in prompts])
        width = int(lens.max())
        toks = np.zeros((len(prompts), width), dtype=np.int32)
        for i, p in enumerate(prompts):
            toks[i, : len(p)] = p  # right-padded; positions beyond len unused
        return toks, lens

    def _greedy(self, logits: torch.Tensor) -> np.ndarray:
        return torch.argmax(logits[:, -1, : self.model.cfg.vocab], dim=-1).cpu().numpy()

    def run(self, requests: list[Request], extras: dict | None = None) -> list[Request]:
        """Serve a list of requests in fixed-size waves (greedy decoding).
        ``extras``: batch entries of shape (batch, ...) (arrays or tensors)
        added to every wave's prefill."""
        done: list[Request] = []
        queue = list(requests)
        dev = self.model.device
        while queue:
            wave = queue[: self.batch]
            queue = queue[self.batch :]
            # pad the wave to the engine's static batch
            while len(wave) < self.batch:
                wave.append(Request(rid=-1, prompt=wave[0].prompt, max_new=0))
            toks, lens = self._pad_prompts([r.prompt for r in wave])
            width = toks.shape[1]
            assert width + max(r.max_new for r in wave) <= self.max_seq
            cache = self.model.init_cache(self.batch, self.max_seq)
            batch = {"tokens": torch.from_numpy(toks).to(dev)}
            if extras:
                batch.update({k: torch.as_tensor(v).to(dev) for k, v in extras.items()})
            logits, cache = self.prefill(batch, cache)
            # NOTE: with right-padding, the "last" prompt token for shorter
            # requests is a pad; the engine serves same-length waves exactly
            # and mixed-length waves approximately (documented limitation of
            # the static-batch engine; production uses per-slot positions).
            outs = [[] for _ in wave]
            cur = self._greedy(logits)
            max_new = max(r.max_new for r in wave)
            for step in range(max_new):
                for i, r in enumerate(wave):
                    if step < r.max_new:
                        outs[i].append(int(cur[i]))
                nxt = torch.from_numpy(cur.astype(np.int32)[:, None]).to(dev)
                logits, cache = self.decode(nxt, cache, width + step)
                cur = self._greedy(logits)
            for r, o in zip(wave, outs):
                if r.rid >= 0:
                    r.out = np.asarray(o[: r.max_new], dtype=np.int32)
                    done.append(r)
        return done
