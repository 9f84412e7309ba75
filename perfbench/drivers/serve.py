"""Driver of the serving cells: a closed loop of static waves through the
port's ``ServeEngine.run``, then a check of the served tokens against the
plain reference.

Each wave is ``batch`` requests of ``prompt`` seeded token ids (drawn
uniformly over the vocabulary) and ``new`` greedy tokens; the next wave is
sent when the last one is served.  Set-up serves one wave of the same
shape, which warms every shape the window uses (and builds the attention
kernel in a fresh checkout).  With ``--trace 1`` the window's prefill and
decode calls are timed with CUDA events, and one more wave runs under
``torch.profiler``.

The check draws ``check_waves`` of the window's waves from the seed and
works out, with the plain model, the logits that chose each served token.
Each served token's gap is how far its logit lies below the best one
there; the numbers are the widest gap, the mean gap and the worst
request's mean gap (the workload's ``limits`` say which are compared).
"""
from __future__ import annotations

import random
import statistics
import time

import numpy as np
import torch

from perfbench import flops as fl
from perfbench import harness as hx
from perfbench.reference import model as ref_model
from perfbench.reference import serve as ref_serve

SPANS = ("serve.wave", "serve.prefill", "serve.decode")


class Prompts:
    """Seeded waves of prompts, on the host as the engine takes them."""

    def __init__(self, seed: int, batch: int, prompt: int, vocab: int):
        self.rng = np.random.default_rng(hx.sub_seed(seed, 1))
        self.shape, self.vocab = (batch, prompt), vocab

    def next(self) -> np.ndarray:
        return self.rng.integers(0, self.vocab, self.shape, dtype=np.int32)


class Timed:
    """Wraps an engine's bound ``prefill`` or ``decode``: a span for the
    profiler and, when ``events`` is on, CUDA events around each call."""

    def __init__(self, fn, span: str, device):
        self.fn, self.span, self.device = fn, span, device
        self.events = False
        self.pairs: list = []

    def __call__(self, *args):
        with torch.profiler.record_function(self.span):
            if not self.events:
                return self.fn(*args)
            if self.device.type != "cuda":  # the CPU tests: the host's clock
                t = time.perf_counter()
                out = self.fn(*args)
                self.pairs.append(time.perf_counter() - t)
                return out
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = self.fn(*args)
            b.record()
            self.pairs.append((a, b))
            return out

    def seconds(self) -> list:
        return [p if isinstance(p, float) else p[0].elapsed_time(p[1]) / 1e3 for p in self.pairs]


def _inject(engine, fault: str | None, vocab: int) -> None:
    """The faults the check must catch, planted where the tokens are made."""
    if fault == "token_altered":
        greedy = engine._greedy

        def altered(logits):
            cur = greedy(logits).copy()
            cur[0] = (cur[0] + 1) % vocab
            return cur
        engine._greedy = altered
    elif fault == "stale_state":
        decode, first = engine.decode, {}

        def stale(tokens, cache, pos):
            if "out" not in first:
                first["out"] = decode(tokens, cache, pos)[0]
            return first["out"], cache
        engine.decode = stale
    elif fault == "half_batch":
        prefill = engine.prefill

        def half(batch, cache):
            toks = batch["tokens"]
            h = toks.shape[0] // 2
            return prefill(dict(batch, tokens=torch.cat([toks[:h], toks[:h]])), cache)
        engine.prefill = half
    elif fault is not None:
        raise ValueError(fault)


def _gap_numbers(gaps: list) -> dict:
    """The numbers the check can compare, over the checked waves' (B, n)
    gaps: the widest, the mean and the worst request's mean."""
    g = torch.cat(gaps)
    return {"token_gap": float(g.max()), "token_gap_mean": float(g.mean()),
            "token_gap_request": float(g.mean(1).max())}


def _by_position(gaps: list) -> dict:
    """Each served position's widest and mean gap, and the share of served
    tokens with any gap, over the checked waves' (B, n) gaps."""
    g = torch.cat(gaps)
    return {"max": g.max(0).values.tolist(), "mean": g.mean(0).tolist(),
            "nonzero_share": float((g > 0).float().mean())}


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        fault: str | None = None, control: bool = False) -> dict:
    from repro_torch.models import Model
    from repro_torch.serve.legacy.engine import Request, ServeEngine

    hx.mark("program_imported")

    tr = cell.traffic
    batch, prompt, new = tr["batch"], tr["prompt"], tr["new"]
    arch = cell.arch
    init = cell.config.get("init_std", {})
    model = Model(hx.arch_config(arch), device=device)
    hx.mark("model_built", device)
    shapes = hx.param_shapes(model)
    hx.fill_weights(list(model.named_parameters()), seed, init)
    hx.mark("weights", device)
    engine = ServeEngine(model, batch=batch, max_seq=prompt + new)
    prefill = Timed(engine.prefill, "serve.prefill", device)
    decode = Timed(engine.decode, "serve.decode", device)
    engine.prefill, engine.decode = prefill, decode
    _inject(engine, fault, arch["vocab"])
    prompts = Prompts(seed, batch, prompt, arch["vocab"])

    def wave(index: int) -> list:
        toks = prompts.next()
        with torch.profiler.record_function("serve.wave"):
            reqs = [Request(rid=index * batch + i, prompt=toks[i], max_new=new)
                    for i in range(batch)]
            return engine.run(reqs)

    wave(-1)  # warm-up: every shape of the window
    setup_peak = hx.peak_bytes(device)
    setup_s = hx.now(device) - t_start

    hx.reset_peak(device)
    prefill.events = decode.events = trace
    served, waves, t0 = [], 0, hx.now(device)
    ends = []
    while True:
        served.append(wave(waves))
        waves += 1
        t1 = time.perf_counter()
        ends.append(t1 - t0)
        if t1 - t0 >= seconds:
            break
    peak = hx.peak_bytes(device)
    done = sum(len(w) for w in served)
    out = {"attempted": waves * batch, "failed": waves * batch - done, "setup_s": setup_s,
           "serve_tokens_per_s": done * (prompt + new) / (t1 - t0), "peak_gb": peak / 1e9,
           "memory_peak": max(peak, setup_peak)}

    if trace:
        prefill_s, decode_s = prefill.seconds(), decode.seconds()
        prefill.events = decode.events = False
        tracer = hx.Tracer(device, SPANS)
        with tracer:
            wave(waves)
        f = fl.prefill_flops(arch, batch, prompt)
        hd = arch.get("d_head") or arch["d_model"] // arch["n_heads"]
        call = fl.attention_call(batch, prompt, arch["n_heads"], arch["n_kv_heads"], hd)
        out["record"] = {
            "kind": "serve", "trace": tracer.record,
            "prefill_s": statistics.mean(prefill_s), "prefill_flops": f["flops"],
            "decode_step_s": statistics.mean(decode_s) if decode_s else None,
            "attention_calls": [{"count": arch["n_layers"], **call}]}

    # the check, with the program's state freed
    del engine, model, prefill, decode
    hx.free(device)
    pick = random.Random(hx.sub_seed(seed, 2))
    checked = sorted(pick.sample(range(len(served)), min(tr["check_waves"], len(served))))
    replay = Prompts(seed, batch, prompt, arch["vocab"])
    wave_prompts = [replay.next() for _ in range(max(checked) + 2)][1:]  # after the warm-up's
    weights = hx.make_weights(shapes, seed, device, init)
    t_check = time.perf_counter()
    per_token, control_per_token, pairs = [], [], {}
    for w in checked:
        by_rid = {r.rid: r for r in served[w]}
        rows = [by_rid[w * batch + i] for i in range(batch)]
        toks = torch.as_tensor(wave_prompts[w], device=device)
        got = torch.as_tensor(np.stack([r.out for r in rows]), device=device)
        logits = ref_serve.served_logits(arch, weights, toks, got, pairs=pairs)
        per_token.append(ref_serve.token_gaps(logits, got).cpu())
        if control:  # the tokens float8 would put first, read in the float32 logits
            low = ref_serve.served_logits(arch, weights, toks, got, precision="fp8")
            control_per_token.append(ref_serve.token_gaps(logits, low.argmax(-1)).cpu())
            del low
        del logits
    del weights
    hx.free(device)
    out["numbers"] = _gap_numbers(per_token)
    if control:
        out["control_numbers"] = _gap_numbers(control_per_token)
    out["readings"] = {"checked_waves": checked, "wave_gaps": [float(g.max()) for g in per_token],
                       "served_tokens_checked": len(checked) * batch * new,
                       "check_s": time.perf_counter() - t_check, "wave_ends_s": ends,
                       "gap_by_position": _by_position(per_token),
                       "ref_drop_share": ref_model.drop_share(pairs)}
    if control:
        out["readings"]["control_gap_by_position"] = _by_position(control_per_token)
    return out
