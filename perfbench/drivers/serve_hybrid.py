"""Driver of the hybrid (Jamba) serving cells: ``drivers/serve.py``'s
closed loop of static waves and its check, with what a Mamba model needs
besides.

- Weights: the Mamba leaves are drawn as Mamba initialises them, from the
  seed, in the program's weights and the reference's alike (``fill``):
  ``A_log[i, s] = log(s + 1)``, ``D = 1``, ``dt_bias`` the inverse
  softplus of a dt log-uniform in [``DT_MIN``, ``DT_MAX``] a channel, and
  ``conv_b`` uniform in +-1/sqrt(d_conv), as a depthwise ``Conv1d``'s bias;
  every other leaf as ``harness.fill_weights`` makes it.
- The check reads the logits from ``reference/hybrid.py``, and compares
  more than the served tokens' gaps: ``serve.py``'s gaps see a fault only
  where it flips a token, and at eight layers over random prompts the
  float8 control flips as few as bfloat16 does.
  - Each served position's logits as the program chose from them (the
    engine's ``_greedy`` input) against the reference's: the relative L2
    error over the vocabulary, its worst (``logit_err``) and mean
    (``logit_err_mean``) over the checked waves' positions.
  - The recurrent state the first Mamba layer's prefill left in the
    serving cache against the reference's state at the prompts' end,
    channel by channel, the 90th percentile over the channels
    (``state_err``).  Random prompts carry little from a token to one 512
    tokens later, so a state lost between scan groups barely moves the
    logits, but it moves the state of the slowly decaying channels, about
    a quarter of them, which a norm over all channels would let the fast
    ones hide.  The first layer reads the same embedding rows in the
    program and the reference, so its state differs by the layer's own
    rounding alone; every later layer's also by the residual stream's
    drift (those stay readings, ``state_err_by_layer``).
  - The control's numbers: its float8 logits and states against the
    float32 ones.
- The record's prefill operations come from ``flops_hybrid.py``, its
  attention calls are the attention layers' own, and it names the scan's
  widths for ``serve.mamba_scan_roofline_pct``.  It stays ``"kind":
  "serve"``, so the serving metrics read it.
- One more planted fault, ``scan_carry_dropped``: the program's scan
  starts every group of chunks from a zero state, as if the state were not
  carried between them.

``serve.py`` runs the cell through a private instance of its module whose
weights, operation counts and reference are these.
"""
from __future__ import annotations

import math
import types
from pathlib import Path

import torch

from perfbench import flops_hybrid
from perfbench import harness as hx
from perfbench.reference import hybrid as ref_hybrid

DT_MIN, DT_MAX = 1e-3, 1e-1  # Mamba's dt range at initialisation
MAMBA_OWN = ("A_log", "D", "dt_bias", "conv_b")  # the mixer's leaves drawn here
FAULTS = ("scan_carry_dropped",)


def _mamba_own(name: str) -> bool:
    return ".mixer." in name and name.rsplit(".", 1)[-1] in MAMBA_OWN


@torch.no_grad()
def fill(leaves: list, seed: int, init_std: dict | None = None) -> None:
    """``harness.fill_weights`` for every leaf but the Mamba mixers' own,
    which are drawn as Mamba initialises them from a stream of the seed of
    their own (``sub_seed(seed, 3)``)."""
    hx.fill_weights([(n, t) for n, t in leaves if not _mamba_own(n)], seed, init_std)
    own = [(n, t) for n, t in leaves if _mamba_own(n)]
    if not own:
        return
    gen = torch.Generator(device=own[0][1].device).manual_seed(hx.sub_seed(seed, 3))
    for name, t in own:
        kind = name.rsplit(".", 1)[-1]
        if kind == "A_log":  # (d_in, ds): log(1 .. ds) in every channel
            t.copy_(torch.log(torch.arange(1, t.shape[1] + 1, dtype=torch.float32,
                                           device=t.device)).expand(t.shape))
        elif kind == "D":
            t.fill_(1.0)
        elif kind == "dt_bias":
            u = torch.rand(t.shape, generator=gen, device=t.device)
            dt = torch.exp(u * (math.log(DT_MAX) - math.log(DT_MIN)) + math.log(DT_MIN))
            t.copy_(dt + torch.log(-torch.expm1(-dt)))  # softplus(dt_bias) = dt
        else:  # conv_b: (d_in,), the conv's taps are conv_w's first dim
            taps = dict(leaves)[name.replace("conv_b", "conv_w")].shape[0]
            u = torch.rand(t.shape, generator=gen, device=t.device)
            t.copy_((2 * u - 1) / math.sqrt(taps))


def make_weights(shapes: list, seed: int, device, init_std: dict | None = None) -> dict:
    leaves = [(n, torch.empty(s, dtype=dt, device=device)) for n, s, dt in shapes]
    fill(leaves, seed, init_std)
    return dict(leaves)


def _serve_module(program: dict, reference: dict):
    """A private instance of ``serve.py``'s module, reading the weights,
    operation counts and reference of this driver.  It appends to
    ``program["logits"]`` the logits of every position the engine chose a
    token from, to ``program["states"]`` each prefill's Mamba states, and
    to ``reference[precision]`` the reference's (logits, states) of each
    checked wave."""
    mod = hx.load_module(Path(__file__).with_name("serve.py"), "perfbench_driver_serve_for_hybrid")
    harness = types.ModuleType("perfbench_harness_for_hybrid")
    harness.__dict__.update(vars(hx))
    harness.fill_weights, harness.make_weights = fill, make_weights
    ref = types.ModuleType("perfbench_reference_for_hybrid")
    ref.token_gaps = ref_hybrid.token_gaps

    def served_logits(*args, precision="f32", **kw):
        states = []
        logits = ref_hybrid.served_logits(*args, precision=precision, states=states, **kw)
        reference.setdefault(precision, []).append((logits, states))
        return logits
    ref.served_logits = served_logits
    inject = mod._inject

    def inject_and_tap(engine, fault, vocab):
        inject(engine, fault, vocab)
        greedy, prefill = engine._greedy, engine.prefill

        def tapped_greedy(logits):  # (B, 1, vocab_padded), kept on the device
            program["logits"].append(logits[:, -1, :vocab])
            return greedy(logits)

        def tapped_prefill(batch, cache):  # decode replaces a state, never writes it
            logits, cache = prefill(batch, cache)
            program["states"].append([c["h"] for c in cache["blocks"] if "h" in c])
            return logits, cache
        engine._greedy, engine.prefill = tapped_greedy, tapped_prefill
    mod.hx, mod.fl, mod.ref_serve, mod._inject = harness, flops_hybrid, ref, inject_and_tap
    return mod


def _numbers(got: list, want: list) -> dict:
    """``got`` against ``want``, a (logits (B, n, vocab), [Mamba states (B,
    d_in, ds)]) pair each checked wave: each served position's relative L2
    error over the vocabulary, the worst and the mean; the first Mamba
    layer's state channel by channel (the relative L2 error over the batch
    and the state), the 90th percentile over the channels (``state_err``),
    the mean and the worst; and each layer's whole state's relative L2
    error (``state_err_by_layer``)."""
    errs = torch.cat([((g.float() - w).norm(dim=-1) / w.norm(dim=-1)).flatten()
                      for (g, _), (w, _) in zip(got, want)])
    layers = list(zip(*[zip(gs, ws) for (_, gs), (_, ws) in zip(got, want)]))
    whole = [max(float((g - w).norm() / w.norm()) for g, w in layer) for layer in layers]
    chan = torch.cat([(g - w).norm(dim=(0, 2)) / w.norm(dim=(0, 2)) for g, w in layers[0]])
    return {"logit_err": float(errs.max()), "logit_err_mean": float(errs.mean()),
            "state_err": float(chan.quantile(0.9)), "state_err_mean": float(chan.mean()),
            "state_err_max": float(chan.max()), "state_err_by_layer": whole}


def _drop_scan_carry():
    """Plant ``scan_carry_dropped`` in the program; returns the undo."""
    from repro_torch.models import ssm

    group = ssm._mamba_group

    def from_zero(dtc, bc, xc, cc, a, h0):
        return group(dtc, bc, xc, cc, a, torch.zeros_like(h0))

    ssm._mamba_group = from_zero
    return lambda: setattr(ssm, "_mamba_group", group)


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        fault: str | None = None, control: bool = False) -> dict:
    undo = _drop_scan_carry() if fault == "scan_carry_dropped" else None
    program, reference = {"logits": [], "states": []}, {}
    try:
        out = _serve_module(program, reference).run(
            cell, seed, seconds, trace, device, t_start,
            fault=None if fault in FAULTS else fault, control=control)
    finally:
        if undo is not None:
            undo()
    # the engine chooses new + 1 times a wave (the last unused), the warm-up wave first
    new, per_wave = cell.traffic["new"], cell.traffic["new"] + 1
    got = [(torch.stack(program["logits"][(w + 1) * per_wave:(w + 1) * per_wave + new], dim=1),
            program["states"][w + 1]) for w in out["readings"]["checked_waves"]]
    out["numbers"].update(_numbers(got, reference["f32"]))
    if control:
        out["control_numbers"].update(_numbers(reference["fp8"], reference["f32"]))
    if trace:
        arch = cell.arch
        kinds = flops_hybrid.layer_kinds(arch)
        rec = out["record"]
        rec["attention_calls"] = [dict(c, count=sum(m == "attn" for m, _ in kinds))
                                  for c in rec["attention_calls"]]
        rec["mamba"] = dict(flops_hybrid.mamba_dims(arch),
                            layers=sum(m == "mamba" for m, _ in kinds))
    return out
