"""Driver of the training cells: ``make_train_step``'s step on seeded
batches, timed over the window, then checked against the plain reference.

Set-up builds one model, its optimizer state and its step, with the
weights made from the seed, and drives that step through its first
``checked_steps`` steps on the window's own feed (each step a new batch of
seeded token ids).  Those steps warm every shape the window uses and are
the ones the check compares: each step's loss, each leaf's first clipped
gradient (from the first moment after one step) and each leaf's change
over the steps.  The window then runs the same step on further batches
until ``--seconds`` have passed.  With ``--trace 1`` a few more steps run
under ``torch.profiler``, and a few after them split into the forward and
backward and the optimizer.
"""
from __future__ import annotations

import statistics
import time

import torch

from perfbench import flops as fl
from perfbench import harness as hx
from perfbench.reference import train as ref_train

SPANS = ("train.step", "train.fwd_bwd", "train.optimizer")
PROFILED_STEPS = 2
SPLIT_STEPS = 2


class Feed:
    """Seeded batches of next-token prediction on the device: ids drawn
    uniformly over the vocabulary, labels the ids shifted by one."""

    def __init__(self, seed: int, batch: int, seq: int, vocab: int, device):
        self.gen = torch.Generator(device=device).manual_seed(hx.sub_seed(seed, 1))
        self.shape, self.vocab, self.device = (batch, seq + 1), vocab, device

    def next(self) -> dict:
        ids = torch.randint(0, self.vocab, self.shape, generator=self.gen, device=self.device)
        return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}


def _norms(tensors: dict, scale: float = 1.0) -> dict:
    return {n: float(t.float().norm()) * scale for n, t in tensors.items()}


def _leaf_gaps(program: dict, reference: dict, names) -> dict:
    """Each leaf's gap between the program's norm and the reference's, over
    the larger of that leaf's reference norm and the median leaf's."""
    names = list(names)
    med = statistics.median(reference[n] for n in names)
    return {n: abs(program[n] - reference[n]) / max(reference[n], med, 1e-30) for n in names}


def _numbers(losses, grad_norms, change_norms, ref: dict, moved: list) -> dict:
    """The numbers the check can compare (the workload's ``limits`` say
    which it does): the worst step's relative loss gap, and the worst and
    the median leaf's gap of the first clipped gradient and of the change."""
    grad = _leaf_gaps(grad_norms, ref["grad_norms"], ref["grad_norms"])
    change = _leaf_gaps(change_norms, ref["change_norms"], moved)
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])),
        "grad_gap": max(grad.values()),
        "change_gap": max(change.values()),
        "grad_gap_median": statistics.median(grad.values()),
        "change_gap_median": statistics.median(change.values()),
        "worst_leaves": [max(grad, key=grad.get), max(change, key=change.get)],
    }


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        fault: str | None = None, control: bool = False) -> dict:
    from repro_torch.models import Model
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import TrainConfig, make_train_step

    hx.mark("program_imported")

    tr = cell.traffic
    batch, seq, n_checked = tr["batch"], tr["seq"], tr["checked_steps"]
    hp = tr["optimizer"]
    arch = cell.arch
    init = cell.config.get("init_std", {})

    model = Model(hx.arch_config(arch), device=device)
    hx.mark("model_built", device)
    shapes = hx.param_shapes(model)
    params = dict(model.named_parameters())
    hx.fill_weights(list(params.items()), seed, init)
    hx.mark("weights", device)
    tcfg = TrainConfig(optimizer=opt.OptimizerConfig(**hp))
    state = opt.init(tcfg.optimizer, params)
    step = make_train_step(model, tcfg)
    if fault == "stale_state":
        def step(state, batch, _real=step):  # noqa: F811 - the fault's step
            loss, _ = model.loss(batch)
            return state, {"loss": loss.detach()}
    elif fault == "half_batch":
        def step(state, batch, _real=step):  # noqa: F811
            return _real(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
    feed = Feed(seed, batch, seq, arch["vocab"], device)

    # the checked steps, which also warm every shape
    losses = []
    grad_norms = {}
    for i in range(n_checked):
        state, m = step(state, feed.next())
        losses.append(float(m["loss"]))
        if i == 0:
            grad_norms = _norms(state["m"], 1.0 / (1.0 - hp["beta1"]))
    start = hx.make_weights(shapes, seed, device, init)
    with torch.no_grad():
        change_norms = {n: float((params[n].float() - start[n].float()).norm()) for n in params}
    del start
    setup_peak = hx.peak_bytes(device)
    setup_s = hx.now(device) - t_start

    # the window
    hx.reset_peak(device)
    steps, t0 = 0, hx.now(device)
    ends = []
    while True:
        state, m = step(state, feed.next())
        hx.sync(device)
        steps += 1
        t1 = time.perf_counter()
        ends.append(t1 - t0)
        if t1 - t0 >= seconds:
            break
    peak = hx.peak_bytes(device)
    step_s = (t1 - t0) / steps
    tokens = batch * seq
    out = {"attempted": steps, "failed": 0, "setup_s": setup_s,
           "train_tokens_per_s": steps * tokens / (t1 - t0), "peak_gb": peak / 1e9,
           "memory_peak": max(peak, setup_peak)}

    if trace:
        tracer = hx.Tracer(device, SPANS)
        with tracer:
            for _ in range(PROFILED_STEPS):
                with torch.profiler.record_function("train.step"):
                    state, m = step(state, feed.next())
        fwd_bwd, optim = [], []
        for _ in range(SPLIT_STEPS):
            batch_ = feed.next()
            t = hx.now(device)
            loss, _ = model.loss(batch_)
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
            t2 = hx.now(device)
            opt.update(tcfg.optimizer, grads, state, params)
            t3 = hx.now(device)
            fwd_bwd.append(t2 - t)
            optim.append(t3 - t2)
            del grads, loss
        f = fl.train_flops(arch, batch, seq)
        out["record"] = {
            "kind": "train", "trace": tracer.record, "step_s": step_s,
            "profiled_steps": PROFILED_STEPS, "step_flops": f["flops"],
            "fwd_bwd_s": statistics.mean(fwd_bwd),
            "optimizer_s": statistics.mean(optim)}

    # the check, with the program's state freed
    del step, state, model, params, feed, m
    hx.free(device)
    t_check = time.perf_counter()
    weights = hx.make_weights(shapes, seed, device, init)
    ref_feed = Feed(seed, batch, seq, arch["vocab"], device)
    batches = [(b["tokens"], b["labels"]) for b in (ref_feed.next() for _ in range(n_checked))]
    ref = ref_train.run(arch, weights, batches, hp)
    hx.free(device)
    moved = [n for n in ref["grad_norms"]
             if ref["grad_norms"][n] >= 1e-3 * statistics.median(ref["grad_norms"].values())]
    out["numbers"] = _numbers(losses, grad_norms, change_norms, ref, moved)
    if control:  # the reference in float8, in the program's place
        low = ref_train.run(arch, weights, batches, hp, precision="fp8")
        out["control_numbers"] = _numbers(low["losses"], low["grad_norms"],
                                          low["change_norms"], ref, moved)
    del weights, batches
    hx.free(device)
    out["readings"] = {"losses": losses, "ref_losses": ref["losses"],
                       "check_s": time.perf_counter() - t_check, "step_ends_s": ends,
                       "excluded_from_change": sorted(set(ref["grad_norms"]) - set(moved)),
                       "ref_drop_share": ref["drop_share"]}
    return out
