"""The port's LM training path against the JAX package's, and the train
goldens.

On ``qwen3_0_6b.reduced()`` in f32 with weights from
``interop.lm_params_numpy``, carried into both packages:

- ``Model.loss`` equals the reference's ``model.loss`` at rtol 1e-5, with
  and without a mask, and every gradient leaf equals ``jax.grad``'s at
  rtol/atol 1e-4 (f32 sums in another order than XLA's, through 2 layers
  and a backward pass);
- remat "full", "dots" and off give equal losses and gradients, and
  ``Model.forward`` (the attention kernel's plain version on the CPU) gives
  the training path's logits;
- ``_blocked_sdpa`` equals the reference's, and training attention takes it
  above the threshold;
- whole train steps (3 single steps, and 2 with ``micro_steps=2``) give the
  reference's metrics and weights.  Adam's first step is about
  ``sign(g) * lr`` wherever ``|g| >> eps``, so an element whose gradient is
  within float noise of zero may move the other way: weights are compared
  where the reference's gradient exceeded ``GRAD_FLOOR`` at every step, and
  those must be at least 99% of all;
- a supervised run with failures injected at steps 7 and 13 ends bit-equal
  to an uninterrupted one;
- ``python -m repro_torch.launch.train --device cpu --reduced`` trains with
  a falling loss, qwen3 and rwkv6 (the per-token scan under autograd and
  remat); a MoE config reports its aux losses; without ``--device`` and a
  card it exits 2.

``tests/data/torch_golden_train.json`` records what the reference trains
for f32 cuts of qwen3 (``reduced()``, and full width cut to 2 layers and a
1,024-token vocab), the ``reduced()`` cut of each of the six other families
(qwen2-moe, arctic, jamba, rwkv6, whisper and llama-vision; the last two
with their stub front ends' inputs, ``interop.context_inputs_numpy`` at the
file's ``context_seed``, the same at every step) and qwen2-moe at full
width cut to 1 layer and a 1,024-token vocab: the loss, grad norm and
learning rate of each of 3 steps on ``SyntheticLM`` batches, and each
weight leaf's sum, sum of absolute values, norm and norm of its change
after them.  A MoE golden records ``router_min_gap``, the smallest gap
between a token's k-th and (k+1)-th router probability over the
reference's 3 steps (a flipped expert moves the loss by O(1)).  The card's
machine has no JAX, so ``chip_smoke.py`` holds the port on the card against
this file; here the port on the CPU is, on every golden but the one marked
``card_only`` (the full-width MoE layer, too slow for the CPU suite).
Regenerate it (about a minute, ~15 GB):

    PYTHONPATH=src python tests/test_torch_train.py --write
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import get_arch as ref_get_arch  # noqa: E402
from repro.models import Model as RefModel  # noqa: E402
from repro.models import attention as ref_attention  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train.train_step import TrainConfig as RefTrainConfig  # noqa: E402
from repro.train.train_step import make_train_step as ref_make_train_step  # noqa: E402
from repro_torch.configs.base import ArchConfig, get_arch  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    context_inputs_numpy,
    lm_params_numpy,
    lm_params_to_numpy,
    load_lm_params,
    tree_leaves,
)
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.checkpoint import Checkpointer  # noqa: E402
from repro_torch.train.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.train.fault_tolerance import SupervisorConfig, run_supervised  # noqa: E402
from repro_torch.train.train_step import TrainConfig, make_train_step  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
GOLDEN_PATH = ROOT / "tests" / "data" / "torch_golden_train.json"
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # gradients: f32 sums through forward and backward in another order
GRAD_FLOOR = 1e-6  # |g| below this may flip Adam's first step (see the docstring)
STEP_TOL = 1e-5  # metrics and weights of whole steps where |g| > GRAD_FLOOR
# the goldens: the file records these, chip_smoke.py reads them from it
GOLDEN_TOL = {"loss_rtol": 1e-4, "grad_norm_rtol": 1e-4, "norm_rtol": 1e-5,
              "sum_abs_frac": 1e-5, "delta_norm_rtol": 1e-3}
# one golden's own tolerances over GOLDEN_TOL.  rwkv6's grad norm after the
# first update follows its time mix's wk, wr and wv to ~1e-4: Adam's first
# step on gradients clipped from a norm of ~62 to 1 moves elements near eps
# in proportion to their gradient, so gradient differences of ~1e-7 (f32
# sums in another order through 64 recurrent steps) leave weights up to 4e-5
# apart, and those move the next grad norm by 1.6e-4.  From the reference's
# own weights after the first step the port's grad norm is within 7.3e-6.
GOLDEN_TOL_OVERRIDES = {"rwkv6_1_6b.reduced": {"grad_norm_rtol": 1e-3}}
GOLDEN_STEPS, GOLDEN_BATCH, GOLDEN_SEQ = 3, 2, 64
GOLDEN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=3)


# the families trained after the dense one, in the order of their goldens
FAMILIES = ("qwen2_moe_a2_7b", "arctic_480b", "jamba_v0_1_52b", "rwkv6_1_6b",
            "whisper_small", "llama3_2_vision_90b")
CONTEXT_SEED = 300  # the stub front ends' inputs of a golden with a context
CARD_ONLY = ("qwen2_moe_a2_7b.full_width.1_layer",)  # chip_smoke.py holds it, not the CPU


def golden_configs() -> list[tuple[str, ArchConfig, int]]:
    """(name, f32 config, weight seed) of each golden."""
    full = get_arch("qwen3_0_6b")
    return [("qwen3_0_6b.reduced", full.reduced(), 0),
            ("qwen3_0_6b.full_width.2_layers", dataclasses.replace(
                full, n_layers=2, vocab=1024, dtype="float32"), 1),
            *((f"{arch}.reduced", get_arch(arch).reduced(), 2 + i)
              for i, arch in enumerate(FAMILIES)),
            ("qwen2_moe_a2_7b.full_width.1_layer", dataclasses.replace(
                get_arch("qwen2_moe_a2_7b"), n_layers=1, vocab=1024, dtype="float32"),
             2 + len(FAMILIES))]


def ref_config(cfg: ArchConfig):
    return dataclasses.replace(ref_get_arch(cfg.arch), **dataclasses.asdict(cfg))


def golden_data(cfg: ArchConfig, seed: int) -> SyntheticLM:
    return SyntheticLM(DataConfig(vocab=cfg.vocab, global_batch=GOLDEN_BATCH,
                                  seq_len=GOLDEN_SEQ, seed=100 + seed))


def golden_context(cfg: ArchConfig) -> dict:
    """The stub front ends' inputs of every batch of a golden (``{}`` for a
    text-only config)."""
    return context_inputs_numpy(cfg, GOLDEN_BATCH, CONTEXT_SEED)


def leaf_stats(tree: dict, init: dict) -> dict:
    """path -> sum, sum of |w|, norm and norm of the change from ``init``,
    in f64, over every leaf of a reference-layout tree."""
    out, init = {}, dict(tree_leaves(init))
    for key, w in tree_leaves(tree):
        w, w0 = np.asarray(w, np.float64), np.asarray(init[key], np.float64)
        out[key] = dict(sum=float(w.sum()), abs_sum=float(np.abs(w).sum()),
                        norm=float(np.linalg.norm(w)), delta_norm=float(np.linalg.norm(w - w0)))
    return out


def write_golden() -> None:
    """Train each golden configuration with the JAX reference on the CPU.
    A MoE config's steps run with ``jax.lax.top_k`` recording, through a
    debug callback, the smallest gap between the k-th and (k+1)-th router
    probability of every routing (forward and remat's recompute)."""
    records = []
    real_top_k = jax.lax.top_k
    for name, cfg, seed in golden_configs():
        gaps: list = []

        def record(probs, k=cfg.top_k):
            top = np.sort(np.asarray(probs), axis=-1)[..., -k - 1:]
            gaps.append(float((top[..., 1] - top[..., 0]).min()))

        def recording(probs, k):
            jax.debug.callback(record, probs)
            return real_top_k(probs, k)

        model = RefModel(ref_config(cfg))
        init = lm_params_numpy(cfg, seed)
        params = jax.tree.map(jnp.asarray, init)
        tcfg = RefTrainConfig(optimizer=ref_opt.OptimizerConfig(**GOLDEN_OPT))
        state = ref_opt.init(tcfg.optimizer, params)
        step = jax.jit(ref_make_train_step(model, tcfg))
        data = golden_data(cfg, seed)
        context = golden_context(cfg)
        steps = []
        with mock.patch.object(jax.lax, "top_k", recording):  # traced on the first step
            for i in range(GOLDEN_STEPS):
                batch = jax.tree.map(jnp.asarray, {**data.batch(i), **context})
                params, state, m = step(params, state, batch)
                steps.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
            jax.effects_barrier()
        record_ = dict(name=name, config=dataclasses.asdict(cfg), weight_seed=seed,
                       data_seed=100 + seed, steps=steps,
                       leaves=leaf_stats(jax.tree.map(np.asarray, params), init))
        if context:
            record_["context_seed"] = CONTEXT_SEED
        if cfg.n_experts:
            assert gaps, name
            record_["router_min_gap"] = min(gaps)
        if name in CARD_ONLY:
            record_["card_only"] = True
        if name in GOLDEN_TOL_OVERRIDES:
            record_["tolerance"] = GOLDEN_TOL_OVERRIDES[name]
        records.append(record_)
        print(name, steps, record_.get("router_min_gap", ""), flush=True)
        del model, params, state, step
    GOLDEN_PATH.parent.mkdir(parents=True, exist_ok=True)
    GOLDEN_PATH.write_text(json.dumps(dict(
        tolerance=GOLDEN_TOL, optimizer=GOLDEN_OPT, batch=GOLDEN_BATCH, seq=GOLDEN_SEQ,
        configs=records), indent=1) + "\n")


def _golden() -> dict:
    return json.loads(GOLDEN_PATH.read_text())


# ---------------- the loss and its gradients ----------------------------------


@pytest.fixture(scope="module")
def carried():
    cfg = get_arch("qwen3_0_6b").reduced()
    tree = lm_params_numpy(cfg, 3)
    ref = RefModel(ref_config(cfg))
    params = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32),
             "mask": (rng.random((2, 24)) < 0.7).astype(np.float32)}
    return cfg, tree, ref, params, batch


def _port(cfg, tree) -> Model:
    return load_lm_params(Model(cfg, device="cpu"), tree)


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_grads_match_reference(carried, masked):
    cfg, tree, ref, params, batch = carried
    if not masked:
        batch = {k: v for k, v in batch.items() if k != "mask"}
    jbatch = jax.tree.map(jnp.asarray, batch)
    (want, wmet), wgrads = jax.jit(jax.value_and_grad(ref.loss, has_aux=True))(params, jbatch)
    port = _port(cfg, tree)
    loss, met = port.loss(_torch_batch(batch))
    assert loss.dtype == torch.float32 and loss.requires_grad
    np.testing.assert_allclose(loss.item(), float(want), rtol=LOSS_RTOL)
    np.testing.assert_allclose(met["ce"].item(), float(wmet["ce"]), rtol=LOSS_RTOL)
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad(loss, list(port.parameters()))
    got = lm_params_to_numpy(port, dict(zip(names, grads)))
    assert jax.tree.structure(got) == jax.tree.structure(wgrads)
    for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree.leaves(wgrads)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_softmax_xent_matches_reference():
    from repro.models.layers import softmax_xent as ref_xent
    from repro_torch.models.layers import softmax_xent

    rng = np.random.default_rng(2)
    logits = (3 * rng.standard_normal((2, 5, 40))).astype(np.float32)
    labels = rng.integers(0, 40, (2, 5)).astype(np.int32)
    for mask in (None, (rng.random((2, 5)) < 0.5).astype(np.float32),
                 np.zeros((2, 5), np.float32)):
        got = softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels),
                           None if mask is None else torch.from_numpy(mask))
        want = ref_xent(jnp.asarray(logits), jnp.asarray(labels),
                        None if mask is None else jnp.asarray(mask))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)
    bf16 = torch.from_numpy(logits).to(torch.bfloat16)
    assert softmax_xent(bf16, torch.from_numpy(labels)).dtype == torch.float32


def _backward_mms(loss, params) -> tuple:
    """The gradients of ``loss`` and the weight matmuls (``aten.mm``) the
    backward pass ran, remat's recompute included (a dispatch mode outside
    the checkpoint's own, so a matmul that remat serves from what it saved
    is not counted)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMM(TorchDispatchMode):
        count = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.mm.default:
                CountMM.count += 1
            return func(*args, **(kwargs or {}))

    with CountMM():
        grads = torch.autograd.grad(loss, params)
    return grads, CountMM.count


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_policies_give_equal_loss_and_grads(carried, policy):
    """Equal losses and gradients with remat off and on; "full" recomputes
    the forward pass's weight matmuls in the backward pass (all but each
    layer's last, ``mlp.wo``, whose output no backward needs: the
    checkpoint stops recomputing there), "dots" saves them and recomputes
    none."""
    cfg, tree, _, _, batch = carried
    results = []
    for c in (dataclasses.replace(cfg, remat=False),
              dataclasses.replace(cfg, remat=True, remat_policy=policy)):
        port = _port(c, tree)
        loss, _ = port.loss(_torch_batch(batch))
        results.append((loss, *_backward_mms(loss, list(port.parameters()))))
    (l0, g0, mm0), (l1, g1, mm1) = results
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    recomputed = mm1 - mm0  # a layer: wq wk wv attn.wo wg wi (not mlp.wo)
    assert recomputed == (6 * cfg.n_layers if policy == "full" else 0), (mm0, mm1)


def test_forward_matches_train_forward(carried):
    cfg, tree, _, _, batch = carried
    port = _port(cfg, tree)
    tb = _torch_batch(batch)
    served = port.forward(tb)  # through the attention kernel's plain version
    trained = port.train_forward(tb)
    assert not served.requires_grad and trained.requires_grad
    torch.testing.assert_close(served, trained.detach(), rtol=1e-5, atol=1e-5)


def test_blocked_sdpa_matches_reference(monkeypatch):
    rng = np.random.default_rng(3)
    b, s, nq, nkv, hd, chunk = 1, 256, 4, 2, 32, 64
    q, k, v = (rng.standard_normal((b, s, h, hd)).astype(np.float32)
               for h in (nq, nkv, nkv))
    for causal in (True, False):
        got = attention._blocked_sdpa(*map(torch.from_numpy, (q, k, v)), causal, q_chunk=chunk)
        want = ref_attention._blocked_sdpa(*map(jnp.asarray, (q, k, v)), causal, q_chunk=chunk)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
        mask = attention.causal_mask(s, s) if causal else None
        whole = attention._sdpa(*map(torch.from_numpy, (q, k, v)), mask)
        torch.testing.assert_close(got, whole, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="multiple of the query chunk"):
        attention._blocked_sdpa(*map(torch.from_numpy, (q[:, :200], k[:, :200], v[:, :200])),
                                True, q_chunk=chunk)

    # training attention takes the blocked form above the threshold (here
    # lowered, with the chunk, in both packages), and differentiates it
    cfg = get_arch("qwen3_0_6b").reduced()
    tree = lm_params_numpy(cfg, 4)
    port = _port(cfg, tree)
    for mod in (attention, ref_attention):
        monkeypatch.setattr(mod, "BLOCKED_ATTN_THRESHOLD", 512)
    calls = []
    blocked = attention._blocked_sdpa
    monkeypatch.setattr(attention, "_blocked_sdpa",
                        lambda *a, **kw: calls.append(a[0].shape) or blocked(*a, **kw))
    x = (0.5 * rng.standard_normal((1, 1024, cfg.d_model))).astype(np.float32)
    p = port.blocks[0].attn
    got = attention.train_self_attention(p, cfg, torch.from_numpy(x))
    assert calls == [(1, 1024, cfg.n_heads, cfg.head_dim)]
    ref_p = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["blocks"][0]["attn"])
    want = ref_attention.self_attention(ref_p, ref_config(cfg), jnp.asarray(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    got.sum().backward()
    assert p.wq.grad is not None and torch.isfinite(p.wq.grad).all()


# ---------------- whole train steps -------------------------------------------


def _close_where_grads_are_large(got: dict, want: dict, keep: dict) -> None:
    kept = total = 0
    for (path, g), w, m in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                               jax.tree.leaves(want), jax.tree.leaves(keep)):
        w = np.asarray(w)
        np.testing.assert_allclose(g[m], w[m], rtol=STEP_TOL, atol=STEP_TOL,
                                   err_msg=jax.tree_util.keystr(path))
        kept, total = kept + int(m.sum()), total + m.size
    assert kept >= 0.99 * total, f"only {kept} of {total} elements compared"


@pytest.mark.parametrize("micro_steps,n_steps", [(1, 3), (2, 2)])
def test_train_steps_match_reference(micro_steps, n_steps):
    cfg = get_arch("qwen3_0_6b").reduced()
    tree = lm_params_numpy(cfg, 5)
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=4)
    ref = RefModel(ref_config(cfg))
    rtcfg = RefTrainConfig(optimizer=ref_opt.OptimizerConfig(**ocfg), micro_steps=micro_steps)
    params = jax.tree.map(jnp.asarray, tree)
    rstate = ref_opt.init(rtcfg.optimizer, params)
    rstep = jax.jit(ref_make_train_step(ref, rtcfg))
    rgrad = jax.jit(jax.grad(lambda p, b: ref.loss(p, b)[0]))

    port = _port(cfg, tree)
    tcfg = TrainConfig(optimizer=opt.OptimizerConfig(**ocfg), micro_steps=micro_steps)
    state = opt.init(tcfg.optimizer, dict(port.named_parameters()))
    step = make_train_step(port, tcfg)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, global_batch=4, seq_len=32, seed=9))
    keep = jax.tree.map(lambda a: np.ones(a.shape, bool), tree)
    for i in range(n_steps):
        batch = data.batch(i)
        g = rgrad(params, jax.tree.map(jnp.asarray, batch))  # the full batch's gradient
        keep = jax.tree.map(lambda m, g: m & (np.abs(np.asarray(g)) > GRAD_FLOOR), keep, g)
        params, rstate, want = rstep(params, rstate, jax.tree.map(jnp.asarray, batch))
        state, got = step(state, batch)
        assert set(got) == set(want)
        for key in ("moe_lb_loss", "moe_z_loss"):  # dense: zeros in both
            assert key not in got or float(got[key]) == float(want[key]) == 0
        for key in got:
            np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=STEP_TOL,
                                       err_msg=f"step {i}: {key}")
    assert int(state["step"]) == int(rstate["step"]) == n_steps
    _close_where_grads_are_large(lm_params_to_numpy(port), params, keep)
    for moment in ("m", "v"):
        _close_where_grads_are_large(lm_params_to_numpy(port, state[moment]),
                                     rstate[moment], keep)


# ---------------- goldens -----------------------------------------------------


def test_golden_file_covers_the_configurations():
    golden = _golden()
    assert golden["tolerance"] == GOLDEN_TOL and golden["optimizer"] == GOLDEN_OPT
    assert [g["name"] for g in golden["configs"]] == [n for n, _, _ in golden_configs()]
    assert {n.split(".")[0] for n, _, _ in golden_configs()} == {"qwen3_0_6b", *FAMILIES}
    for (name, cfg, seed), g in zip(golden_configs(), golden["configs"]):
        assert g["config"] == dataclasses.asdict(cfg) and g["weight_seed"] == seed
        assert len(g["steps"]) == GOLDEN_STEPS
        assert g.get("card_only", False) == (name in CARD_ONLY)
        assert g.get("tolerance") == GOLDEN_TOL_OVERRIDES.get(name)
        # the stub inputs' seed where the config needs them, and only there
        assert g.get("context_seed") == (CONTEXT_SEED if golden_context(cfg) else None), name
        assert ("router_min_gap" in g) == bool(cfg.n_experts), name
        assert g.get("router_min_gap", 1.0) > 0, name  # no exact tie among the k-th choices
        if name in CARD_ONLY:  # its leaves: the layer's, without drawing 2.3 GB here
            assert any(".moe.wg" in key for key in g["leaves"])
            continue
        assert set(g["leaves"]) == set(leaf_stats(lm_params_numpy(cfg, seed),
                                                  lm_params_numpy(cfg, seed)))


def check_train_golden(g: dict, tol: dict, device) -> dict:
    """Train the port as the golden ``g`` says on ``device`` and hold it to
    the file; returns the largest relative error of each quantity."""
    cfg = ArchConfig(**g["config"])
    init = lm_params_numpy(cfg, g["weight_seed"])
    model = load_lm_params(Model(cfg, device=device), init)
    tcfg = TrainConfig(optimizer=opt.OptimizerConfig(**GOLDEN_OPT))
    state = opt.init(tcfg.optimizer, dict(model.named_parameters()))
    step = make_train_step(model, tcfg)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, global_batch=GOLDEN_BATCH,
                                  seq_len=GOLDEN_SEQ, seed=g["data_seed"]))
    context = (context_inputs_numpy(cfg, GOLDEN_BATCH, g["context_seed"])
               if "context_seed" in g else {})
    worst = dict.fromkeys(("loss", "grad_norm", "lr"), 0.0)
    for i, want in enumerate(g["steps"]):
        state, got = step(state, {**data.batch(i), **context})
        for key in worst:
            err = abs(float(got[key]) - want[key]) / abs(want[key])
            worst[key] = max(worst[key], err)
    assert worst["loss"] <= tol["loss_rtol"], worst
    assert worst["grad_norm"] <= tol["grad_norm_rtol"], worst
    assert worst["lr"] <= 1e-6, worst
    stats = leaf_stats(lm_params_to_numpy(model), init)
    for key, want in g["leaves"].items():
        got = stats[key]
        assert abs(got["norm"] - want["norm"]) <= tol["norm_rtol"] * want["norm"], key
        assert abs(got["sum"] - want["sum"]) <= tol["sum_abs_frac"] * want["abs_sum"], key
        assert abs(got["delta_norm"] - want["delta_norm"]) <= \
            tol["delta_norm_rtol"] * want["delta_norm"], key
    return worst


@pytest.mark.parametrize("name", [name for name, _, _ in golden_configs()
                                  if name not in CARD_ONLY])
def test_port_matches_train_golden(name):
    golden = _golden()
    g = next(g for g in golden["configs"] if g["name"] == name)
    check_train_golden(g, {**golden["tolerance"], **g.get("tolerance", {})}, "cpu")


# ---------------- supervision and the launcher --------------------------------


def test_supervised_training_survives_injected_failures(tmp_path):
    """The twin of tests/test_substrate.py's: failures at steps 7 and 13,
    recovery from checkpoints, parameters bit-equal to a clean run."""
    cfg = get_arch("qwen3_0_6b").reduced()
    tcfg = TrainConfig(optimizer=opt.OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=30))
    src = SyntheticLM(DataConfig(vocab=cfg.vocab, global_batch=2, seq_len=16))

    def run(directory, fail_at=None):
        model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        state = opt.init(tcfg.optimizer, dict(model.named_parameters()))
        return run_supervised(
            train_step=make_train_step(model, tcfg), params=model, opt_state=state,
            data_source=src, n_steps=20, ckpt=Checkpointer(str(directory), keep=2),
            cfg=SupervisorConfig(checkpoint_every=5, async_checkpoint=False),
            fail_at=fail_at, log_every=0, log=lambda s: None)

    failures = {7, 13}

    def fail_at(step):
        if step in failures:
            failures.discard(step)
            return True
        return False

    model, state, history = run(tmp_path / "faults", fail_at)
    steps = [s for s, _ in history]
    assert not failures and steps[-1] == 20
    assert set(range(1, 21)).issubset(set(steps))  # steps may repeat, never skip
    assert steps.count(6) == 2 and steps.count(11) == 2  # redone from steps 5 and 10
    clean, cstate, _ = run(tmp_path / "clean")
    for (name, a), b in zip(model.named_parameters(), clean.parameters()):
        assert torch.equal(a, b), name
    assert int(state["step"]) == int(cstate["step"]) == 20
    for moment in ("m", "v"):
        for name, a in state[moment].items():
            assert torch.equal(a, cstate[moment][name]), (moment, name)


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    rc = launch_train.main(["--reduced", "--device", "cpu", "--steps", "30", "--batch", "4",
                            "--seq", "64", "--lr", "2e-2", "--ckpt-every", "10",
                            "--ckpt-dir", str(tmp_path / "ckpt")])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "arch=qwen3_0_6b" in out and "device=cpu" in out
    done = [line for line in out.splitlines() if line.startswith("done: 30 steps")]
    assert done, out
    first, last = (float(x) for x in done[0].rsplit("loss ", 1)[1].split(" -> "))
    assert last < first - 0.5, done[0]
    assert Checkpointer(str(tmp_path / "ckpt")).all_steps() == [20, 30]
    # a second run resumes at the end and has nothing to do
    assert launch_train.main(["--reduced", "--device", "cpu", "--steps", "30",
                              "--ckpt-dir", str(tmp_path / "ckpt")]) == 0
    assert "nothing to run" in capsys.readouterr().out


def test_launcher_without_a_card_exits_2(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert launch_train.main(["--reduced", "--steps", "1",
                              "--ckpt-dir", str(tmp_path)]) == 2
    assert capsys.readouterr().err.startswith("error: ")
    for arch, key in (("whisper_small", "enc_frames"), ("llama3_2_vision_90b", "img_embeds")):
        assert launch_train.main(["--arch", arch, "--reduced", "--device", "cpu",
                                  "--ckpt-dir", str(tmp_path)]) == 2
        err = capsys.readouterr().err
        assert err.startswith("error: ") and repr(key) in err, err


def test_launcher_trains_a_moe_config_on_the_cpu(tmp_path, capsys):
    rc = launch_train.main(["--arch", "qwen2_moe_a2_7b", "--reduced", "--device", "cpu",
                            "--steps", "4", "--batch", "2", "--seq", "32",
                            "--ckpt-dir", str(tmp_path / "ckpt")])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "arch=qwen2_moe_a2_7b" in out and "done: 4 steps" in out
    aux = [line for line in out.splitlines() if line.startswith("moe aux, last step:")]
    assert aux, out
    lb, z = (float(aux[0].split(key)[1].split()[0]) for key in ("moe_lb_loss", "moe_z_loss"))
    assert 0.5 < lb < 8 and 0 < z, aux[0]  # E * sum(frac_tokens * frac_probs) ~ k


def test_launcher_trains_rwkv6_on_the_cpu(tmp_path, capsys):
    """The SSM family through the launcher: the per-token rwkv scan under
    autograd and remat learns (a falling loss)."""
    rc = launch_train.main(["--arch", "rwkv6_1_6b", "--reduced", "--device", "cpu",
                            "--steps", "30", "--batch", "4", "--seq", "64", "--lr", "2e-2",
                            "--ckpt-dir", str(tmp_path / "ckpt")])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "arch=rwkv6_1_6b" in out and "moe aux" not in out
    done = [line for line in out.splitlines() if line.startswith("done: 30 steps")]
    assert done, out
    first, last = (float(x) for x in done[0].rsplit("loss ", 1)[1].split(" -> "))
    assert last < first - 0.5, done[0]


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: PYTHONPATH=src python tests/test_torch_train.py --write")
    write_golden()
