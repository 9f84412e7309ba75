"""The port's training substrate against the JAX package's: the optimizer,
the data pipeline and the checkpointer, and serving with trainable weights.

- ``optimizer.update`` given the same gradients, moments and step gives
  the reference's parameters at rtol/atol 1e-6 and moments at rtol 1e-6,
  atol 1e-8 (XLA may fuse ``b1 * m + (1 - b1) * g`` into one rounding, and
  m is a difference of terms ~1e-2), or with bf16 moments, moments within
  two bf16 roundings: a one-ulp f32 difference can round m to the next bf16
  value, the next update carries that and may round apart again, and it
  moves that parameter by about ``lr * 2**-8 * |update|``, so
  there at most 0.1% of the parameters may differ beyond 1e-6, by at most
  ``lr * 2**-5``.  ``schedule`` equals the
  reference's at the warm-up and cosine steps; clipping scales as the
  reference's; the decay mask agrees on every name of the model.
- ``SyntheticLM``, ``MemmapCorpus`` and ``Prefetcher`` batches are bit-equal
  to the reference's.
- Checkpoints: a bf16 round trip is bit-equal (the reference's restore
  reads the port's file too); gc and ``latest_step`` behave as the
  reference's; an async save is unaffected by a later in-place step; a
  partial ``.tmp`` directory is ignored.
- Serving builds no autograd graph although the weights now require grad,
  and the serve goldens still hold.  The attention kernel's refusal to be
  differentiated is on its CUDA branch, which ``chip_smoke.py`` reaches;
  here the plain version on the CPU still takes a gradient.
"""
from __future__ import annotations

import base64
import dataclasses
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import data as ref_data
from repro.train import optimizer as ref_opt
from repro.train.checkpoint import Checkpointer as RefCheckpointer
from repro_torch.configs.base import ArchConfig, get_arch
from repro_torch.interop import (
    lm_params_numpy,
    lm_params_to_numpy,
    load_lm_params,
    load_opt_state,
)
from repro_torch.kernels.attention import attention_plain
from repro_torch.models import Model
from repro_torch.models.attention import _sdpa, causal_mask
from repro_torch.serve.legacy.engine import Request, ServeEngine
from repro_torch.train import data
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.fault_tolerance import StragglerMonitor

ROOT = Path(__file__).resolve().parent.parent
UPDATE_TOL = 1e-6  # f32 AdamW on equal inputs: pow, sqrt and divide may round apart
MOMENT_ATOL = 1e-8  # moments: one rounding of terms up to ~0.1


# ---------------- optimizer ---------------------------------------------------


def _tree_allclose(got: dict, want, rtol: float, atol: float, what: str) -> None:
    flat_got, flat_want = jax.tree_util.tree_flatten_with_path(got)[0], jax.tree.leaves(want)
    assert len(flat_got) == len(flat_want)
    for (path, g), w in zip(flat_got, flat_want):
        np.testing.assert_allclose(np.asarray(g, np.float32), np.asarray(w, np.float32),
                                   rtol=rtol, atol=atol,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _bf16_step(a) -> np.ndarray:
    """The spacing of bf16 at each element of ``a`` (one rounding's worth)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(a), 1e-30))) - 7)


@pytest.mark.parametrize("moment_dtype,aggressive,clip", [
    ("float32", False, 1.0), ("float32", False, 1e6), ("bfloat16", False, 1.0),
    ("bfloat16", True, 1.0)])
def test_update_matches_reference(moment_dtype, aggressive, clip):
    """Three updates from the same params, gradients, moments and step."""
    cfg = get_arch("qwen3_0_6b").reduced()
    tree = lm_params_numpy(cfg, 11)
    model = load_lm_params(Model(cfg, device="cpu"), tree)
    names = [n for n, _ in model.named_parameters()]
    ocfg = dict(lr=2e-3, warmup_steps=2, total_steps=6, clip_norm=clip,
                moment_dtype=moment_dtype, aggressive=aggressive)
    params = jax.tree.map(jnp.asarray, tree)
    rstate = ref_opt.init(ref_opt.OptimizerConfig(**ocfg), params)
    state = opt.init(opt.OptimizerConfig(**ocfg), dict(model.named_parameters()))
    rng = np.random.default_rng(12)
    # start from non-zero moments at step 2, carried into the port
    rstate = dict(rstate, step=jnp.int32(2),
                  m=jax.tree.map(lambda a: (0.01 * rng.standard_normal(a.shape)).astype(a.dtype),
                                 rstate["m"]),
                  v=jax.tree.map(lambda a: (1e-4 * rng.random(a.shape)).astype(a.dtype),
                                 rstate["v"]))
    load_opt_state(model, state, jax.tree.map(np.asarray, rstate))
    assert state["m"][names[0]].dtype == getattr(torch, moment_dtype)
    assert state["v"][names[0]].dtype == (torch.bfloat16 if aggressive else torch.float32)
    update = jax.jit(lambda g, s, p: ref_opt.update(ref_opt.OptimizerConfig(**ocfg), g, s, p))
    for i in range(3):
        grads = jax.tree.map(lambda a: (0.05 * rng.standard_normal(a.shape)).astype(np.float32),
                             tree)
        params, rstate, want = update(jax.tree.map(jnp.asarray, grads), rstate, params)
        tgrads = {n: torch.empty_like(p) for n, p in model.named_parameters()}
        load_lm_params(model, grads, tgrads)
        state, got = opt.update(opt.OptimizerConfig(**ocfg), tgrads, state,
                                dict(model.named_parameters()))
        np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(got["lr"]), float(want["lr"]), rtol=1e-7)
        assert int(state["step"]) == int(rstate["step"]) == 3 + i
    assert (float(want["grad_norm"]) > clip) == (clip == 1.0)  # clipping on / off
    got = lm_params_to_numpy(model)
    if moment_dtype == "float32":
        _tree_allclose(got, params, UPDATE_TOL, UPDATE_TOL, "params")
    else:
        apart = total = 0
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
            d = np.abs(g - np.asarray(w))
            assert d.max() <= ocfg["lr"] * 2**-5, d.max()
            apart, total = apart + int((d > UPDATE_TOL + UPDATE_TOL * np.abs(g)).sum()), total + d.size
        assert apart <= 1e-3 * total, (apart, total)
    for key in ("m", "v"):
        got = lm_params_to_numpy(model, state[key])
        if moment_dtype == "bfloat16" and (key == "m" or aggressive):
            for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(rstate[key])):
                g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
                step = _bf16_step(np.maximum(np.abs(g), np.abs(w)))  # the wider binade's
                assert np.all(np.abs(g - w) <= 2 * step), key
        else:
            _tree_allclose(got, rstate[key], UPDATE_TOL, MOMENT_ATOL, key)


def test_schedule_matches_reference():
    for kw in (dict(lr=3e-4, warmup_steps=100, total_steps=10_000),
               dict(lr=1e-2, warmup_steps=0, total_steps=50, min_lr_frac=0.0),
               dict(lr=1e-3, warmup_steps=5, total_steps=5)):
        for step in (0, 1, 3, 5, 50, 99, 100, 101, 2_500, 9_999, 10_000, 20_000):
            got = opt.schedule(opt.OptimizerConfig(**kw), torch.tensor(step, dtype=torch.int32))
            want = ref_opt.schedule(ref_opt.OptimizerConfig(**kw), jnp.int32(step))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6, err_msg=f"{kw} {step}")


def test_clipping_scales_the_update():
    """With a tiny clip norm the first step's update is the same (Adam is
    scale-free) but the moments are scaled by clip / ||g||."""
    w = torch.nn.Parameter(torch.zeros(4))
    g = {"w": torch.tensor([3.0, 4.0, 0.0, 0.0])}  # norm 5
    for clip, scale in ((1.0, 0.2), (10.0, 1.0)):
        ocfg = opt.OptimizerConfig(lr=0.1, warmup_steps=0, weight_decay=0.0, clip_norm=clip)
        state = opt.init(ocfg, {"w": w})
        state, m = opt.update(ocfg, g, state, {"w": w})
        assert float(m["grad_norm"]) == 5.0
        torch.testing.assert_close(state["m"]["w"], 0.1 * scale * g["w"])
        ref_state = ref_opt.init(ref_opt.OptimizerConfig(**dataclasses.asdict(ocfg)),
                                 {"w": jnp.zeros(4)})
        _, ref_state, _ = ref_opt.update(ref_opt.OptimizerConfig(**dataclasses.asdict(ocfg)),
                                         {"w": jnp.asarray(g["w"].numpy())}, ref_state,
                                         {"w": jnp.zeros(4)})
        np.testing.assert_allclose(state["m"]["w"].numpy(), np.asarray(ref_state["m"]["w"]),
                                   rtol=1e-6)
        with torch.no_grad():
            w.zero_()


@pytest.mark.parametrize("moment_dtype,aggressive", [("float32", False), ("bfloat16", False),
                                                     ("bfloat16", True)])
def test_update_in_slices_is_bit_equal(moment_dtype, aggressive, monkeypatch):
    """A leaf updated in slices of ``UPDATE_CHUNK`` elements (a last slice
    shorter, a transposed gradient) gives the numbers of one pass over it."""
    rng = np.random.default_rng(13)
    shapes = {"blocks.0.moe.wg": (3, 16, 7), "blocks.0.norm1.scale": (16,)}
    ocfg = opt.OptimizerConfig(lr=1e-2, warmup_steps=0, moment_dtype=moment_dtype,
                               aggressive=aggressive)
    runs = []
    for chunk in (1 << 26, 100):
        monkeypatch.setattr(opt, "UPDATE_CHUNK", chunk)
        params = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
            torch.bfloat16) for n, s in shapes.items()}
        state = opt.init(ocfg, params)
        for i in range(3):
            rng_i = np.random.default_rng(20 + i)
            grads = {n: torch.from_numpy(rng_i.standard_normal(s[::-1]).astype(np.float32)).to(
                torch.bfloat16).permute(*range(len(s) - 1, -1, -1)) for n, s in shapes.items()}
            state, _ = opt.update(ocfg, grads, state, params)
        runs.append((params, state))
        rng = np.random.default_rng(13)
    (p0, s0), (p1, s1) = runs
    for n in shapes:
        assert torch.equal(p0[n], p1[n]) and not torch.equal(p0[n], p0[n] * 0), n
        for key in ("m", "v"):
            assert torch.equal(s0[key][n], s1[key][n]), (key, n)


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "qwen2_7b", "minitron_8b", "qwen2_moe_a2_7b",
                                  "arctic_480b", "jamba_v0_1_52b", "rwkv6_1_6b"])
def test_decay_mask_agrees_on_every_name(arch):
    """The port's mask on its dotted names equals the reference's on the
    same leaves' paths (qkv biases, qk norms, untied heads, the router,
    the SSM decays and mixes)."""
    cfg = get_arch(arch).reduced()
    model = Model(cfg, device="cpu")
    tree = lm_params_numpy(cfg, 0)
    period = len(tree["blocks"])
    want = {}
    for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = ".".join(str(getattr(p, "key", getattr(p, "idx", None))) for p in path)
        want[key] = ref_opt._decay_mask(path)
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":  # layer li is period position li % period
            parts[1] = str(int(parts[1]) % period)
        key = ".".join(parts)
        assert opt._decay_mask(name) == want[key], name
    decayed = {n.rsplit(".", 1)[-1] for n, _ in model.named_parameters() if opt._decay_mask(n)}
    assert "tok" in decayed and not decayed & {"scale", "bq", "bk", "bv"}
    assert "wq" in decayed or cfg.family == "ssm"  # rwkv has no attention


# ---------------- data --------------------------------------------------------


def test_synthetic_and_memmap_batches_equal_the_reference(tmp_path):
    cfg = dict(vocab=1000, global_batch=4, seq_len=32, seed=5)
    got, want = data.SyntheticLM(data.DataConfig(**cfg)), ref_data.SyntheticLM(
        ref_data.DataConfig(**cfg))
    for step in (0, 1, 17):
        for k, v in want.batch(step).items():
            np.testing.assert_array_equal(got.batch(step)[k], v)
            assert got.batch(step)[k].dtype == v.dtype
    path = tmp_path / "corpus.bin"
    np.random.default_rng(0).integers(0, 1000, 5000).astype(np.int32).tofile(path)
    mcfg = dict(cfg, kind="memmap", path=str(path))
    got, want = data.make_source(data.DataConfig(**mcfg)), ref_data.make_source(
        ref_data.DataConfig(**mcfg))
    assert isinstance(got, data.MemmapCorpus)
    for step in (0, 3):
        for k, v in want.batch(step).items():
            np.testing.assert_array_equal(got.batch(step)[k], v)
    with pytest.raises(ValueError, match="needs a path"):
        data.MemmapCorpus(data.DataConfig(**cfg))


def test_prefetcher_yields_the_reference_sequence():
    cfg = dict(vocab=500, global_batch=2, seq_len=8, seed=3)
    pf = data.Prefetcher(data.SyntheticLM(data.DataConfig(**cfg)), start_step=4, depth=2)
    try:
        want = ref_data.SyntheticLM(ref_data.DataConfig(**cfg))
        for i in range(4, 9):
            step, batch = next(pf)
            assert step == i
            np.testing.assert_array_equal(batch["tokens"], want.batch(i)["tokens"])
    finally:
        pf.close()
    assert not pf._thread.is_alive()


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(window=16, threshold=6.0)
    flagged = [s for s in range(30)
               if mon.record(s, 2.0 if s == 25 else 0.1 + 0.001 * (s % 3))]
    assert flagged == [25]


# ---------------- checkpoints -------------------------------------------------


def test_checkpoint_bf16_round_trip_is_bit_equal(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"w": torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
            .to(torch.bfloat16),
            "b": torch.from_numpy(rng.standard_normal(7).astype(np.float32)),
            "step": torch.tensor(5, dtype=torch.int32)}
    ck = Checkpointer(str(tmp_path), keep=2)
    ck.save(10, tree)
    manifest = json.loads((tmp_path / "step_00000010" / "manifest.json").read_text())
    assert manifest["keys"]["w"] == {"dtype": "bfloat16", "shape": [64, 32]}
    assert ck.last_save["bytes"] == 64 * 32 * 2 + 7 * 4 + 4
    target = {k: torch.zeros_like(v) for k, v in tree.items()}
    restored, step = ck.restore(target)
    assert step == 10 and restored is target
    for k, v in tree.items():
        assert target[k].dtype == v.dtype and target[k].shape == v.shape
        assert torch.equal(target[k].view(torch.int16) if v.dtype == torch.bfloat16
                           else target[k], v.view(torch.int16) if v.dtype == torch.bfloat16
                           else v), k
    # the reference's restore reads the port's file (its layout and dtypes)
    ref_tree, ref_step = RefCheckpointer(str(tmp_path)).restore(
        {k: jnp.zeros(v.shape, jnp.bfloat16 if v.dtype == torch.bfloat16 else
                      {torch.float32: jnp.float32, torch.int32: jnp.int32}[v.dtype])
         for k, v in tree.items()})
    assert ref_step == 10
    np.testing.assert_array_equal(np.asarray(ref_tree["w"]).view(np.uint16),
                                  tree["w"].view(torch.int16).numpy().view(np.uint16))
    with pytest.raises(ValueError, match="shape"):
        ck.restore({"w": torch.zeros(3), "b": target["b"], "step": target["step"]})
    with pytest.raises(KeyError, match="missing"):
        ck.restore({"other": torch.zeros(3)})


def test_checkpoint_gc_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    assert ck.latest_step() is None
    for s in (1, 2, 3, 4):
        ck.save(s, {"x": torch.tensor(float(s))})
    assert ck.all_steps() == [3, 4] and ck.latest_step() == 4
    (restored, step) = ck.restore({"x": torch.tensor(0.0)})
    assert step == 4 and float(restored["x"]) == 4.0
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore({"x": torch.tensor(0.0)})


def test_async_save_is_unaffected_by_a_later_in_place_step(tmp_path):
    model = Model(get_arch("qwen3_0_6b").reduced(), device="cpu")
    model.init(torch.Generator().manual_seed(0))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    ck = Checkpointer(str(tmp_path), keep=1)
    ck.save_async(7, (model, {"step": torch.tensor(7, dtype=torch.int32)}))
    with torch.no_grad():  # the next step, updating the live weights in place
        for p in model.parameters():
            p.add_(1.0)
    ck.wait()
    restored, step = ck.restore((model, {"step": torch.tensor(0, dtype=torch.int32)}))
    assert step == 7 and int(restored[1]["step"]) == 7
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]), n


def test_checkpoint_ignores_partial_tmp(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3)
    ck.save(1, {"x": torch.tensor(1.0)})
    os.makedirs(tmp_path / "step_00000002.tmp")  # simulated crashed save
    assert ck.latest_step() == 1
    ck.save(3, {"x": torch.tensor(3.0)})  # gc drops the stale tmp
    assert not (tmp_path / "step_00000002.tmp").exists() and ck.all_steps() == [1, 3]


# ---------------- serving with trainable weights ------------------------------


@pytest.fixture(scope="module")
def serve_golden() -> dict:
    return json.loads((ROOT / "tests" / "data" / "torch_golden_serve.json").read_text())


@pytest.mark.parametrize("index", [0, 1])
def test_serving_builds_no_graph_and_keeps_its_goldens(serve_golden, index):
    """The serve goldens (tests/test_torch_serve.py) with weights that now
    require grad: teacher-forced logits within the file's tolerance, and no
    output of prefill, decode_step, forward or the engine in a graph."""
    g = serve_golden["configs"][index]
    tol = serve_golden["tolerance"]
    cfg = ArchConfig(**g["config"])
    model = load_lm_params(Model(cfg, device="cpu"), lm_params_numpy(cfg, g["weight_seed"]))
    assert all(p.requires_grad for p in model.parameters())
    prompts = np.asarray(g["prompts"], np.int32)
    tokens = np.asarray(g["tokens"], np.int32)
    want = np.frombuffer(base64.b64decode(g["logits_f32_b64"]),
                         np.float32).reshape(g["logits_shape"])
    n, max_new = tokens.shape
    s = prompts.shape[1]
    cache = model.init_cache(n, s + max_new)
    logits, cache = model.prefill({"tokens": torch.from_numpy(prompts)}, cache)
    for step in range(max_new):
        assert not logits.requires_grad and logits.grad_fn is None
        assert not any(c["k"].requires_grad for c in cache["blocks"])
        np.testing.assert_allclose(logits[:, -1, : cfg.vocab].numpy(), want[:, step],
                                   rtol=tol, atol=tol, err_msg=f"step {step}")
        if step + 1 < max_new:
            logits, cache = model.decode_step(torch.from_numpy(tokens[:, step:step + 1]),
                                              cache, s + step)
    assert not model.forward({"tokens": torch.from_numpy(prompts[:, :16])}).requires_grad
    engine = ServeEngine(model, batch=n, max_seq=s + max_new)
    seen = []
    prefill = engine.prefill
    engine.prefill = lambda *a: seen.append(prefill(*a)) or seen[-1]
    engine.run([Request(rid=i, prompt=p, max_new=2) for i, p in enumerate(prompts)])
    assert seen and not seen[0][0].requires_grad


def test_attention_plain_takes_a_gradient_on_the_cpu():
    """The kernel's plain version (what ``attention_fwd`` runs on a CPU
    tensor) differentiates, and its gradient is ``_sdpa``'s."""
    rng = np.random.default_rng(8)
    q0, k0, v0 = (torch.from_numpy(rng.standard_normal((1, 20, h, 32)).astype(np.float32))
                  for h in (4, 2, 2))
    grads = []
    for fn in (lambda q, k, v: attention_plain(q, k, v, causal=True).reshape(1, 20, 128),
               lambda q, k, v: _sdpa(q, k, v, causal_mask(20, 20))):
        q, k, v = (t.clone().requires_grad_() for t in (q0, k0, v0))
        fn(q, k, v).square().sum().backward()
        grads.append((q.grad, k.grad, v.grad))
    for a, b in zip(*grads):
        assert a is not None and torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
