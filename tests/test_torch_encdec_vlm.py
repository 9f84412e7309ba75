"""The port's encoder-decoder and vision-language families against the JAX
package.

Same numpy inputs, f32, on the CPU, within ``TOL``:

- ``cross_attention`` against ``repro.models.attention.cross_attention``:
  multi-head, grouped and multi-query heads, with ``qk_norm``, and with
  ``qkv_bias`` (whose biases the reference ignores on this path: drawn
  non-zero here, so using them would show);
- non-causal self-attention (whisper's encoder layers) at S 16 and at S
  160, which is not a multiple of the kernel's 128-row block: the serving
  path (``self_attention``, the kernel's plain version on the CPU) and the
  training path (``train_self_attention``) against the reference's
  ``self_attention(causal=False)``;
- ``layernorm``;
- the whole model of ``whisper_small`` and ``llama3_2_vision_90b`` at
  ``reduced()``, with weights from ``interop.lm_params_numpy`` carried into
  both packages and the stub front ends' inputs (``enc_frames``,
  ``img_embeds``: normal x 0.05 at model width, as
  ``tests/test_arch_smoke.py`` makes them): ``Model.forward``, ``prefill``
  + ``decode_step`` (logits and caches, ``kv_src`` included),
  ``Model.loss`` and every gradient against ``jax.value_and_grad``,
  ``Model.init``'s leaves against the reference init's, and
  ``ServeEngine.run(requests, extras)``'s tokens against the reference
  engine's;
- inside the port: decoding a token after a prefill gives the logits of
  prefilling the extended prompt and of the forward pass over it, and the
  ``enc`` tree survives ``load_lm_params`` / ``lm_params_to_numpy``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.models import Model as RefModel
from repro.models import attention as ref_attention
from repro.models import layers as ref_layers
from repro.serve.legacy.engine import Request as RefRequest
from repro.serve.legacy.engine import ServeEngine as RefServeEngine
from repro_torch.configs import base
from repro_torch.interop import (
    context_inputs_numpy,
    lm_params_numpy,
    lm_params_to_numpy,
    load_lm_params,
    tree_leaves,
)
from repro_torch.models import Model, layers
from repro_torch.models.attention import (
    Attention,
    cross_attention,
    self_attention,
    train_self_attention,
)
from repro_torch.serve.legacy.engine import Request, ServeEngine

ARCHS = ["whisper_small", "llama3_2_vision_90b"]
TOL = 1e-4  # f32: sums in another order than XLA's
GRAD_TOL = 1e-4


def _configs(arch: str, **changes):
    return (dataclasses.replace(ref_base.get_arch(arch).reduced(), **changes),
            dataclasses.replace(base.get_arch(arch).reduced(), **changes))


def _close(got: torch.Tensor, want, msg: str = "", tol: float = TOL) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=msg)


def _attention_params(cfg, seed: int):
    """One attention layer's weights as numpy (the reference's dict) and in
    the port's module; biases and norm scales away from their init."""
    rng = np.random.default_rng(seed)
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    tree = {"wq": rng.standard_normal((d, nq)) / np.sqrt(d),
            "wk": rng.standard_normal((d, nkv)) / np.sqrt(d),
            "wv": rng.standard_normal((d, nkv)) / np.sqrt(d),
            "wo": rng.standard_normal((nq, d)) / np.sqrt(nq)}
    if cfg.qkv_bias:
        tree.update(bq=rng.standard_normal(nq), bk=rng.standard_normal(nkv),
                    bv=rng.standard_normal(nkv))
    if cfg.qk_norm:
        tree.update(q_norm={"scale": 1 + 0.1 * rng.standard_normal(hd)},
                    k_norm={"scale": 1 + 0.1 * rng.standard_normal(hd)})
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    port = Attention(cfg, torch.float32, "cpu").requires_grad_(False)
    with torch.no_grad():
        for name, p in port.named_parameters():
            p.copy_(torch.from_numpy(dict(tree_leaves(tree))[name]))
    return tree, port


# ---------------- attention and layers ----------------------------------------


CROSS_CASES = {
    "mha": ("whisper_small", {}),  # 4/4 heads at reduced()
    "mqa": ("llama3_2_vision_90b", {}),  # 4/1
    "gqa": ("llama3_2_vision_90b", dict(n_kv_heads=2)),
    "gqa-qk_norm": ("llama3_2_vision_90b", dict(n_kv_heads=2, qk_norm=True)),
    "qkv_bias": ("whisper_small", dict(qkv_bias=True)),
}


@pytest.mark.parametrize("case", list(CROSS_CASES))
def test_cross_attention_matches_reference(case):
    arch, changes = CROSS_CASES[case]
    ref_cfg, cfg = _configs(arch, **changes)
    tree, port = _attention_params(cfg, seed=len(case))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    src = rng.standard_normal((2, 19, cfg.d_model)).astype(np.float32)
    want = ref_attention.cross_attention(jax.tree.map(jnp.asarray, tree), ref_cfg,
                                         jnp.asarray(x), jnp.asarray(src))
    got = cross_attention(port, cfg, torch.from_numpy(x), torch.from_numpy(src))
    assert got.shape == (2, 7, cfg.d_model)
    _close(got, want)
    if cfg.qkv_bias:  # the biases are there, and unused
        assert float(port.bq.abs().max()) > 0.5


@pytest.mark.parametrize("s", [16, 160])
def test_non_causal_self_attention_matches_reference(s):
    ref_cfg, cfg = _configs("whisper_small")
    tree, port = _attention_params(cfg, seed=s)
    x = np.random.default_rng(s).standard_normal((2, s, cfg.d_model)).astype(np.float32)
    want = ref_attention.self_attention(jax.tree.map(jnp.asarray, tree), ref_cfg,
                                        jnp.asarray(x), causal=False)
    for fn in (self_attention, train_self_attention):
        _close(fn(port, cfg, torch.from_numpy(x), causal=False), want, fn.__name__)
    # the mask matters: causal attention gives other numbers
    causal = self_attention(port, cfg, torch.from_numpy(x), causal=True)
    assert not np.allclose(causal.numpy(), np.asarray(want), atol=1e-3)


def test_layernorm_matches_reference():
    rng = np.random.default_rng(4)
    x = (3 + 2 * rng.standard_normal((2, 7, 48))).astype(np.float32)
    scale, bias = (1 + 0.1 * rng.standard_normal(48)).astype(np.float32), \
        (0.1 * rng.standard_normal(48)).astype(np.float32)
    want = ref_layers.layernorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                                jnp.asarray(x))
    got = layers.layernorm(*map(torch.from_numpy, (x, scale, bias)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    bf16 = layers.layernorm(torch.from_numpy(x).bfloat16(), *map(torch.from_numpy,
                                                                 (scale, bias)))
    assert bf16.dtype == torch.bfloat16


# ---------------- the whole model ---------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def carried(request):
    ref_cfg, cfg = _configs(request.param)
    tree = lm_params_numpy(cfg, 0)
    port = load_lm_params(Model(cfg, device="cpu"), tree)
    return ref_cfg, RefModel(ref_cfg), jax.tree.map(jnp.asarray, tree), port


def _batches(extras: dict):
    """The same stub inputs for the reference and for the port."""
    return ({k: jnp.asarray(v) for k, v in extras.items()},
            {k: torch.from_numpy(v) for k, v in extras.items()})


def test_forward_matches_reference(carried):
    cfg, ref, params, port = carried
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    rx, px = _batches(context_inputs_numpy(cfg, 2, 6))
    want = jax.jit(ref.forward)(params, {"tokens": jnp.asarray(toks), **rx})
    got = port.forward({"tokens": torch.from_numpy(toks), **px})
    _close(got[..., : cfg.vocab], np.asarray(want)[..., : cfg.vocab])
    # the context matters
    other = port.forward({"tokens": torch.from_numpy(toks),
                          **{k: 2 * v for k, v in px.items()}})
    assert not np.allclose(other.numpy(), got.numpy(), atol=1e-3)


def test_prefill_and_decode_match_reference(carried):
    cfg, ref, params, port = carried
    b, s, steps = 2, 16, 4
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (b, s + steps)).astype(np.int32)
    rx, px = _batches(context_inputs_numpy(cfg, b, 5))
    rcache = ref.init_cache(b, s + steps)
    pcache = port.init_cache(b, s + steps)
    assert set(pcache) == set(rcache) == {"blocks", "kv_src"}
    assert tuple(pcache["kv_src"].shape) == rcache["kv_src"].shape
    rlog, rcache = jax.jit(ref.prefill)(params, {"tokens": jnp.asarray(toks[:, :s]), **rx},
                                        rcache)
    plog, pcache = port.prefill({"tokens": torch.from_numpy(toks[:, :s]), **px}, pcache)
    _close(plog[..., : cfg.vocab], np.asarray(rlog)[..., : cfg.vocab], "prefill")
    _close(pcache["kv_src"], rcache["kv_src"], "kv_src")
    decode = jax.jit(ref.decode_step)
    for i in range(steps):
        nxt = toks[:, s + i: s + i + 1]
        rlog, rcache = decode(params, jnp.asarray(nxt), rcache, jnp.int32(s + i))
        plog, pcache = port.decode_step(torch.from_numpy(nxt), pcache, s + i)
        _close(plog[..., : cfg.vocab], np.asarray(rlog)[..., : cfg.vocab], f"decode {i}")
        assert np.all(plog[..., cfg.vocab:].numpy() < -1e29)
    _close(pcache["kv_src"], rcache["kv_src"], "kv_src after decode")
    for li, (pc, rc) in enumerate(zip(pcache["blocks"], rcache["blocks"])):
        assert set(pc) == set(rc), li  # K/V of a self-attention layer, {} of a cross one
        for key in pc:
            _close(pc[key], rc[key], f"layer {li} {key}")
    assert any(not c for c in pcache["blocks"]) == (cfg.family == "vlm")


@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_grads_match_reference(carried, masked):
    cfg, ref, params, port = carried
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32),
             **context_inputs_numpy(cfg, 2, 7)}
    if masked:
        batch["mask"] = (rng.random((2, 24)) < 0.7).astype(np.float32)
    (want, wmet), wgrads = jax.jit(jax.value_and_grad(ref.loss, has_aux=True))(
        params, jax.tree.map(jnp.asarray, batch))
    loss, met = port.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(loss.item(), float(want), rtol=TOL)
    for key in met:
        np.testing.assert_allclose(met[key].item(), float(wmet[key]), rtol=TOL, atol=1e-7,
                                   err_msg=key)
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad(loss, list(port.parameters()))
    got = lm_params_to_numpy(port, dict(zip(names, grads)))
    assert jax.tree.structure(got) == jax.tree.structure(wgrads)
    for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree.leaves(wgrads)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))
    # the context's weights learn: the encoder's, or the image layers' k/v
    key = "enc.blocks.0.attn.wq" if cfg.n_enc_layers else "blocks.1.attn.wk"
    assert float(dict(zip(names, grads))[key].abs().max()) > 0


def test_decode_continues_prefill(carried):
    """Inside the port: prefill + one decode step == prefill of the
    extended prompt == forward over it, with the same context (``kv_src``
    carried in the cache, and the self-attention K/V beside it)."""
    cfg, _, _, port = carried
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 17)).astype(np.int32))
    px = {k: torch.from_numpy(v) for k, v in context_inputs_numpy(cfg, 2, 1).items()}
    cache = port.init_cache(2, 20)
    _, cache = port.prefill({"tokens": toks[:, :16], **px}, cache)
    dec, _ = port.decode_step(toks[:, 16:], cache, 16)
    whole, _ = port.prefill({"tokens": toks, **px}, port.init_cache(2, 20))
    full = port.forward({"tokens": toks, **px})
    for other, what in ((whole[:, 0], "prefill"), (full[:, -1], "forward")):
        np.testing.assert_allclose(dec[:, 0, : cfg.vocab].numpy(),
                                   other[:, : cfg.vocab].numpy(), rtol=2e-4, atol=2e-4,
                                   err_msg=what)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_reference_init(arch):
    """``Model.init``'s leaves against the reference init's: the norms and
    biases equal, the random ones with the same spread, in bf16."""
    ref_cfg, cfg = _configs(arch, dtype="bfloat16")
    want = RefModel(ref_cfg).init(jax.random.PRNGKey(0))
    port = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    got = lm_params_to_numpy(port)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert ("enc" in got) == (arch == "whisper_small")
    for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree.leaves(want)):
        key = jax.tree_util.keystr(path)
        assert g.dtype == w.dtype, key
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        if w.std() == 0:
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert abs(g.std() / w.std() - 1) < 0.15, (key, g.std(), w.std())


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip(arch):
    """``lm_params_numpy`` -> ``load_lm_params`` -> ``lm_params_to_numpy``
    gives the tree back, the encoder's stack (``enc.blocks``, 2 layers
    stacked on axis 0) and the cross-attention leaves included."""
    ref_cfg, cfg = _configs(arch)
    tree = lm_params_numpy(cfg, 3)
    assert jax.tree.structure(tree) == jax.tree.structure(RefModel(ref_cfg).init_abstract())
    model = load_lm_params(Model(cfg, device="cpu"), tree)
    back = lm_params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    back = dict(tree_leaves(back))
    for path, a in tree_leaves(tree):
        np.testing.assert_array_equal(a, back[path], err_msg=path)
    if cfg.n_enc_layers:  # encoder layer r is repeat r of the one stacked block
        enc = tree["enc"]["blocks"][0]["attn"]["wq"]
        assert enc.shape[0] == cfg.n_enc_layers == len(model.enc.blocks)
        for r, blk in enumerate(model.enc.blocks):
            np.testing.assert_array_equal(blk.attn.wq.detach().numpy(), enc[r])
        np.testing.assert_array_equal(model.blocks[1].cross.wv.detach().numpy(),
                                      tree["blocks"][0]["cross"]["wv"][1])
    else:  # one period [self, cross]: layer 1 is the image layer
        assert [b.spec.mixer for b in model.blocks] == ["attn", "cross"] * 2


def test_engine_with_extras_matches_reference(carried):
    cfg, ref, params, port = carried
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab, 10).astype(np.int32) for _ in range(5)]
    extras = context_inputs_numpy(cfg, 2, 8)
    want = RefServeEngine(ref, params, batch=2, max_seq=24).run(
        [RefRequest(rid=i, prompt=p, max_new=6) for i, p in enumerate(prompts)],
        extras={k: jnp.asarray(v) for k, v in extras.items()})
    got = ServeEngine(port, batch=2, max_seq=24).run(
        [Request(rid=i, prompt=p, max_new=6) for i, p in enumerate(prompts)], extras)
    assert sorted(r.rid for r in got) == list(range(5))  # 3 waves of 2
    assert {r.rid: r.out.tolist() for r in got} == {r.rid: r.out.tolist() for r in want}
    # the extras reach every wave
    other = ServeEngine(port, batch=2, max_seq=24).run(
        [Request(rid=i, prompt=p, max_new=6) for i, p in enumerate(prompts)],
        {k: 40 * v for k, v in extras.items()})
    assert [r.out.tolist() for r in other] != [r.out.tolist() for r in got]
