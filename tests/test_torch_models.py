"""The port's LM configs, layers and dense model against the JAX package
(the MoE, hybrid and SSM families: ``tests/test_torch_families.py``; the
encoder-decoder and vision-language ones:
``tests/test_torch_encdec_vlm.py``).  Every registered architecture's
``reduced()`` config builds a ``Model`` that its ``lm_params_numpy`` tree
loads into.

Configs are plain data and must equal the reference field for field.
Layers and the model are compared in f32 on the same numpy inputs: the
layers at 1e-6, and the whole model, with the reference's own
``Model.init(PRNGKey(0))`` weights carried over by
``interop.load_lm_params``, at rtol/atol 1e-4 for the prefill logits and
four decode steps.  The four dense archs at ``reduced()`` cover QKV bias
(qwen2, qwen2.5), qk-norm (qwen3) and untied embeddings (minitron).
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
from repro.models import layers as ref_layers
from repro.models import transformer as ref_transformer
from repro_torch.configs import base
from repro_torch.interop import lm_params_numpy, load_lm_params, tree_leaves
from repro_torch.models import Model, padded_vocab
from repro_torch.models import layers
from repro_torch.models.transformer import find_period, layer_program

DENSE = ["minitron_8b", "qwen2_7b", "qwen2_5_3b", "qwen3_0_6b"]
FAMILIES = ["qwen2_moe_a2_7b", "arctic_480b", "jamba_v0_1_52b", "rwkv6_1_6b"]
TOL = 1e-4  # f32 model logits: matmul sums run in another order than XLA's


# ---------------- configs -----------------------------------------------------


@pytest.mark.parametrize("arch", ref_base.ARCH_IDS)
def test_config_equals_reference(arch):
    ref, cfg = ref_base.get_arch(arch), base.get_arch(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(ref.reduced())
    for c, r in ((cfg, ref), (cfg.reduced(), ref.reduced())):
        assert c.head_dim == r.head_dim
        assert c.param_count() == r.param_count()
        assert c.active_param_count() == r.active_param_count()
        assert c._layer_mix() == r._layer_mix()
        assert (c.is_attention_free, c.subquadratic) == (r.is_attention_free, r.subquadratic)
        for shape in ref_base.SHAPES:
            assert c.shape_applicable(shape) == r.shape_applicable(shape)
    assert [dataclasses.astuple(s) for s in layer_program(cfg)] == \
        [(s.mixer, s.ffn) for s in ref_transformer.layer_program(ref)]


def test_registry_equals_reference():
    assert base.list_archs() == ref_base.list_archs()
    assert {k: dataclasses.astuple(v) for k, v in base.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in ref_base.SHAPES.items()}
    for alias in ("qwen3-0.6b", "llama-3.2-vision-90b", "Qwen2_5_3b".lower()):
        assert base.get_arch(alias).arch == ref_base.get_arch(alias).arch


# ---------------- layers ------------------------------------------------------


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def test_rmsnorm_rope_mlp_match_reference():
    rng = np.random.default_rng(0)
    x, scale = _rand(rng, 2, 7, 3, 32), 1 + 0.1 * _rand(rng, 32)
    got = layers.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale))
    want = ref_layers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)

    pos = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
    for theta in (10_000.0, 1_000_000.0):
        got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
        want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(layers.rope_freqs(128, 1e6).numpy(),
                               np.asarray(ref_layers.rope_freqs(128, 1e6)), rtol=1e-6)

    h, wg, wi, wo = (_rand(rng, 2, 5, 16), _rand(rng, 16, 24) / 4,
                     _rand(rng, 16, 24) / 4, _rand(rng, 24, 16) / 5)
    got = layers.mlp(*map(torch.from_numpy, (h, wg, wi, wo)))
    want = ref_layers.mlp({"wg": wg, "wi": wi, "wo": wo}, jnp.asarray(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("tie", [True, False])
def test_embed_unembed_match_reference(tie):
    rng = np.random.default_rng(1)
    p = {"tok": _rand(rng, 64, 16)}
    if not tie:
        p["head"] = _rand(rng, 16, 64)
    toks = rng.integers(0, 64, (2, 5)).astype(np.int32)
    x = layers.embed(torch.from_numpy(p["tok"]), torch.from_numpy(toks))
    np.testing.assert_array_equal(x.numpy(), np.asarray(ref_layers.embed(p, jnp.asarray(toks))))
    got = layers.unembed(x, torch.from_numpy(p["tok"]),
                         None if tie else torch.from_numpy(p["head"]))
    want = ref_layers.unembed(p, jnp.asarray(x.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_init_distributions():
    cfg = base.get_arch("minitron_8b").reduced()
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    w = model.blocks[0].mlp.wo  # fan-in 256
    assert abs(float(w.std()) * 16 - 0.987) < 0.05  # truncated at 3 sigma
    assert float(w.abs().max()) <= 3 / 16 + 1e-6
    assert abs(float(model.embed.tok.std()) - 0.01) < 0.001
    assert model.embed.head is not None and model.embed.tok.shape == (512, 128)
    assert all(float(b.attn.wq.std()) > 0 for b in model.blocks)
    assert torch.equal(model.final_norm.scale, torch.ones(128))


# ---------------- the model with carried weights ------------------------------


@pytest.fixture(scope="module", params=DENSE)
def carried(request):
    cfg = ref_base.get_arch(request.param).reduced()
    ref = RefModel(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    port = load_lm_params(Model(base.get_arch(request.param).reduced(), device="cpu"),
                          jax.tree.map(np.asarray, params))
    return cfg, ref, params, port


def test_carried_weights_prefill_and_decode_match_reference(carried):
    cfg, ref, params, port = carried
    b, s, steps = 2, 16, 4
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (b, s + steps)).astype(np.int32)
    rcache = ref.init_cache(b, s + steps)
    pcache = port.init_cache(b, s + steps)
    rlog, rcache = jax.jit(ref.prefill)(params, {"tokens": jnp.asarray(toks[:, :s])}, rcache)
    plog, pcache = port.prefill({"tokens": torch.from_numpy(toks[:, :s])}, pcache)
    assert plog.shape == (b, 1, padded_vocab(cfg.vocab))
    np.testing.assert_allclose(plog.numpy(), np.asarray(rlog), rtol=TOL, atol=TOL)
    decode = jax.jit(ref.decode_step)
    for i in range(steps):
        nxt = toks[:, s + i: s + i + 1]
        rlog, rcache = decode(params, jnp.asarray(nxt), rcache, jnp.int32(s + i))
        plog, pcache = port.decode_step(torch.from_numpy(nxt), pcache, s + i)
        np.testing.assert_allclose(plog[..., : cfg.vocab].numpy(),
                                   np.asarray(rlog)[..., : cfg.vocab], rtol=TOL, atol=TOL)
        assert np.all(plog[..., cfg.vocab:].numpy() < -1e29)
    for li in (0, cfg.n_layers - 1):  # the caches hold the same K/V
        np.testing.assert_allclose(pcache["blocks"][li]["k"].numpy(),
                                   np.asarray(rcache["blocks"][li]["k"]), rtol=TOL, atol=TOL)


def test_carried_weights_forward_matches_reference(carried):
    cfg, ref, params, port = carried
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    want = jax.jit(ref.forward)(params, {"tokens": jnp.asarray(toks)})
    got = port.forward({"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got[..., : cfg.vocab].numpy(),
                               np.asarray(want)[..., : cfg.vocab], rtol=TOL, atol=TOL)


def test_decode_matches_forward(carried):
    """Inside the port: prefill + one decode step == forward on the
    extended sequence (the twin of tests/test_arch_smoke.py's check)."""
    cfg, _, _, port = carried
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 17)).astype(np.int32))
    cache = port.init_cache(2, 20)
    _, cache = port.prefill({"tokens": toks[:, :16]}, cache)
    dec, _ = port.decode_step(toks[:, 16:], cache, 16)
    full = port.forward({"tokens": toks})
    np.testing.assert_allclose(dec[:, 0, : cfg.vocab].numpy(),
                               full[:, -1, : cfg.vocab].numpy(), rtol=2e-4, atol=2e-4)


# ---------------- numpy trees -------------------------------------------------


TREE_CASES = [(a, "reduced") for a in DENSE] + [
    ("qwen3_0_6b", dict(n_layers=2, vocab=1024, dtype="float32")),  # the serve golden's
    ("qwen3_0_6b", dict(n_layers=2, vocab=1024)),  # bf16
    ("qwen2_7b", dict(n_layers=2, vocab=1024, d_model=256, d_ff=512, d_head=64,
                      dtype="float32")),
] + [(a, "reduced") for a in FAMILIES] + [
    (a, "reduced_bf16") for a in FAMILIES  # f32 leaves (router, SSM) in a bf16 tree
] + [("rwkv6_1_6b", dict(n_layers=2, vocab=1024, dtype="float32"))]  # the serve golden's


@pytest.mark.parametrize("arch,cut", TREE_CASES, ids=lambda c: str(c).replace(" ", ""))
def test_lm_params_numpy_matches_init_abstract(arch, cut):
    def make(mod):
        cfg = mod.get_arch(arch)
        if cut == "reduced":
            return cfg.reduced()
        if cut == "reduced_bf16":
            return dataclasses.replace(cfg.reduced(), dtype="bfloat16")
        return dataclasses.replace(cfg, **cut)

    ref_cfg, cfg = make(ref_base), make(base)
    abstract = RefModel(ref_cfg).init_abstract()
    tree = lm_params_numpy(cfg, seed=0)
    assert jax.tree.structure(tree) == jax.tree.structure(abstract)
    for got, want in zip(jax.tree.leaves(tree), jax.tree.leaves(abstract)):
        assert got.shape == want.shape and got.dtype == want.dtype
    model = load_lm_params(Model(cfg, device="cpu"), tree)
    # blocks stacked per position of the layer program's period
    period, reps = find_period(layer_program(cfg))
    assert (period, reps) == ref_transformer.find_period(ref_transformer.layer_program(ref_cfg))
    assert len(tree["blocks"]) == period and period * reps == cfg.n_layers
    li = cfg.n_layers - 1  # the last layer is position li % period, repeat li // period
    stacked = dict(tree_leaves(tree["blocks"][li % period]))
    for name, p in model.blocks[li].named_parameters():
        np.testing.assert_array_equal(p.detach().float().numpy(),
                                      np.asarray(stacked[name][li // period], np.float32), name)
    np.testing.assert_array_equal(lm_params_numpy(cfg, 0)["embed"]["tok"], tree["embed"]["tok"])


def test_load_lm_params_rejects_a_mismatched_tree():
    cfg = base.get_arch("qwen3_0_6b").reduced()
    tree = lm_params_numpy(cfg, 0)
    untied = lm_params_numpy(dataclasses.replace(cfg, tie_embeddings=False), 0)
    with pytest.raises(ValueError, match="head"):
        load_lm_params(Model(cfg, device="cpu"), untied)
    tree["blocks"][0]["attn"]["wq"] = tree["blocks"][0]["attn"]["wq"][:, :, :8]
    with pytest.raises(ValueError, match="wq"):
        load_lm_params(Model(cfg, device="cpu"), tree)


@pytest.mark.parametrize("arch", ref_base.ARCH_IDS)
def test_every_arch_builds_and_loads_its_tree(arch):
    """Every registered architecture's ``reduced()`` config builds a
    ``Model``, and its ``lm_params_numpy`` tree (the reference's
    ``init_abstract`` structure) loads into it, every parameter from a leaf."""
    cfg = base.get_arch(arch).reduced()
    tree = lm_params_numpy(cfg, 0)
    abstract = RefModel(ref_base.get_arch(arch).reduced()).init_abstract()
    assert jax.tree.structure(tree) == jax.tree.structure(abstract)
    model = load_lm_params(Model(cfg, device="cpu"), tree)
    assert sum(p.numel() for p in model.parameters()) == \
        sum(a.size for a in jax.tree.leaves(tree))
    assert (model.enc is not None) == bool(cfg.n_enc_layers)
