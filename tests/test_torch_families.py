"""The port's MoE, hybrid and SSM families against the JAX package.

Same numpy inputs, f32, on the CPU:

- ``moe`` against ``repro.models.moe.moe`` for the reduced ``qwen2_moe_a2_7b``
  (shared experts) and ``arctic_480b`` (dense residual) at capacity factors
  1.25 and 2.0, over three routing groups with a shared offset on the
  tokens so that some experts overflow: the output and both aux losses
  within ``TOL``, and the expert indices, queue positions and kept mask
  equal to the reference's (read from its ``jax.lax.top_k`` and
  ``jax.nn.one_hot`` calls);
- ``mamba`` / ``mamba_decode`` (jamba's SSM layer) and ``rwkv_time_mix`` /
  ``rwkv_time_mix_decode`` / ``rwkv_channel_mix`` (rwkv6), outputs and final
  states;
- the whole model of the four architectures at ``reduced()``, with weights
  from ``interop.lm_params_numpy`` carried into both packages:
  ``Model.forward``, ``prefill`` + ``decode_step`` (logits and caches),
  ``Model.loss`` with its metrics and every gradient against
  ``jax.value_and_grad``, and ``Model.init``'s leaves against the
  reference init's;
- inside the port: decoding a token after a prefill gives the logits of
  prefilling the extended prompt and of the forward pass over it (MoE
  configs at a capacity where no token is dropped).
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
from repro.models import moe as ref_moe
from repro.models import ssm as ref_ssm
from repro_torch.configs import base
from repro_torch.interop import lm_params_numpy, lm_params_to_numpy, load_lm_params
from repro_torch.models import Model, moe, ssm

FAMILIES = ["qwen2_moe_a2_7b", "arctic_480b", "jamba_v0_1_52b", "rwkv6_1_6b"]
TOL = 1e-4  # f32: sums in another order than XLA's
GRAD_TOL = 1e-4


def _configs(arch: str):
    return ref_base.get_arch(arch).reduced(), base.get_arch(arch).reduced()


def _carry(cfg, seed: int):
    tree = lm_params_numpy(cfg, seed)
    return tree, load_lm_params(Model(cfg, device="cpu"), tree)


def _at(tree: dict, rep: int = 0) -> dict:
    """One layer's reference params from a leaf-stacked subtree."""
    return jax.tree.map(lambda a: jnp.asarray(a[rep]), tree)


def _close(got: torch.Tensor, want, msg: str = "", tol: float = TOL) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=msg)


# ---------------- MoE ---------------------------------------------------------


def _reference_routing(params, cfg, x, factor, monkeypatch):
    """The reference's moe output and aux, with the expert indices and
    queue positions it computed (its top_k and its second one_hot)."""
    seen = {"top_k": [], "one_hot": []}
    top_k, one_hot = jax.lax.top_k, jax.nn.one_hot

    def rec_top_k(probs, k):
        out = top_k(probs, k)
        seen["top_k"].append(np.asarray(out[1]))
        return out

    def rec_one_hot(a, n, **kw):
        seen["one_hot"].append(np.asarray(a))
        return one_hot(a, n, **kw)

    monkeypatch.setattr(jax.lax, "top_k", rec_top_k)
    monkeypatch.setattr(jax.nn, "one_hot", rec_one_hot)
    out, aux = ref_moe.moe(params, cfg, jnp.asarray(x), capacity_factor=factor)
    monkeypatch.undo()
    (idx,), (_, pos) = seen["top_k"], seen["one_hot"]
    return np.asarray(out), aux, idx, pos


@pytest.mark.parametrize("factor", [1.25, 2.0])
@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "arctic_480b"])
def test_moe_matches_reference(arch, factor, monkeypatch):
    ref_cfg, cfg = _configs(arch)
    tree, model = _carry(cfg, 11)
    p = model.blocks[0].moe
    assert (p.shared is not None, p.dense is not None) == \
        (bool(cfg.n_shared_experts), cfg.dense_residual)
    rng = np.random.default_rng(12)
    b, s, d = 3, 400, cfg.d_model  # 1,200 tokens: three groups of 400
    x = (rng.standard_normal((b, s, d)) + 2.0 * rng.standard_normal(d)).astype(np.float32)
    want, waux, widx, wpos = _reference_routing(_at(tree["blocks"][0]["moe"]), ref_cfg, x,
                                                factor, monkeypatch)
    got, aux = moe.moe(p, cfg, torch.from_numpy(x), capacity_factor=factor)
    _close(got, want)
    for key in ("moe_lb_loss", "moe_z_loss"):
        np.testing.assert_allclose(aux[key].item(), float(waux[key]), rtol=TOL, err_msg=key)

    group = moe._group_size(b * s)
    cap = moe._capacity(group, cfg.top_k, cfg.n_experts, factor)
    assert (group, cap) == (ref_moe._group_size(b * s),
                            ref_moe._capacity(group, cfg.top_k, cfg.n_experts, factor))
    r = moe.route(p.router, torch.from_numpy(x).reshape(-1, group, d), cfg.top_k, cap)
    np.testing.assert_array_equal(r.idx.numpy(), widx)
    np.testing.assert_array_equal(r.pos.numpy(), wpos)
    keep = wpos < cap
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    if factor == 1.25:  # the offset makes some experts overflow: drops are tested
        assert not keep.all()


def test_moe_capacity_and_groups_match_reference():
    for t in (1, 2, 3, 4, 7, 320, 512, 513, 1200, 4096, 6000):
        assert moe._group_size(t) == ref_moe._group_size(t)
        for k, e in ((4, 60), (2, 128), (2, 16), (4, 8)):
            for factor in (1.25, 2.0):
                g = moe._group_size(t)
                assert moe._capacity(g, k, e, factor) == ref_moe._capacity(g, k, e, factor)


# ---------------- SSM mixers --------------------------------------------------


# shorter than the conv window, longer, and three chunks of the scan and a ragged fourth
@pytest.mark.parametrize("s", [2, 24, 3 * ssm.SCAN_CHUNK + 5])
def test_mamba_matches_reference(s):
    ref_cfg, cfg = _configs("jamba_v0_1_52b")
    tree, model = _carry(cfg, 13)
    assert model.blocks[0].spec.mixer == "mamba"
    p, rp = model.blocks[0].mixer, _at(tree["blocks"][0]["mixer"])
    rng = np.random.default_rng(14)
    x = rng.standard_normal((2, s + 3, cfg.d_model)).astype(np.float32)
    want, wstate = ref_ssm.mamba(rp, ref_cfg, jnp.asarray(x[:, :s]), return_state=True)
    got, state = ssm.mamba(p, cfg, torch.from_numpy(x[:, :s]), return_state=True)
    _close(got, want, "mamba")
    _close(ssm.mamba(p, cfg, torch.from_numpy(x[:, :s])), want, "without state")
    for key in ("h", "conv"):
        _close(state[key], wstate[key], key)
    for i in range(s, s + 3):  # decode from the prefilled state
        want, wstate = ref_ssm.mamba_decode(rp, ref_cfg, jnp.asarray(x[:, i:i + 1]), wstate)
        got, state = ssm.mamba_decode(p, cfg, torch.from_numpy(x[:, i:i + 1]), state)
        _close(got, want, f"decode {i}")
        for key in ("h", "conv"):
            _close(state[key], wstate[key], f"decode {i} {key}")


def test_rwkv_time_mix_matches_reference():
    ref_cfg, cfg = _configs("rwkv6_1_6b")
    tree, model = _carry(cfg, 15)
    p, rp = model.blocks[0].mixer, _at(tree["blocks"][0]["mixer"])
    nh, hd = ssm.rwkv_dims(cfg)
    rng = np.random.default_rng(16)
    x = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    x_prev = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    s0 = (0.1 * rng.standard_normal((2, nh, hd, hd))).astype(np.float32)
    _close(ssm.rwkv_time_mix(p, cfg, torch.from_numpy(x)),
           ref_ssm.rwkv_time_mix(rp, ref_cfg, jnp.asarray(x)), "from zeros")
    want, wstate = ref_ssm.rwkv_time_mix(rp, ref_cfg, jnp.asarray(x[:, :16]),
                                         jnp.asarray(x_prev), jnp.asarray(s0),
                                         return_state=True)
    got, state = ssm.rwkv_time_mix(p, cfg, torch.from_numpy(x[:, :16]),
                                   torch.from_numpy(x_prev), torch.from_numpy(s0),
                                   return_state=True)
    _close(got, want, "from a state")
    for key in ("s", "x_prev"):
        _close(state[key], wstate[key], key)
    for i in range(16, 20):
        want, wstate = ref_ssm.rwkv_time_mix_decode(rp, ref_cfg, jnp.asarray(x[:, i:i + 1]),
                                                    wstate)
        got, state = ssm.rwkv_time_mix_decode(p, cfg, torch.from_numpy(x[:, i:i + 1]), state)
        _close(got, want, f"decode {i}")
        for key in ("s", "x_prev"):
            _close(state[key], wstate[key], f"decode {i} {key}")


LONG = 3 * ssm.SCAN_CHUNK + 5  # three chunks of the scans and a ragged fourth


def test_rwkv_time_mix_over_chunks_matches_reference():
    ref_cfg, cfg = _configs("rwkv6_1_6b")
    tree, model = _carry(cfg, 19)
    p, rp = model.blocks[0].mixer, _at(tree["blocks"][0]["mixer"])
    nh, hd = ssm.rwkv_dims(cfg)
    rng = np.random.default_rng(20)
    x = rng.standard_normal((2, LONG + 2, cfg.d_model)).astype(np.float32)
    x_prev = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    s0 = (0.1 * rng.standard_normal((2, nh, hd, hd))).astype(np.float32)
    want, wstate = ref_ssm.rwkv_time_mix(rp, ref_cfg, jnp.asarray(x[:, :LONG]),
                                         return_state=True)
    got, state = ssm.rwkv_time_mix(p, cfg, torch.from_numpy(x[:, :LONG]), return_state=True)
    _close(got, want, "from zeros")
    _close(state["s"], wstate["s"], "from zeros, state")
    want, wstate = ref_ssm.rwkv_time_mix(rp, ref_cfg, jnp.asarray(x[:, :LONG]),
                                         jnp.asarray(x_prev), jnp.asarray(s0),
                                         return_state=True)
    got, state = ssm.rwkv_time_mix(p, cfg, torch.from_numpy(x[:, :LONG]),
                                   torch.from_numpy(x_prev), torch.from_numpy(s0),
                                   return_state=True)
    _close(got, want, "from a state")
    _close(state["s"], wstate["s"], "from a state, state")
    for i in range(LONG, LONG + 2):
        want, wstate = ref_ssm.rwkv_time_mix_decode(rp, ref_cfg, jnp.asarray(x[:, i:i + 1]),
                                                    wstate)
        got, state = ssm.rwkv_time_mix_decode(p, cfg, torch.from_numpy(x[:, i:i + 1]), state)
        _close(got, want, f"decode {i}")
        _close(state["s"], wstate["s"], f"decode {i} state")


def _probe(rng, shape) -> np.ndarray:
    """A random projection of an output, scaled so that the loss it makes
    has gradients of order one (a plain sum over 2 x LONG x d outputs puts
    them near 100, where f32's own rounding is ~1e-4)."""
    return (rng.standard_normal(shape) / np.sqrt(np.prod(shape))).astype(np.float32)


def _scan_inputs(arch: str, seed: int, s: int):
    ref_cfg, cfg = _configs(arch)
    tree, model = _carry(cfg, seed)
    p, rp = model.blocks[0].mixer, _at(tree["blocks"][0]["mixer"])
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    return ref_cfg, cfg, p, rp, rng, x


def test_ssm_strong_decay_is_finite_and_matches_reference():
    """Decays that underflow: mamba's dt large (exp(dt a) near 0) and
    rwkv's w near and at 0 (w0 large: exp(-exp(w0)) underflows)."""
    ref_cfg, cfg, p, rp, _, x = _scan_inputs("jamba_v0_1_52b", 21, LONG)
    with torch.no_grad():
        p.dt_bias.fill_(30.0)
    rp = dict(rp, dt_bias=jnp.full_like(rp["dt_bias"], 30.0))
    got = ssm.mamba(p, cfg, torch.from_numpy(x))
    assert torch.isfinite(got).all()
    _close(got, ref_ssm.mamba(rp, ref_cfg, jnp.asarray(x)), "mamba, strong decay")
    ref_cfg, cfg, p, rp, rng, x = _scan_inputs("rwkv6_1_6b", 23, LONG)
    w0 = rng.uniform(0.0, 6.0, p.w0.shape).astype(np.float32)
    with torch.no_grad():
        p.w0.copy_(torch.from_numpy(w0))
    rp = dict(rp, w0=jnp.asarray(w0))
    xt = torch.from_numpy(x).requires_grad_()
    got = ssm.rwkv_time_mix(p, cfg, xt)
    assert torch.isfinite(got).all()
    _close(got, ref_ssm.rwkv_time_mix(rp, ref_cfg, jnp.asarray(x)), "rwkv, strong decay")
    got.square().sum().backward()
    assert torch.isfinite(xt.grad).all()
    assert all(torch.isfinite(t.grad).all() for t in p.parameters())


def _grads_close(p, x_grads: dict, ref_grads: dict, want_params: dict, msg: str) -> None:
    for name, t in p.named_parameters():
        want = want_params
        for key in name.split("."):
            want = want[key]
        _close(t.grad, want, f"{msg}: d {name}", tol=GRAD_TOL)
    for key, g in x_grads.items():
        _close(g, ref_grads[key], f"{msg}: d {key}", tol=GRAD_TOL)


@pytest.mark.parametrize("group", [ssm.SCAN_GROUP, 1, 3])
def test_mamba_gradients_match_reference(group, monkeypatch):
    """Through the recomputing silu gate and the scan's forward and
    backward, which run ``group`` chunks at a time (LONG is four chunks:
    one group, four, or three and one)."""
    monkeypatch.setattr(ssm, "SCAN_GROUP", group)
    ref_cfg, cfg, p, rp, rng, x = _scan_inputs("jamba_v0_1_52b", 25, LONG)
    probe = _probe(rng, (2, LONG, cfg.d_model))
    probe_h = _probe(rng, (2,) + p.A_log.shape)

    def ref_loss(params, x):
        out, st = ref_ssm.mamba(params, ref_cfg, x, return_state=True)
        return jnp.sum(out * probe) + jnp.sum(st["h"] * probe_h)

    gp, gx = jax.grad(ref_loss, argnums=(0, 1))(rp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out, st = ssm.mamba(p, cfg, xt, return_state=True)
    ((out * torch.from_numpy(probe)).sum() + (st["h"] * torch.from_numpy(probe_h)).sum()).backward()
    _grads_close(p, {"x": xt.grad}, {"x": gx}, gp, "mamba")


@pytest.mark.parametrize("from_state", [False, True])
def test_rwkv_time_mix_gradients_match_reference(from_state):
    ref_cfg, cfg, p, rp, rng, x = _scan_inputs("rwkv6_1_6b", 27, LONG)
    nh, hd = ssm.rwkv_dims(cfg)
    probe, probe_s = _probe(rng, (2, LONG, cfg.d_model)), _probe(rng, (2, nh, hd, hd))
    x_prev = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    s0 = (0.1 * rng.standard_normal((2, nh, hd, hd))).astype(np.float32)
    extra = (x_prev, s0) if from_state else ()

    def ref_loss(params, x, *extra):
        out, st = ref_ssm.rwkv_time_mix(params, ref_cfg, x, *extra, return_state=True)
        return jnp.sum(out * probe) + jnp.sum(st["s"] * probe_s)

    grads = jax.grad(ref_loss, argnums=tuple(range(2 + len(extra))))(
        rp, jnp.asarray(x), *map(jnp.asarray, extra))
    ts = [torch.from_numpy(t).requires_grad_() for t in (x, *extra)]
    out, st = ssm.rwkv_time_mix(p, cfg, *ts, return_state=True)
    ((out * torch.from_numpy(probe)).sum() + (st["s"] * torch.from_numpy(probe_s)).sum()).backward()
    names = ("x", "x_prev", "state0")[:len(ts)]
    _grads_close(p, {k: t.grad for k, t in zip(names, ts)}, dict(zip(names, grads[1:])),
                 grads[0], "rwkv")


class _OpCount(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _scan_op_counts(scan, args) -> tuple[int, int]:
    """Ops dispatched by ``scan(*args)``'s forward and by its backward."""
    args = [a.requires_grad_() for a in args]
    with _OpCount() as fwd:
        outs = scan(*args)
    loss = sum(o.sum() for o in outs)
    with _OpCount() as bwd:
        loss.backward()
    return fwd.n, bwd.n


# ops a chunk the scans may dispatch, forward or backward, over 4 chunks or
# more: ~100-250 set-up ops amortised, then 3-9 a chunk.  A per-token loop
# dispatches at least 6 a token, 6 x SCAN_CHUNK = 192 a chunk.
OPS_PER_CHUNK = 64


@pytest.mark.parametrize("chunks", [4, 16])
def test_scans_dispatch_a_bounded_count_of_ops_a_chunk(chunks):
    c = ssm.SCAN_CHUNK
    assert c >= 16
    s = chunks * c
    rng = np.random.default_rng(29)

    def f32(*shape, lo=-1.0, hi=1.0):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32))

    b, nh, hd, d_in, ds = 2, 2, 8, 8, 4
    rwkv = (f32(b, s, nh, hd), f32(b, s, nh, hd), f32(b, s, nh, hd),
            f32(b, s, nh, hd, lo=0.5, hi=1.0), f32(nh, hd), f32(b, nh, hd, hd))
    mamba = (f32(b, s, d_in, lo=0.0, hi=0.5), f32(b, s, ds), f32(b, s, ds), f32(b, s, d_in),
             f32(d_in, ds, lo=-2.0, hi=-0.5))
    for name, scan, args in (("rwkv", ssm._rwkv_scan, rwkv), ("mamba", ssm._mamba_scan, mamba)):
        for part, n in zip(("forward", "backward"), _scan_op_counts(scan, args)):
            assert n <= OPS_PER_CHUNK * chunks, (name, part, n, s)


def test_rwkv_channel_mix_matches_reference():
    ref_cfg, cfg = _configs("rwkv6_1_6b")
    tree, model = _carry(cfg, 17)
    p, rp = model.blocks[0].ffn, _at(tree["blocks"][0]["ffn"])
    rng = np.random.default_rng(18)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    x_prev = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    _close(ssm.rwkv_channel_mix(p, cfg, torch.from_numpy(x)),
           ref_ssm.rwkv_channel_mix(rp, ref_cfg, jnp.asarray(x)), "from zeros")
    _close(ssm.rwkv_channel_mix(p, cfg, torch.from_numpy(x), torch.from_numpy(x_prev)),
           ref_ssm.rwkv_channel_mix(rp, ref_cfg, jnp.asarray(x), jnp.asarray(x_prev)),
           "from x_prev")
    want, wprev = ref_ssm.rwkv_channel_mix_decode(rp, ref_cfg, jnp.asarray(x[:, :1]),
                                                  jnp.asarray(x_prev))
    _close(ssm.rwkv_channel_mix(p, cfg, torch.from_numpy(x[:, :1]), torch.from_numpy(x_prev)),
           want, "decode")
    np.testing.assert_array_equal(np.asarray(wprev), x[:, 0])


# ---------------- the whole model ---------------------------------------------


@pytest.fixture(scope="module", params=FAMILIES)
def carried(request):
    ref_cfg, cfg = _configs(request.param)
    tree, port = _carry(cfg, 0)
    return ref_cfg, RefModel(ref_cfg), jax.tree.map(jnp.asarray, tree), port


def test_forward_matches_reference(carried):
    cfg, ref, params, port = carried
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    want = jax.jit(ref.forward)(params, {"tokens": jnp.asarray(toks)})
    got = port.forward({"tokens": torch.from_numpy(toks)})
    _close(got[..., : cfg.vocab], np.asarray(want)[..., : cfg.vocab])


def test_prefill_and_decode_match_reference(carried):
    cfg, ref, params, port = carried
    b, s, steps = 2, 16, 4
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (b, s + steps)).astype(np.int32)
    rcache = ref.init_cache(b, s + steps)
    pcache = port.init_cache(b, s + steps)
    rlog, rcache = jax.jit(ref.prefill)(params, {"tokens": jnp.asarray(toks[:, :s])}, rcache)
    plog, pcache = port.prefill({"tokens": torch.from_numpy(toks[:, :s])}, pcache)
    _close(plog[..., : cfg.vocab], np.asarray(rlog)[..., : cfg.vocab], "prefill")
    decode = jax.jit(ref.decode_step)
    for i in range(steps):
        nxt = toks[:, s + i: s + i + 1]
        rlog, rcache = decode(params, jnp.asarray(nxt), rcache, jnp.int32(s + i))
        plog, pcache = port.decode_step(torch.from_numpy(nxt), pcache, s + i)
        _close(plog[..., : cfg.vocab], np.asarray(rlog)[..., : cfg.vocab], f"decode {i}")
        assert np.all(plog[..., cfg.vocab:].numpy() < -1e29)
    for li, (pc, rc) in enumerate(zip(pcache["blocks"], rcache["blocks"])):
        assert set(pc) == set(rc), li  # K/V or the recurrent state of every layer
        for key in pc:
            _close(pc[key].float(), np.asarray(rc[key], np.float32), f"layer {li} {key}")


@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_grads_match_reference(carried, masked):
    cfg, ref, params, port = carried
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)}
    if masked:
        batch["mask"] = (rng.random((2, 24)) < 0.7).astype(np.float32)
    (want, wmet), wgrads = jax.jit(jax.value_and_grad(ref.loss, has_aux=True))(
        params, jax.tree.map(jnp.asarray, batch))
    loss, met = port.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(met) == set(wmet) == {"ce", "moe_lb_loss", "moe_z_loss"}
    np.testing.assert_allclose(loss.item(), float(want), rtol=TOL)
    for key in met:
        np.testing.assert_allclose(met[key].item(), float(wmet[key]), rtol=TOL, atol=1e-7,
                                   err_msg=key)
    assert (met["moe_lb_loss"].item() > 0) == bool(cfg.n_experts)
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad(loss, list(port.parameters()))
    got = lm_params_to_numpy(port, dict(zip(names, grads)))
    assert jax.tree.structure(got) == jax.tree.structure(wgrads)
    for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree.leaves(wgrads)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))
    if cfg.n_experts:  # the aux losses reach the router
        router = next(g for n, g in zip(names, grads) if n.endswith("moe.router"))
        assert float(router.abs().max()) > 0


def test_decode_continues_prefill(carried):
    """Inside the port: prefill + one decode step == prefill of the
    extended prompt == forward over it (the recurrence's and the cache's
    invariant).  A token's MoE output depends on the other tokens of its
    routing group wherever an expert overflows, so the MoE configs run at a
    capacity factor of E / k here, where no expert can."""
    cfg, _, _, port = carried
    if cfg.n_experts:
        cfg = dataclasses.replace(port.cfg, moe_capacity_factor=cfg.n_experts / cfg.top_k)
        port = load_lm_params(Model(cfg, device="cpu"), lm_params_to_numpy(port))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 17)).astype(np.int32))
    cache = port.init_cache(2, 20)
    _, cache = port.prefill({"tokens": toks[:, :16]}, cache)
    dec, _ = port.decode_step(toks[:, 16:], cache, 16)
    whole, _ = port.prefill({"tokens": toks}, port.init_cache(2, 20))
    full = port.forward({"tokens": toks})
    for other, what in ((whole[:, 0], "prefill"), (full[:, -1], "forward")):
        np.testing.assert_allclose(dec[:, 0, : cfg.vocab].numpy(),
                                   other[:, : cfg.vocab].numpy(), rtol=2e-4, atol=2e-4,
                                   err_msg=what)


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_matches_reference_init(arch):
    """``Model.init``'s leaves against the reference init's: the constant
    ones (norms, biases, mixes, ``A_log``, ``D``, ``w0``) equal, the random
    ones with the same spread, each in the reference's dtype (the router and
    the SSM leaves f32 in a bf16 model)."""
    ref_cfg, cfg = (dataclasses.replace(c, dtype="bfloat16") for c in _configs(arch))
    want = RefModel(ref_cfg).init(jax.random.PRNGKey(0))
    port = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    got = lm_params_to_numpy(port)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree.leaves(want)):
        key = jax.tree_util.keystr(path)
        assert g.dtype == w.dtype, key
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        if w.std() == 0:
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert abs(g.std() / w.std() - 1) < 0.15, (key, g.std(), w.std())
