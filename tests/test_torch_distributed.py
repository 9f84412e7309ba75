"""The port's distribution (``repro_torch.distributed``, ``launch/mesh.py``,
the sharded steps) against the JAX package.

- Spec rules: for every architecture's ``reduced()`` tree, the port's
  ``param_specs`` equal the reference's leaf for leaf without its stacked
  repeats axis, bare and on a 16x16 and a 2x16x16 mesh (duck-typed meshes:
  the rules read only axis names and sizes); ``cache_specs`` likewise; the
  reference's ``_divisible_spec`` and ``effective_batch_axes`` cases.
- Multi-rank, in ``gloo`` processes on a ``FileStore`` (``torch_dist_worker``;
  no TCP port): on a 2x2 ("data", "model") mesh one sharded train step of
  the reduced ``qwen3_0_6b``, ``qwen2_moe_a2_7b`` (twice: tokens
  replicated and tokens sharded over "data"), ``jamba_v0_1_52b`` and
  ``rwkv6_1_6b`` (the mamba conv and both scans on each rank's channels
  or heads), and ``qwen3_0_6b`` with
  ``micro_steps=2``, against the reference's
  single-device ``jax.jit(make_train_step)`` (loss, metrics and weights
  within ``STEP_TOL``, weights where the reference's gradient exceeds
  ``GRAD_FLOOR``, as ``test_torch_train.py`` holds them), with MoE routing
  equal index for index to the unsharded port's; prefill and one decode on
  a sequence-sharded cache against the reference's (logits within
  ``DECODE_TOL``); a decode write lands on the rank that owns the position;
  ``restore_sharded`` and ``remesh`` from the 2x2 mesh to a 4x1 one give the
  saved tensors.
- On a 1x1 mesh every family's ``reduced()`` loss equals the unsharded
  one and its gradients are within ``ONE_RANK_GRAD_TOL``.
- Without a policy ``constrain`` and ``gather_fsdp`` return their
  argument; ``row_axes`` keeps every rank whole rows and whole routing
  groups, and ``mesh_placements`` replicates a mesh dim of one rank.
"""
from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_dist_worker as worker
from repro.configs import base as ref_base
from repro.distributed import sharding as ref_shd
from repro.models import Model as RefModel
from repro.train import optimizer as ref_opt
from repro.train.train_step import TrainConfig as RefTrainConfig
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.configs.base import get_arch, list_archs
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.context import (
    ActivationPolicy,
    activation_policy,
    constrain,
    gather_fsdp,
    mesh_placements,
    row_axes,
)
from repro_torch.interop import _stacked_targets, lm_params_numpy
from repro_torch.models import Model

STEP_TOL = 1e-5  # the reference's own bounds are 1e-3 (loss) and 1e-2 (weights)
GRAD_FLOOR = 1e-6  # Adam's first step may flip an element whose gradient is noise
# jamba's and rwkv6's scans sum a gradient over the steps, in another order
# when sharded: elements with |g| in 1e-6..1e-5 move Adam's first step by up
# to 2% of lr (2 of jamba's 131,052 in_proj elements by 1.8e-5), so their
# floor is 1e-5
GRAD_FLOORS = {"jamba_v0_1_52b": 1e-5, "rwkv6_1_6b": 1e-5}
# the share of moved elements compared: rwkv6's reduced time mix has small
# gradients, 2% of its moved elements below 1e-5
MIN_KEPT = {"rwkv6_1_6b": 0.98}
DECODE_TOL = 1e-4
# relative to the largest gradient: sums in another order (observed 7.2e-6
# of 9.9 in jamba's scan, whose decay's gradient sums over the steps)
ONE_RANK_GRAD_TOL = 1e-6


class PortMesh:
    """The port's rules read a mesh's dim names and sizes only."""

    def __init__(self, names, shape):
        self.mesh_dim_names, self.shape = tuple(names), tuple(shape)


class RefMesh:
    def __init__(self, names, shape):
        self.axis_names, self.devices = tuple(names), np.empty(shape, dtype=object)


MESHES = {"bare": None, "16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


def _meshes(which):
    if MESHES[which] is None:
        return None, None
    return PortMesh(*MESHES[which]), RefMesh(*MESHES[which])


# ---------------- spec rules -------------------------------------------------


@pytest.mark.parametrize("which", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_reference(arch, which):
    cfg = get_arch(arch).reduced()
    port_mesh, ref_mesh = _meshes(which)
    model = Model(cfg, device="meta")
    got = shd.param_specs(model, port_mesh)
    ref = RefModel(ref_base.get_arch(arch).reduced())
    want = {ref_shd._path_str(p): s for p, s in jax.tree_util.tree_flatten_with_path(
        ref_shd.param_specs(ref.init_abstract(), ref_mesh),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    targets = _stacked_targets(model)
    assert len(got) == sum(len(v) for v in targets.values())
    for path, dests in targets.items():
        spec = tuple(want[path.replace(".", "/")])
        for name, r in dests:
            assert tuple(got[name]) == (spec if r is None else spec[1:]), (name, path)


def _flat_specs(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, shd.P):
        items = enumerate(tree)
    else:
        return {prefix.rstrip("/"): tuple(tree)}
    out = {}
    for k, v in items:
        out.update(_flat_specs(v, f"{prefix}{k}/"))
    return out


@pytest.mark.parametrize("which", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", list_archs())
def test_cache_specs_match_reference(arch, which):
    cfg = get_arch(arch).reduced()
    port_mesh, ref_mesh = _meshes(which)
    cache = Model(cfg, device="meta").init_cache(32, 64)
    got = _flat_specs(shd.cache_specs(port_mesh, cache))
    ref = RefModel(ref_base.get_arch(arch).reduced())
    ref_cache = jax.eval_shape(lambda: ref.init_cache(32, 64))
    want = {ref_shd._path_str(p): tuple(s) for p, s in jax.tree_util.tree_flatten_with_path(
        ref_shd.cache_specs(ref_mesh, ref_cache),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    assert got == want


def test_divisibility_fallback():
    """60 experts on a 16-way axis fall back to replication of the expert
    dim and keep FSDP on d_model (the reference's case, without the stacked
    axis)."""
    one = PortMesh(("data", "model"), (1, 1))
    assert shd._divisible_spec(shd.P("model", "data", None), (60, 2048, 1408), one) == \
        shd.P("model", "data", None)
    big = PortMesh(("data", "model"), (16, 16))
    assert shd._divisible_spec(shd.P("model", "data", None), (60, 2048, 1408), big) == \
        shd.P(None, "data", None)
    assert shd._divisible_spec(shd.P(("pod", "data"), None), (32, 7),
                               PortMesh(("pod", "data", "model"), (2, 16, 16))) == \
        shd.P(("pod", "data"), None)


def test_effective_batch_axes():
    mesh = PortMesh(("pod", "data", "model"), (2, 16, 16))
    assert shd.effective_batch_axes(mesh, 256) == ("pod", "data")
    assert shd.effective_batch_axes(mesh, 32) == ("pod", "data")
    assert shd.effective_batch_axes(mesh, 2) == ("pod",)
    assert shd.effective_batch_axes(mesh, 1) == ()
    ref = RefMesh(("pod", "data", "model"), (2, 16, 16))
    for b in (256, 32, 2, 1, 48):
        assert shd.effective_batch_axes(mesh, b) == ref_shd.effective_batch_axes(ref, b)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = PortMesh(("pod", "data", "model"), (2, 16, 16))
    assert shd.placements(mesh, shd.P(("pod", "data"), None, "model")) == \
        (Shard(0), Shard(0), Shard(2))
    assert shd.placements(mesh, shd.P(None, None)) == (Replicate(),) * 3
    assert shd.shardings(mesh, {"a": [shd.P("data")]}) == \
        {"a": [(Replicate(), Shard(0), Replicate())]}


def test_constrain_is_the_identity_without_a_policy_or_a_dtensor():
    x = torch.randn(2, 3, 4)
    assert constrain(x, "btd") is x
    with activation_policy(ActivationPolicy(PortMesh(("data", "model"), (2, 2)), "data")):
        assert constrain(x, "btd") is x  # a plain tensor is left alone under a policy
        assert gather_fsdp(x) is x


def test_row_axes_keep_whole_rows_and_routing_groups():
    mesh = PortMesh(("pod", "data", "model"), (2, 4, 16))
    pol = ActivationPolicy(mesh, ("pod", "data"))
    assert row_axes(pol, mesh, 16) == ["pod", "data"]
    assert row_axes(pol, mesh, 6) == ["pod"]  # 6 rows do not split 8 ways
    assert row_axes(pol, mesh, 3) == []
    # 8 rows of 4 tokens in groups of 8: 2 ranks hold 16 tokens each, 8 hold 4
    assert row_axes(pol, mesh, 8, tokens_per_row=4, group=8) == ["pod"]
    one = PortMesh(("data", "model"), (1, 1))
    assert row_axes(ActivationPolicy(one, "data"), one, 8) == []  # one rank: nothing splits
    from torch.distributed.tensor import Partial, Replicate, Shard

    assert mesh_placements(mesh, {"data": Shard(0), "model": Shard(2)}) == \
        (Replicate(), Shard(0), Shard(2))
    assert mesh_placements(one, {"data": Shard(0)}, other=Partial()) == \
        (Replicate(), Replicate())  # a dim of one rank replicates


# ---------------- multi-rank (gloo) ------------------------------------------


SPAWN_TIMEOUT_S = 300  # the 2x2 group takes ~15 s alone


def _spawn(fn, world: int, directory) -> dict:
    ctx = mp.start_processes(fn, args=(world, str(directory)), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):  # raises if a rank failed
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{fn.__name__} did not finish in {SPAWN_TIMEOUT_S} s")
    name = "run_2x2.pt" if fn is worker.run_2x2 else "run_1x1.pt"
    return torch.load(directory / name, weights_only=False)


@pytest.fixture(scope="module")
def run_2x2(tmp_path_factory):
    return _spawn(worker.run_2x2, 4, tmp_path_factory.mktemp("gloo_2x2"))


@pytest.fixture(scope="module")
def run_1x1(tmp_path_factory):
    return _spawn(worker.run_1x1_families, 1, tmp_path_factory.mktemp("gloo_1x1"))


def _reference_step(name: str, arch: str):
    cfg = ref_base.get_arch(arch).reduced()
    tree = lm_params_numpy(get_arch(arch).reduced(), 5)
    batch = worker.train_batch(cfg, *worker.TRAIN_SHAPE[name])
    ref = RefModel(cfg)
    rtcfg = RefTrainConfig(optimizer=ref_opt.OptimizerConfig(**worker.TRAIN_OPT),
                           micro_steps=worker.MICRO_STEPS.get(name, 1))
    params = jax.tree.map(jnp.asarray, tree)
    jbatch = jax.tree.map(jnp.asarray, batch)
    grads = jax.jit(jax.grad(lambda p, b: ref.loss(p, b)[0]))(params, jbatch)
    new, _, metrics = jax.jit(ref_make_train_step(ref, rtcfg))(
        params, ref_opt.init(rtcfg.optimizer, params), jbatch)
    return new, metrics, grads


@pytest.mark.parametrize("name,arch", [("qwen3_0_6b", "qwen3_0_6b"),
                                       ("qwen2_moe_a2_7b", "qwen2_moe_a2_7b"),
                                       ("qwen2_moe_long", "qwen2_moe_a2_7b"),
                                       ("jamba_v0_1_52b", "jamba_v0_1_52b"),
                                       ("rwkv6_1_6b", "rwkv6_1_6b"),
                                       ("qwen3_micro2", "qwen3_0_6b")])
def test_sharded_train_step_matches_reference(run_2x2, name, arch):
    got = run_2x2[name]
    want, metrics, grads = _reference_step(name, arch)
    assert got["step"] == 1
    for key, value in got["metrics"].items():
        np.testing.assert_allclose(value, float(metrics[key]), rtol=STEP_TOL, atol=STEP_TOL,
                                   err_msg=key)
    kept = moved = 0
    for (path, g), w, gr in zip(jax.tree_util.tree_flatten_with_path(got["params"])[0],
                                jax.tree.leaves(want), jax.tree.leaves(grads)):
        keep = np.abs(np.asarray(gr)) > GRAD_FLOORS.get(name, GRAD_FLOOR)
        np.testing.assert_allclose(g[keep], np.asarray(w)[keep], rtol=STEP_TOL, atol=STEP_TOL,
                                   err_msg=jax.tree_util.keystr(path))
        # experts no token reached have zero gradients: they are not counted
        kept, moved = kept + int(keep.sum()), moved + int((np.asarray(gr) != 0).sum())
    assert kept >= MIN_KEPT.get(name, 0.99) * moved


@pytest.mark.parametrize("name", ["qwen2_moe_a2_7b", "qwen2_moe_long"])
def test_sharded_moe_routes_equal_index_for_index(run_2x2, name):
    got = run_2x2[name]
    assert got["route_calls"] == get_arch("qwen2_moe_a2_7b").reduced().n_layers
    assert got["route_mismatches"] == 0


def test_sharded_decode_matches_reference(run_2x2):
    got = run_2x2["decode"]
    cfg = ref_base.get_arch("qwen3_0_6b").reduced()
    ref = RefModel(cfg)
    params = jax.tree.map(jnp.asarray, lm_params_numpy(get_arch("qwen3_0_6b").reduced(), 1))
    prompt, tok = worker.decode_inputs(cfg)
    b, s = worker.DECODE_B, worker.DECODE_S
    last, cache = jax.jit(ref.prefill)(params, {"tokens": jnp.asarray(prompt)},
                                       ref.init_cache(b, s + 4))
    logits, cache = jax.jit(ref.decode_step)(params, jnp.asarray(tok), cache, jnp.int32(s))
    v = cfg.vocab
    np.testing.assert_allclose(got["prefill_logits"][..., :v], np.asarray(last)[..., :v],
                               rtol=DECODE_TOL, atol=DECODE_TOL)
    np.testing.assert_allclose(got["logits"][..., :v], np.asarray(logits)[..., :v],
                               rtol=DECODE_TOL, atol=DECODE_TOL)
    np.testing.assert_allclose(got["k0"], np.asarray(cache["blocks"][0]["k"]),
                               rtol=DECODE_TOL, atol=DECODE_TOL)
    assert np.array_equal(got["next_tok"][:, 0], np.argmax(got["logits"][:, -1], axis=-1))
    # the cache is sequence-sharded over "model", as the reference's cache_specs say
    assert got["cache_placements"] == ["S(0)", "S(1)"] == got["k0_placements"]


def test_decode_cache_write_lands_on_the_owning_rank(run_2x2):
    got = run_2x2["cache_write"]
    assert got["full_sum"] == 21.0
    np.testing.assert_array_equal(got["at5"], [[1, 2, 3], [4, 5, 6]])
    # on each of the two "data" rows one of the two "model" ranks holds position 5
    assert got["owners"] == 2 and got["landed"] == 2 and got["untouched"] == got["world"] == 4


def test_restore_sharded_and_remesh_move_to_another_mesh(run_2x2):
    got = run_2x2["checkpoint"]
    assert got["step"] == 1 and got["max_diff"] == 0.0
    assert got["mesh41"] == ["data", "model"] and got["shape41"] == [4, 1]
    # placed as the 4x1 mesh's specs say; its one-rank "model" dim replicates
    assert got["placements"]["blocks.0.attn.wq"] == ["S(0)", "R"]
    assert got["placements"]["embed.tok"] == ["R", "R"]


@pytest.mark.parametrize("arch", list_archs())
def test_family_loss_and_grads_on_a_one_rank_mesh(run_1x1, arch):
    got = run_1x1[arch]
    assert got["loss"][0] == got["loss"][1]
    assert got["grad_max_diff"] <= ONE_RANK_GRAD_TOL * max(1.0, got["grad_max"])
