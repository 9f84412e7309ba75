"""Worker processes of ``tests/test_torch_distributed.py``: the port's
sharded steps on ``gloo`` CPU meshes, spawned by the tests.

Each worker joins a ``gloo`` process group through a ``FileStore`` under
the test's temporary directory (no TCP port), runs one group of cases and,
on rank 0, saves what the test compares to ``<dir>/<name>.pt``.  This
module imports the port only, never JAX, so the children start quickly;
the tests hold the results against the JAX package.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

TRAIN_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=4)
TRAIN_SHAPE = {"qwen3_0_6b": (8, 16), "qwen2_moe_a2_7b": (8, 16), "qwen2_moe_long": (4, 256),
               "jamba_v0_1_52b": (4, 16), "rwkv6_1_6b": (4, 16), "qwen3_micro2": (8, 16)}
MICRO_STEPS = {"qwen3_micro2": 2}
DECODE_B, DECODE_S = 4, 16


def train_batch(cfg, batch: int, seq: int, seed: int = 11) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)}


def decode_inputs(cfg, seed: int = 12) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab, (DECODE_B, DECODE_S)).astype(np.int32),
            rng.integers(0, cfg.vocab, (DECODE_B, 1)).astype(np.int32))


def _join(rank: int, world: int, directory: str) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(directory, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)


def _full(t: torch.Tensor) -> torch.Tensor:
    from repro_torch.distributed.context import whole

    return whole(t.detach())


class _Routes:
    """Records the routing of every ``moe.route`` call (expert indices,
    queue places, kept mask) while installed."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.orig, self.calls = moe, moe.route, []

    def __enter__(self):
        def rec(*args, **kwargs):
            r = self.orig(*args, **kwargs)
            self.calls.append(tuple(t.detach().clone() for t in (r.idx, r.pos, r.keep)))
            return r

        self.moe.route = rec
        return self

    def __exit__(self, *exc):
        self.moe.route = self.orig


def _train_case(name: str, arch: str, mesh, out: dict) -> None:
    from repro_torch.configs.base import get_arch
    from repro_torch.interop import lm_params_numpy, lm_params_to_numpy, load_lm_params
    from repro_torch.models import Model
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import TrainConfig, jit_train_step

    cfg = get_arch(arch).reduced()
    batch = train_batch(cfg, *TRAIN_SHAPE[name])
    tree = lm_params_numpy(cfg, 5)
    tcfg = TrainConfig(optimizer=opt.OptimizerConfig(**TRAIN_OPT),
                       micro_steps=MICRO_STEPS.get(name, 1))
    routes = []
    if cfg.n_experts:  # the unsharded port's routing of the same batch
        ref = load_lm_params(Model(cfg, device="cpu"), tree)
        with _Routes() as r:
            ref.loss({k: torch.from_numpy(v) for k, v in batch.items()})
        routes = r.calls
    model = load_lm_params(Model(cfg, device="cpu"), tree)
    step = jit_train_step(model, mesh, tcfg)(batch)
    state = opt.init(tcfg.optimizer, dict(model.named_parameters()))
    with _Routes() as r:
        state, metrics = step(state, batch)
    mismatched = 0
    if cfg.n_experts:
        # a rank routes all groups, or (tokens sharded) its data rank's
        coord = mesh.get_local_rank("data")
        for got, want in zip(r.calls, routes):
            g = got[0].shape[0]
            lo = coord * g if g < want[0].shape[0] else 0
            mismatched += sum(int((a != b[lo:lo + g]).sum()) for a, b in zip(got, want))
        mismatched += int(len(r.calls) < len(routes))  # remat routes again after these
    total = torch.tensor([mismatched])
    dist.all_reduce(total)
    params = lm_params_to_numpy(model, {n: _full(p) for n, p in model.named_parameters()})
    out[name] = {"metrics": {k: float(v) for k, v in metrics.items()},
                 "params": params, "route_mismatches": int(total), "route_calls": len(routes),
                 "step": int(state["step"])}


def _decode_case(mesh, out: dict) -> None:
    from repro_torch.configs.base import get_arch
    from repro_torch.interop import lm_params_numpy, load_lm_params
    from repro_torch.models import Model
    from repro_torch.serve.legacy.serve_step import jit_serve_steps

    cfg = get_arch("qwen3_0_6b").reduced()
    prompt, tok = decode_inputs(cfg)
    model = load_lm_params(Model(cfg, device="cpu"), lm_params_numpy(cfg, 1))
    prefill, decode, cache_pl = jit_serve_steps(model, mesh, DECODE_B, DECODE_S + 4)
    cache = model.init_cache(DECODE_B, DECODE_S + 4)
    last, cache = prefill({"tokens": prompt}, cache)
    next_tok, logits, cache = decode(tok, cache, DECODE_S)
    k0 = cache["blocks"][0]["k"]
    out["decode"] = {"prefill_logits": last.numpy(), "logits": logits.numpy(),
                     "next_tok": next_tok.numpy(), "k0": _full(k0).numpy(),
                     "k0_placements": [str(p) for p in k0.placements],
                     "cache_placements": [str(p) for p in cache_pl["blocks"][0]["k"]]}


def _cache_write_case(mesh, out: dict) -> None:
    """The decode write into a sequence-sharded cache: a (2, 8, 3) DTensor
    sharded on dim 1 over "model", written at 5."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.distributed.context import local_range, write_along

    cache = distribute_tensor(torch.zeros(2, 8, 3), mesh, (Replicate(), Shard(1)),
                              src_data_rank=None)
    value = torch.arange(1.0, 7.0).reshape(2, 1, 3)
    write_along(cache, 5, value)
    off, length = local_range(8, mesh, cache.placements, 1)
    owns = off <= 5 < off + length
    local = cache.to_local()
    landed = bool(owns and torch.equal(local[:, 5 - off:6 - off], value))
    untouched = float(local.abs().sum()) == (float(value.abs().sum()) if owns else 0.0)
    flags = torch.tensor([int(landed), int(owns), int(untouched)])
    dist.all_reduce(flags)
    full = cache.full_tensor()
    out["cache_write"] = {"full_sum": float(full.sum()), "at5": full[:, 5].numpy(),
                          "landed": int(flags[0]), "owners": int(flags[1]),
                          "untouched": int(flags[2]), "world": dist.get_world_size()}


def _checkpoint_case(mesh, directory: str, rank: int, out: dict) -> None:
    """Save a 2x2-placed tree and bring it to a 4x1 mesh by
    ``restore_sharded`` and by ``remesh``."""
    from repro_torch.configs.base import get_arch
    from repro_torch.distributed import sharding as shd
    from repro_torch.interop import lm_params_numpy, load_lm_params
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.models import Model
    from repro_torch.train.checkpoint import Checkpointer
    from repro_torch.train.fault_tolerance import remesh

    cfg = get_arch("qwen3_0_6b").reduced()
    model = load_lm_params(Model(cfg, device="cpu"), lm_params_numpy(cfg, 2))
    whole = {n: p.detach().clone() for n, p in model.named_parameters()}
    specs = shd.param_specs(model, mesh)
    tree = shd.place_tree(whole, mesh, shd.shardings(mesh, specs))
    ckpt = Checkpointer(os.path.join(directory, f"ckpt_r{rank}"))
    ckpt.save(1, tree)
    mesh41 = make_dev_mesh(4, model=1, device="cpu")
    specs41 = shd.param_specs(model, mesh41)
    restored, step = ckpt.restore_sharded(whole, mesh41, specs41)
    moved = remesh(tree, mesh41, specs41)
    diffs = [float((_full(restored[n]) - w).abs().max()) for n, w in whole.items()]
    diffs += [float((_full(moved[n]) - w).abs().max()) for n, w in whole.items()]
    out["checkpoint"] = {
        "step": step, "max_diff": max(diffs),
        "placements": {n: [str(p) for p in restored[n].placements] for n in whole},
        "specs41": {n: list(s) for n, s in specs41.items()},
        "mesh41": list(mesh41.mesh_dim_names), "shape41": list(mesh41.shape)}


def run_2x2(rank: int, world: int, directory: str) -> None:
    """The 2x2 ("data", "model") cases: the train steps, decode, the cache
    write, checkpoints."""
    _join(rank, world, directory)
    from repro_torch.launch.mesh import make_dev_mesh

    mesh = make_dev_mesh(world, model=2, device="cpu")
    out: dict = {}
    _train_case("qwen3_0_6b", "qwen3_0_6b", mesh, out)
    _train_case("qwen2_moe_a2_7b", "qwen2_moe_a2_7b", mesh, out)
    _train_case("qwen2_moe_long", "qwen2_moe_a2_7b", mesh, out)
    _train_case("jamba_v0_1_52b", "jamba_v0_1_52b", mesh, out)
    _train_case("rwkv6_1_6b", "rwkv6_1_6b", mesh, out)
    _train_case("qwen3_micro2", "qwen3_0_6b", mesh, out)
    _decode_case(mesh, out)
    _cache_write_case(mesh, out)
    _checkpoint_case(mesh, directory, rank, out)
    if rank == 0:
        torch.save(out, os.path.join(directory, "run_2x2.pt"))
    dist.barrier()
    dist.destroy_process_group()


def run_1x1_families(rank: int, world: int, directory: str) -> None:
    """Every family's ``reduced()`` loss and gradients on a 1x1 mesh against
    the same model unsharded."""
    _join(rank, world, directory)
    from repro_torch.configs.base import get_arch, list_archs
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.context import ActivationPolicy, activation_policy
    from repro_torch.interop import context_inputs_numpy, lm_params_numpy, load_lm_params
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.models import Model
    from torch.distributed.tensor.experimental import implicit_replication

    mesh = make_dev_mesh(1, model=1, device="cpu")
    out = {}
    for arch in list_archs():
        cfg = get_arch(arch).reduced()
        tree = lm_params_numpy(cfg, 4)
        batch = {k: torch.from_numpy(v) for k, v in train_batch(cfg, 2, 16).items()}
        batch.update({k: torch.from_numpy(v)
                      for k, v in context_inputs_numpy(cfg, batch=2, seed=3).items()})
        plain = load_lm_params(Model(cfg, device="cpu"), tree)
        loss0, _ = plain.loss(batch)
        grads0 = torch.autograd.grad(loss0, list(plain.parameters()))
        model = load_lm_params(Model(cfg, device="cpu"), tree)
        shd.place_parameters(model, mesh, shd.param_specs(model, mesh))
        pls = shd.shardings(mesh, shd.batch_specs(mesh, batch))
        dbatch = {k: shd.place(v, mesh, pls[k]) for k, v in batch.items()}
        with activation_policy(ActivationPolicy(mesh, shd.batch_axes(mesh))), \
                implicit_replication():
            loss, _ = model.loss(dbatch)
            grads = torch.autograd.grad(loss, list(model.parameters()))
        out[arch] = {"loss": (float(loss0.detach()), float(_full(loss))),
                     "grad_max_diff": max(float((_full(g) - h).abs().max())
                                          for g, h in zip(grads, grads0)),
                     "grad_max": max(float(h.abs().max()) for h in grads0)}
    torch.save(out, os.path.join(directory, "run_1x1.pt"))
    dist.destroy_process_group()
