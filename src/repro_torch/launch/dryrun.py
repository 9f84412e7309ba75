"""Dry run of the production meshes (port of ``repro/launch/dryrun.py``).

For each architecture and input shape, the sharded train step, prefill or
decode runs once with the production placements on the single-pod 16x16
mesh and the 2x16x16 multi-pod one, without the hardware: this process is
rank 0 of PyTorch's fake process group of 256 or 512 ranks (its
collectives return at once), and every tensor is a fake one
(``FakeTensorMode``: shapes and dtypes, no storage).  The model is built
on ``meta``, then given fake parameters, which ``jit_train_step`` /
``jit_serve_steps`` place as their DTensor shards.  The reference lowers
and compiles instead; its ``memory_analysis`` and HLO analysis become the
op counter's live bytes and per-device counts here
(``roofline/counter.py``), which feed the roofline terms on the H100
(``roofline/analysis.py``).

Usage:
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
  python -m repro_torch.launch.dryrun --arch qwen3_0_6b --shape decode_32k --mesh single

``--device`` names the device type the fake tensors claim (default the
card, ``cuda``; ``cpu`` runs where there is none).  Results are written
incrementally to ``<out>/<mesh>/<arch>__<shape>.json`` (default
``results/dryrun_torch``), so a long sweep can resume; ``--force`` redoes
cells already written.  The record has the reference's keys, with the
counter's block named ``op_analysis`` (not ``hlo_analysis``).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch
from torch import nn

from repro_torch.configs.base import SHAPES, ShapeSpec, get_arch, list_archs
from repro_torch.roofline.analysis import model_flops, roofline_terms
from repro_torch.roofline.counter import OpCounter
from repro_torch.train import optimizer as opt

BIG_MODEL_PARAMS = 100e9  # above this, optimizer moments are kept in bf16


def optimizer_config_for(cfg) -> opt.OptimizerConfig:
    big = cfg.param_count() > BIG_MODEL_PARAMS
    return opt.OptimizerConfig(moment_dtype="bfloat16" if big else "float32", aggressive=big)


def input_specs(cfg, shape: ShapeSpec, device) -> dict:
    """Stand-ins (zeros; fake under ``FakeTensorMode``) for every model
    input of this cell."""
    b = shape.global_batch
    ints = dict(dtype=torch.int32, device=device)
    if shape.kind == "decode":
        specs = {"tokens": torch.zeros(b, 1, **ints)}
    else:
        specs = {"tokens": torch.zeros(b, shape.seq_len, **ints)}
        if shape.kind == "train":
            specs["labels"] = torch.zeros(b, shape.seq_len, **ints)
    embeds = dict(dtype=torch.bfloat16, device=device)
    if cfg.n_enc_layers:
        specs["enc_frames"] = torch.zeros(b, cfg.n_frames, cfg.d_model, **embeds)
    if cfg.cross_attn_every:
        specs["img_embeds"] = torch.zeros(b, cfg.n_img_tokens, cfg.d_model, **embeds)
    return specs


def fake_world(world: int) -> None:
    """Make this process rank 0 of a fake process group of ``world`` ranks
    (re-made when the size changes)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


@contextlib.contextmanager
def _strided_shard_outside_fake_mode():
    """DTensor sizes a ``_StridedShard`` (a reshape of a sharded dim) by
    splitting an index tensor, which under ``FakeTensorMode`` becomes fake
    and cannot be read back.  The sizes depend on shapes only, so they are
    computed with fake mode set aside."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor.placement_types import _StridedShard

    orig = _StridedShard.local_shard_size_and_offset

    def sized(*args, **kwargs):
        with unset_fake_temporarily():
            return orig(*args, **kwargs)

    _StridedShard.local_shard_size_and_offset = sized
    try:
        yield
    finally:
        _StridedShard.local_shard_size_and_offset = orig


def _fake_model(cfg, device):
    """``Model(cfg)`` built on ``meta``, its parameters then replaced by
    fake ones on ``device`` (the caller holds the ``FakeTensorMode``)."""
    from repro_torch.models.model import Model

    model = Model(cfg, device="meta")
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        model.get_submodule(owner)._parameters[leaf] = nn.Parameter(
            torch.empty(p.shape, dtype=p.dtype, device=device))
    model.device = torch.device(device)
    return model


def lower_cell(arch_id: str, shape_name: str, multi_pod: bool, device: str = "cuda",
               top: int = 8) -> dict:
    """Run one cell on the fake world; its record (``status`` "ok", or
    "skipped" with the reason)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed.sharding import place_tree
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.serve.legacy.serve_step import jit_serve_steps
    from repro_torch.train.train_step import TrainConfig, jit_train_step

    cfg = get_arch(arch_id)
    shape = SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    ok, why = cfg.shape_applicable(shape_name)
    if not ok:
        return {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": why}

    t0 = time.perf_counter()
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
    counter = OpCounter(track_memory=True)
    with FakeTensorMode(), _strided_shard_outside_fake_mode():
        model = _fake_model(cfg, device)
        specs = input_specs(cfg, shape, device)
        if shape.kind == "train":
            tcfg = TrainConfig(optimizer=optimizer_config_for(cfg))
            step = jit_train_step(model, mesh, tcfg)(specs)
            state = opt.init(tcfg.optimizer, dict(model.named_parameters()))
            counter.track([list(model.parameters()), state])
            argument_bytes = counter.live_bytes
            setup_s = time.perf_counter() - t0
            with counter:
                step(state, specs)
            step_kind, flops_kind = "train_step", "train"
            tokens = shape.global_batch * shape.seq_len
        else:
            prefill, decode, cache_pl = jit_serve_steps(model, mesh, shape.global_batch,
                                                        shape.seq_len, batch_example=specs)
            # the cache is an argument placed before the step, as the
            # reference's in_shardings take it: prefill and decode find it
            # placed and copy nothing
            cache = place_tree(model.init_cache(shape.global_batch, shape.seq_len), mesh,
                               cache_pl)
            counter.track([list(model.parameters()), cache])
            argument_bytes = counter.live_bytes
            setup_s = time.perf_counter() - t0
            with counter:
                if shape.kind == "prefill":
                    prefill(specs, cache)
                    step_kind, tokens = "prefill_step", shape.global_batch * shape.seq_len
                else:  # one new token against a full cache
                    decode(specs["tokens"], cache, shape.seq_len - 1)
                    step_kind, tokens = "serve_step", shape.global_batch
            flops_kind = "inference"
    run_s = time.perf_counter() - t0 - setup_s

    stats = counter.analysis()
    chips = mesh.size()
    flops_dev = stats["flops"]
    terms = roofline_terms(flops_dev, stats["bytes"], stats["collective_bytes"])
    mflops = model_flops(cfg, tokens, flops_kind)
    return {
        "arch": arch_id,
        "shape": shape_name,
        "mesh": mesh_name,
        "chips": chips,
        "status": "ok",
        "step_kind": step_kind,
        "device": device,
        "setup_s": setup_s,
        "run_s": run_s,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "tokens_per_step": tokens,
        "memory": {"peak_bytes": int(counter.peak_bytes),
                   "argument_bytes": argument_bytes},
        "op_analysis": {
            "flops_per_device": flops_dev,
            "bytes_per_device": stats["bytes"],
            "collective_bytes_per_device": stats["collective_bytes"],
            "collectives_by_op": stats["collectives_by_op"],
            "n_loops": stats["n_loops"],
            "top_ops": {by: counter.top_ops(top, by)
                        for by in ("traffic", "collective", "flops")},
            "top_shapes": counter.top_shapes(top),
        },
        "roofline": terms,
        "model_flops_total": mflops,
        "model_flops_per_device": mflops / chips,
        "useful_flops_ratio": (mflops / chips) / flops_dev if flops_dev else None,
    }


def cells(mesh_sel: str):
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[mesh_sel]
    for arch in list_archs():
        for shape in SHAPES:
            for mp in meshes:
                yield arch, shape, mp


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--device", default=None,
                    help="device type of the fake tensors (default: the card, cuda)")
    args = ap.parse_args(argv)

    from repro_torch.kernels._platform import resolve_device

    try:
        device = resolve_device(args.device).type
    except RuntimeError as e:
        print(f"error: {e}")
        return 2
    if args.all:
        todo = list(cells(args.mesh))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
        todo = [(args.arch, args.shape, mp) for mp in meshes]

    os.makedirs(args.out, exist_ok=True)
    n_ok = n_skip = n_err = 0
    for arch, shape, mp in todo:
        mesh_name = "multi" if mp else "single"
        path = os.path.join(args.out, mesh_name, f"{arch}__{shape}.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if os.path.exists(path) and not args.force:
            print(f"[skip-existing] {arch} {shape} {mesh_name}")
            continue
        print(f"[dry-run] {arch} {shape} {mesh_name} ...", flush=True)
        try:
            rec = lower_cell(arch, shape, mp, device)
        except Exception:
            rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                   "status": "error", "traceback": traceback.format_exc()}
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        st = rec["status"]
        n_ok += st == "ok"
        n_skip += st == "skipped"
        n_err += st == "error"
        if st == "ok":
            r = rec["roofline"]
            print(f"  ok in {rec['setup_s']:.2f}+{rec['run_s']:.2f}s | "
                  f"peak {rec['memory']['peak_bytes'] / 2**30:.2f} GiB | "
                  f"compute {r['compute_s'] * 1e3:.2f}ms mem {r['memory_s'] * 1e3:.2f}ms "
                  f"coll {r['collective_s'] * 1e3:.2f}ms -> {r['dominant']}-bound", flush=True)
        elif st == "skipped":
            print(f"  skipped: {rec['reason']}")
        else:
            print("  ERROR:\n" + rec["traceback"].splitlines()[-1])
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
