"""Sharding rules: parameter, batch and cache specs, and their DTensor
placements (port of ``repro/distributed/sharding.py``).

Mesh axes, as the reference's:
  single-pod: ("data", "model") = (16, 16)
  multi-pod:  ("pod", "data", "model") = (pods, 16, 16)

Logical placement:
  batch  -> ("pod", "data")   pure DP across pods
  fsdp   -> "data"            ZeRO-3 parameter/optimizer sharding
  tensor -> "model"           megatron TP: heads / ffn / vocab
  expert -> "model"           MoE expert parallelism
  cache sequence -> "model"   decode KV caches are sequence-sharded

A spec is a ``P``: one entry per tensor dim, each ``None`` (replicated), a
mesh axis name, or a tuple of names (the dim split over several axes,
major first).  Rules are matched on the parameter's dotted name with dots
read as slashes (``blocks/3/attn/wq``); the first match wins and unmatched
leaves are replicated.  The port keeps one module per layer, not a stacked
repeats axis, so a port spec is the reference's without its leading
``None``.

``shardings(mesh, specs)`` turns specs into DTensor placements, one per
mesh dim: a tensor dim over ``("pod", "data")`` is ``Shard(d)`` on both of
those mesh dims, which DTensor splits in mesh-dim order, as the reference
splits major to minor.  A mesh is a ``DeviceMesh`` with named dims, or any
object with ``mesh_dim_names`` and ``shape``.
"""
from __future__ import annotations

import re
from typing import Any

import torch


class P(tuple):
    """A partition spec: ``P("data", "model")``, ``P(("pod", "data"), None)``.
    A one-name tuple is kept as the name, as JAX's ``PartitionSpec`` keeps
    it."""

    def __new__(cls, *parts):
        return super().__new__(cls, (p[0] if isinstance(p, tuple) and len(p) == 1 else p
                                     for p in parts))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def batch_axes(mesh):
    """Axes the global batch is sharded over."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def effective_batch_axes(mesh, batch_size: int):
    """Largest prefix of the DP axes whose product divides the batch; a
    small serving batch replicates over the axes that do not divide it."""
    sizes = _axis_sizes(mesh)
    axes = []
    prod = 1
    for ax in batch_axes(mesh):
        if batch_size % (prod * sizes[ax]) == 0:
            axes.append(ax)
            prod *= sizes[ax]
    return tuple(axes)


def _names(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def _divisible_spec(spec: P, shape, mesh) -> P:
    """Drop sharding on dims the mesh axes do not divide (qwen2-moe's 60
    experts on a 16-way model axis stay replicated)."""
    sizes = _axis_sizes(mesh)
    parts = []
    for dim, entry in enumerate(spec):
        if entry is None:
            parts.append(None)
            continue
        prod = 1
        for nm in _names(entry):
            prod *= sizes.get(nm, 1)
        parts.append(entry if shape[dim] % prod == 0 else None)
    return P(*parts)


# (pattern, spec) matched on the path without a stacked-repeats axis; the
# reference's table, its comments kept where they explain a choice
_PARAM_RULES: list[tuple[str, P]] = [
    # embeddings / unembedding: vocab-sharded only (FSDP on d_model would
    # collide with the token gather's batch sharding)
    (r"embed/tok$", P("model", None)),
    (r"embed/head$", P(None, "model")),
    # attention
    (r"(attn|cross)/w[qkv]$", P("data", "model")),
    (r"(attn|cross)/b[qkv]$", P("model")),
    (r"(attn|cross)/wo$", P("model", "data")),
    (r"(attn|cross)/(q_norm|k_norm)/scale$", P()),
    # dense mlp (incl. moe shared/dense residual)
    (r"(mlp|shared|dense)/w[gi]$", P("data", "model")),
    (r"(mlp|shared|dense)/wo$", P("model", "data")),
    # moe experts: expert-parallel over "model", fsdp on d_model
    (r"moe/router$", P("data", None)),
    (r"moe/w[gi]$", P("model", "data", None)),
    (r"moe/wo$", P("model", None, "data")),
    # mamba
    (r"mixer/in_proj$", P("data", "model")),
    (r"mixer/conv_w$", P(None, "model")),
    (r"mixer/conv_b$", P("model")),
    (r"mixer/x_proj$", P("model", None)),
    (r"mixer/dt_proj$", P(None, "model")),
    (r"mixer/dt_bias$", P("model")),
    (r"mixer/A_log$", P("model", None)),
    (r"mixer/D$", P("model")),
    (r"mixer/out_proj$", P("model", "data")),
    # rwkv time mix
    (r"mixer/w[rkvg]$", P("data", "model")),
    (r"mixer/wo$", P("model", "data")),
    (r"mixer/wa$", P("data", None)),
    (r"mixer/wb$", P(None, "model")),
    (r"mixer/u$", P("model", None)),
    (r"mixer/(mu_[rkvwg]|w0)$", P()),
    (r"mixer/ln_x/scale$", P()),
    # rwkv channel mix
    (r"ffn/wk$", P("data", "model")),
    (r"ffn/wv$", P("model", "data")),
    (r"ffn/wr$", P("data", "model")),
    (r"ffn/mu_[rk]$", P()),
    # norms
    (r"(norm1|norm2|norm_cross|final_norm|ln_x)/(scale|bias)$", P()),
]


def _path_str(name: str) -> str:
    return name.replace(".", "/")


def _spec_for(path_s: str, ndim: int) -> P:
    for pat, spec in _PARAM_RULES:
        if re.search(pat, path_s):
            parts = tuple(spec) + (None,) * (ndim - len(spec))  # trailing dims replicated
            if len(parts) != ndim:
                raise ValueError(f"{path_s}: spec {parts} vs rank {ndim}")
            return P(*parts)
    return P(*([None] * ndim))


def _shapes(tensors) -> dict:
    """name -> shape of an ``nn.Module``'s parameters or a dict of tensors."""
    items = tensors.named_parameters() if isinstance(tensors, torch.nn.Module) else tensors.items()
    return {name: tuple(t.shape) for name, t in items}


def param_specs(model, mesh=None) -> dict:
    """name -> ``P`` of every parameter of ``model`` (an ``nn.Module`` or a
    dict of tensors).  With a mesh, a dim its axes do not divide is
    replicated."""
    specs = {}
    for name, shape in _shapes(model).items():
        spec = _spec_for(_path_str(name), len(shape))
        specs[name] = spec if mesh is None else _divisible_spec(spec, shape, mesh)
    return specs


def batch_specs(mesh, batch: dict) -> dict:
    """Batch dict: the leading dim is the global batch (divisibility-aware)."""
    specs = {}
    for key, leaf in batch.items():
        b = effective_batch_axes(mesh, leaf.shape[0])
        specs[key] = P(b if b else None, *([None] * (len(leaf.shape) - 1)))
    return specs


def _cache_leaf_spec(mesh, path_s: str, shape) -> P:
    ndim = len(shape)
    b = (effective_batch_axes(mesh, shape[0]) or None) if ndim >= 1 else None
    spec = None
    if path_s == "kv_src":
        spec = P(b, *([None] * (ndim - 1)))
    elif re.search(r"/(k|v)$", path_s) and ndim == 4:
        spec = P(b, "model", None, None)
    elif re.search(r"/h$", path_s) and ndim == 3:  # mamba (B, d_in, ds)
        spec = P(b, "model", None)
    elif re.search(r"/conv$", path_s) and ndim == 3:  # (B, K-1, d_in)
        spec = P(b, None, "model")
    elif re.search(r"/s$", path_s) and ndim == 4:  # rwkv (B, nh, hd, hd)
        spec = P(b, "model", None, None)
    elif re.search(r"/x_prev_(att|ffn)$", path_s) and ndim == 2:
        spec = P(b, None)
    if spec is None:
        return P(*([None] * ndim))
    return _divisible_spec(spec, shape, mesh)


def cache_specs(mesh, cache: Any, _path: str = "") -> Any:
    """The serving cache's specs, in its own structure (``{"blocks": [one
    dict a layer], "kv_src"}``).  Attention K/V (B, S, nkv, hd): batch over
    the DP axes, *sequence* over "model" (context-parallel decode).  SSM
    states: batch over DP, feature dim over "model".  kv_src: batch only."""
    if isinstance(cache, dict):
        return {k: cache_specs(mesh, v, f"{_path}{k}/") for k, v in cache.items()}
    if isinstance(cache, (list, tuple)):
        return type(cache)(cache_specs(mesh, v, f"{_path}{i}/") for i, v in enumerate(cache))
    return _cache_leaf_spec(mesh, _path.rstrip("/"), tuple(cache.shape))


def placements(mesh, spec: P) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``, one per mesh dim.  A
    mesh dim of one rank replicates: a shard of one is the whole tensor,
    and DTensor's view rules refuse some reshapes of a dim marked sharded
    even there."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = _axis_sizes(mesh)
    out = []
    for axis in mesh.mesh_dim_names:
        dims = [d for d, entry in enumerate(spec) if entry is not None
                and axis in _names(entry)]
        out.append(Shard(dims[0]) if dims and sizes[axis] > 1 else Replicate())
    return tuple(out)


def shardings(mesh, specs: Any) -> Any:
    """``specs`` (a ``P`` or a dict/list tree of them) as placements."""
    if isinstance(specs, P):
        return placements(mesh, specs)
    if isinstance(specs, dict):
        return {k: shardings(mesh, v) for k, v in specs.items()}
    return type(specs)(shardings(mesh, v) for v in specs)


# ---------------------------------------------------------------------------
# placing tensors: the reference's device_put onto NamedShardings
# ---------------------------------------------------------------------------


def place(t: torch.Tensor, mesh, placements_) -> torch.Tensor:
    """``t`` as a DTensor on ``mesh`` with ``placements_``.  A plain ``t`` is
    the whole tensor, the same on every rank: each rank keeps its shard
    (contiguous), with no communication.  A DTensor on ``mesh`` is
    redistributed; one on another mesh is gathered whole first."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    placements_ = tuple(placements_)
    if isinstance(t, DTensor):
        if t.device_mesh == mesh:
            return t if tuple(t.placements) == placements_ else t.redistribute(mesh, placements_)
        t = t.full_tensor()
    d = distribute_tensor(t.detach(), mesh, placements_, src_data_rank=None)
    local = d.to_local()
    if not local.is_contiguous():
        d = DTensor.from_local(local.contiguous(), mesh, placements_, run_check=False,
                               shape=d.shape, stride=d.stride())
    return d


def place_tree(tree: Any, mesh, placements_tree: Any) -> Any:
    """``place`` over a dict/list tree of tensors and its placements."""
    if isinstance(tree, dict):
        return {k: place_tree(v, mesh, placements_tree[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place_tree(v, mesh, pl) for v, pl in zip(tree, placements_tree))
    return place(tree, mesh, placements_tree)


@torch.no_grad()
def place_parameters(model: torch.nn.Module, mesh, specs: dict) -> torch.nn.Module:
    """Replace each of ``model``'s parameters, in place, by a DTensor
    parameter placed by ``specs`` (name -> ``P``).  Returns the model."""
    pls = shardings(mesh, specs)
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner)
        module._parameters[leaf] = torch.nn.Parameter(
            place(p.data, mesh, pls[name]), requires_grad=p.requires_grad)
    return model
