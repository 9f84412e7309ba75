"""Carry state into the port from plain numpy arrays and dicts.

The simulator has no weights; its state is graphs, DRAM/controller
configurations, accelerator configurations and request traces.  These
functions build the port's objects from the reference's objects flattened
to numpy arrays and plain dicts (``dataclasses.asdict``), so a caller can
hand both packages the same inputs without the port importing the
reference.  The LM scaffolding's weights cross the same way:
``lm_params_numpy`` makes a numpy parameter tree in the reference's layout,
``load_lm_params`` carries such a tree (or a real reference init turned
into numpy) into the port's ``Model``, and ``lm_params_to_numpy`` turns the
model's parameters (or any tensors named as them: gradients, moments) back
into that layout.  ``load_opt_state`` carries a reference optimizer state
into the port's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.accelerators.base import AccelConfig
from repro_torch.core.dram import AddressMapping, DRAMConfig
from repro_torch.core.trace import Trace
from repro_torch.graph.structure import Graph


def graph_from_numpy(n: int, src: np.ndarray, dst: np.ndarray,
                     weights: np.ndarray | None = None, name: str = "graph",
                     directed: bool = True) -> Graph:
    """A :class:`Graph` over copies of the given COO arrays."""
    return Graph(
        n=int(n),
        src=np.array(src, dtype=np.int32),
        dst=np.array(dst, dtype=np.int32),
        weights=None if weights is None else np.array(weights, dtype=np.float32),
        name=name,
        directed=bool(directed),
    )


def dram_config_from_dict(d: dict) -> DRAMConfig:
    """A :class:`DRAMConfig` from ``dataclasses.asdict`` of one, including
    the nested address mapping."""
    d = dict(d)
    if isinstance(d.get("mapping"), dict):
        d["mapping"] = AddressMapping(**d["mapping"])
    return DRAMConfig(**d)


def accel_config_from_dict(d: dict) -> AccelConfig:
    """An :class:`AccelConfig` from ``dataclasses.asdict`` of one
    (``optimizations`` may come as any iterable of names)."""
    d = dict(d)
    if "optimizations" in d:
        d["optimizations"] = frozenset(d["optimizations"])
    return AccelConfig(**d)


def traces_from_numpy(items) -> list[Trace]:
    """Eager traces from ``[(lines, is_write), ...]`` numpy pairs."""
    return [Trace(np.array(lines, dtype=np.int64), np.array(wr, dtype=bool))
            for lines, wr in items]


# ---------------------------------------------------------------------------
# LM weights
# ---------------------------------------------------------------------------


def _np_dtype(name: str):
    if name == "bfloat16":
        try:
            import ml_dtypes
        except ImportError as e:  # numpy has no bfloat16 of its own
            raise ImportError("a bfloat16 numpy tree needs the ml_dtypes package") from e
        return ml_dtypes.bfloat16
    return {"float32": np.float32, "float16": np.float16}[name]


def lm_params_numpy(cfg, seed: int = 0) -> dict:
    """A numpy parameter tree with exactly the structure, shapes and dtypes
    of the reference's ``Model(cfg).init_abstract()`` for a dense ``cfg``:
    the blocks are stacked per period position on axis 0 (the dense
    program's period is 1, so one entry of ``n_layers`` stacked layers),
    and weights are ``(in, out)``.  Values come from
    ``np.random.default_rng(seed)``: fan-in truncated normals for the
    weights, normal x 0.01 for the embedding, and norm scales and biases
    drawn around their init values (1 and 0) so that carrying them over is
    tested too."""
    from repro_torch.models.model import padded_vocab
    from repro_torch.models.transformer import find_period, layer_program, not_ported

    if cfg.family != "dense":
        raise not_ported(f"family {cfg.family!r} ({cfg.arch})", cfg.family)
    rng = np.random.default_rng(seed)
    dtype = _np_dtype(cfg.dtype)
    _, reps = find_period(layer_program(cfg))
    d, hd, dff, vp = cfg.d_model, cfg.head_dim, cfg.d_ff, padded_vocab(cfg.vocab)
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd

    def dense(*shape):
        out = rng.standard_normal(shape)
        bad = np.abs(out) > 3.0
        while bad.any():  # truncate to [-3, 3] by redrawing
            out[bad] = rng.standard_normal(int(bad.sum()))
            bad = np.abs(out) > 3.0
        return (out / np.sqrt(shape[-2])).astype(dtype)

    def scale(*shape):
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(dtype)

    def bias(*shape):
        return (0.02 * rng.standard_normal(shape)).astype(dtype)

    embed = {"tok": (0.01 * rng.standard_normal((vp, d))).astype(dtype)}
    if not cfg.tie_embeddings:
        embed["head"] = dense(d, vp)
    attn = {"wq": dense(reps, d, nq), "wk": dense(reps, d, nkv),
            "wv": dense(reps, d, nkv), "wo": dense(reps, nq, d)}
    if cfg.qkv_bias:
        attn.update(bq=bias(reps, nq), bk=bias(reps, nkv), bv=bias(reps, nkv))
    if cfg.qk_norm:
        attn.update(q_norm={"scale": scale(reps, hd)}, k_norm={"scale": scale(reps, hd)})
    block = {"norm1": {"scale": scale(reps, d)}, "attn": attn,
             "norm2": {"scale": scale(reps, d)},
             "mlp": {"wg": dense(reps, d, dff), "wi": dense(reps, d, dff),
                     "wo": dense(reps, dff, d)}}
    return {"embed": embed, "blocks": [block], "final_norm": {"scale": scale(d)}}


def _to_tensor(a) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy (arrays from jax are read-only)
    if a.dtype.name == "bfloat16":  # ml_dtypes: carry the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def tree_leaves(node, prefix: str = ""):
    """(dotted path, array) of every leaf of a nested dict/list tree."""
    items = node.items() if isinstance(node, dict) else enumerate(node)
    for key, value in items:
        if isinstance(value, (dict, list, tuple)):
            yield from tree_leaves(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def _stacked_targets(model) -> dict[str, list]:
    """reference tree path -> [(parameter name, index on the stacked axis or
    None)]: layer ``r * period + i`` is ``blocks[i][leaf][r]``."""
    from repro_torch.models.transformer import find_period

    period, _ = find_period(model.program)
    targets: dict[str, list] = {}
    for name, _ in model.named_parameters():
        if not name.startswith("blocks."):
            targets[name] = [(name, None)]
            continue
        li, rest = name.split(".", 2)[1:]
        i, r = int(li) % period, int(li) // period
        targets.setdefault(f"blocks.{i}.{rest}", []).append((name, r))
    return targets


def load_lm_params(model, tree: dict, tensors: dict | None = None):
    """Copy a reference-layout numpy tree (``lm_params_numpy``, or
    ``jax.tree.map(np.asarray, params)`` of a reference init) into the
    port's ``Model``, or into ``tensors`` (parameter name -> tensor of that
    parameter's shape, such as optimizer moments).  Layer ``r * period + i``
    takes ``blocks[i][leaf][r]``.  Raises on a missing, extra or misshaped
    leaf.  Returns the model."""
    tensors = dict(model.named_parameters()) if tensors is None else tensors
    targets = _stacked_targets(model)
    leaves = dict(tree_leaves(tree))
    if leaves.keys() != targets.keys():
        raise ValueError(f"tree and model differ: only in the tree "
                         f"{sorted(leaves.keys() - targets.keys())}, only in the model "
                         f"{sorted(targets.keys() - leaves.keys())}")
    with torch.no_grad():
        for path, dests in targets.items():
            for name, r in dests:
                dst = tensors[name]
                t = _to_tensor(leaves[path] if r is None else np.asarray(leaves[path])[r])
                if tuple(t.shape) != tuple(dst.shape):
                    raise ValueError(f"{path}: tree has {tuple(t.shape)}, "
                                     f"model {tuple(dst.shape)}")
                dst.copy_(t.to(dst.device, dst.dtype))
    return model


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_np_dtype("bfloat16"))
    return t.numpy().copy()


def lm_params_to_numpy(model, tensors: dict | None = None) -> dict:
    """The inverse of ``load_lm_params``: a numpy tree in the reference's
    layout (layers re-stacked per period position on axis 0) of the model's
    parameters, or of ``tensors`` (parameter name -> tensor of that
    parameter's shape, such as gradients or optimizer moments)."""
    tensors = dict(model.named_parameters()) if tensors is None else tensors
    tree: dict = {}
    for path, dests in _stacked_targets(model).items():
        if dests[0][1] is None:
            value = _numpy(tensors[dests[0][0]])
        else:
            value = np.stack([_numpy(tensors[name]) for name, _ in sorted(
                dests, key=lambda d: d[1])])
        keys = path.split(".")
        node = tree
        for key, nxt in zip(keys[:-1], keys[1:]):
            if isinstance(node, list):  # the blocks, one dict a period position
                while len(node) <= int(key):
                    node.append({})
                node = node[int(key)]
            else:
                node = node.setdefault(key, [] if nxt.isdigit() else {})
        node[keys[-1]] = value
    return tree


def load_opt_state(model, state: dict, tree: dict) -> dict:
    """Copy a reference-layout optimizer state (``{"step", "m", "v"}`` as
    numpy, from ``repro.train.optimizer``) into the port's ``state`` (from
    ``train.optimizer.init`` for ``model``), in place.  Returns ``state``."""
    with torch.no_grad():
        state["step"].copy_(torch.as_tensor(np.array(tree["step"])))
    load_lm_params(model, tree["m"], state["m"])
    load_lm_params(model, tree["v"], state["v"])
    return state
