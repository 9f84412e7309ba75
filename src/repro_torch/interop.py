"""Carry state into the port from plain numpy arrays and dicts.

The simulator has no weights; its state is graphs, DRAM/controller
configurations, accelerator configurations and request traces.  These
functions build the port's objects from the reference's objects flattened
to numpy arrays and plain dicts (``dataclasses.asdict``), so a caller can
hand both packages the same inputs without the port importing the
reference.  The LM scaffolding's weights cross the same way:
``lm_params_numpy`` makes a numpy parameter tree in the reference's layout
(and ``context_inputs_numpy`` the stub front ends' inputs),
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
    of the reference's ``Model(cfg).init_abstract()``: the blocks are
    stacked per period position of ``layer_program(cfg)`` on axis 0 (a list
    of ``period`` dicts whose leaves stack the ``n_layers / period``
    repeats), as are whisper's encoder blocks (``enc.blocks``, period 1),
    weights are ``(in, out)``, and the leaves that the reference keeps in
    f32 (the router, the SSM decays and mixes) are f32 in a bf16 tree too.
    Values come from ``np.random.default_rng(seed)``, leaf by leaf in a
    fixed order (the cross-attention leaves and the encoder last, so the
    other families' trees do not depend on them): fan-in
    truncated normals for the weights (std 0.5 for mamba's conv), normal x
    0.01 for the embedding, normal x 0.1 for rwkv's bonus ``u``, and every
    other leaf drawn around its init value (norm scales and ``D`` around 1,
    biases around 0, the token-shift mixes around 0.5, ``w0`` around -6,
    ``A_log`` around log(1..d_state)) so that carrying it over is tested
    too."""
    from repro_torch.models import ssm
    from repro_torch.models.model import padded_vocab
    from repro_torch.models.transformer import LayerSpec, find_period, layer_program

    rng = np.random.default_rng(seed)
    dtype = _np_dtype(cfg.dtype)
    program = layer_program(cfg)
    period, reps = find_period(program)
    d, hd, dff, vp = cfg.d_model, cfg.head_dim, cfg.d_ff, padded_vocab(cfg.vocab)
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd

    def dense(*shape, std=None, dt=dtype):
        out = rng.standard_normal(shape)
        flat = out.reshape(-1)
        bad = np.flatnonzero((flat > 3.0) | (flat < -3.0))
        while bad.size:  # truncate to [-3, 3] by redrawing, in C order
            flat[bad] = rng.standard_normal(bad.size)
            bad = bad[np.abs(flat[bad]) > 3.0]  # only a redrawn value can be out
        # in place: a full-width leaf's f64 draw is GBs
        if std is None:
            np.divide(out, np.sqrt(shape[-2]), out=out)
        else:
            np.multiply(out, std, out=out)
        return out.astype(dt)

    def around(value, *shape, spread=0.1, dt=dtype):
        return (value + spread * rng.standard_normal(shape)).astype(dt)

    def scale(*shape):
        return around(1.0, *shape)

    def bias(*shape):
        return around(0.0, *shape, spread=0.02)

    def mlp(width, n=reps):
        return {"wg": dense(n, d, width), "wi": dense(n, d, width), "wo": dense(n, width, d)}

    def attention(n=reps):
        attn = {"wq": dense(n, d, nq), "wk": dense(n, d, nkv),
                "wv": dense(n, d, nkv), "wo": dense(n, nq, d)}
        if cfg.qkv_bias:
            attn.update(bq=bias(n, nq), bk=bias(n, nkv), bv=bias(n, nkv))
        if cfg.qk_norm:
            attn.update(q_norm={"scale": scale(n, hd)}, k_norm={"scale": scale(n, hd)})
        return attn

    def mamba():
        d_in, dt_rank = ssm.mamba_dims(cfg)
        ds = cfg.ssm_d_state
        a_log = np.log(np.arange(1, ds + 1, dtype=np.float64))
        return {"in_proj": dense(reps, d, 2 * d_in),
                "conv_w": dense(reps, cfg.ssm_d_conv, d_in, std=0.5),
                "conv_b": bias(reps, d_in),
                "x_proj": dense(reps, d_in, dt_rank + 2 * ds),
                "dt_proj": dense(reps, dt_rank, d_in), "dt_bias": bias(reps, d_in),
                "A_log": around(a_log, reps, d_in, ds, dt=np.float32),
                "D": around(1.0, reps, d_in, dt=np.float32),
                "out_proj": dense(reps, d_in, d)}

    def rwkv():
        nh, rhd = ssm.rwkv_dims(cfg)
        p = {f"mu_{n}": around(0.5, reps, d, dt=np.float32) for n in "rkvwg"}
        p.update({n: dense(reps, d, d) for n in ("wr", "wk", "wv", "wg", "wo")})
        p.update(w0=around(-6.0, reps, d, spread=0.5, dt=np.float32),
                 wa=dense(reps, d, ssm.RWKV_DECAY_LORA), wb=dense(reps, ssm.RWKV_DECAY_LORA, d),
                 u=around(0.0, reps, nh, rhd, dt=np.float32),
                 ln_x={"scale": around(1.0, reps, d, dt=np.float32)})
        return p

    def moe():
        e, eff = cfg.n_experts, cfg.expert_d_ff or cfg.d_ff
        p = {"router": dense(reps, d, e, dt=np.float32), "wg": dense(reps, e, d, eff),
             "wi": dense(reps, e, d, eff), "wo": dense(reps, e, eff, d)}
        if cfg.n_shared_experts:
            p["shared"] = mlp(cfg.n_shared_experts * eff)
        if cfg.dense_residual:
            p["dense"] = mlp(dff)
        return p

    def rwkv_ffn():
        return {"mu_k": around(0.5, reps, d, dt=np.float32),
                "mu_r": around(0.5, reps, d, dt=np.float32),
                "wk": dense(reps, d, dff), "wv": dense(reps, dff, d), "wr": dense(reps, d, d)}

    def block(spec, n=reps):
        mixer = {"mamba": ("mixer", mamba), "rwkv": ("mixer", rwkv)}.get(
            spec.mixer, ("attn", lambda: attention(n)))  # attn, attn_nc, cross, self_cross
        ffn = {"mlp": ("mlp", lambda: mlp(dff, n)), "moe": ("moe", moe),
               "rwkv_ffn": ("ffn", rwkv_ffn)}[spec.ffn]
        out = {mixer[0]: mixer[1]()}
        out.update(norm1={"scale": scale(n, d)}, norm2={"scale": scale(n, d)})
        out[ffn[0]] = ffn[1]()
        return out

    embed = {"tok": (0.01 * rng.standard_normal((vp, d))).astype(dtype)}
    if not cfg.tie_embeddings:
        embed["head"] = dense(d, vp)
    blocks = [block(program[i]) for i in range(period)]
    tree = {"embed": embed, "blocks": blocks, "final_norm": {"scale": scale(d)}}
    for blk, spec in zip(blocks, program):
        if spec.mixer == "self_cross":
            blk.update(cross=attention(), norm_cross={"scale": scale(reps, d)})
    if cfg.n_enc_layers:  # the encoder's program is one layer repeated: period 1
        tree["enc"] = {"blocks": [block(LayerSpec("attn_nc", "mlp"), cfg.n_enc_layers)],
                       "final_norm": {"scale": scale(d)}}
    return tree


def context_inputs_numpy(cfg, batch: int, seed: int) -> dict:
    """The stub front ends' inputs that a config's batches need, as
    ``tests/test_arch_smoke.py`` makes them: ``{"enc_frames": (batch,
    n_frames, d)}`` or ``{"img_embeds": (batch, n_img_tokens, d)}``, normal
    x 0.05 in f32 from ``np.random.default_rng(seed)``; ``{}`` for a
    text-only config."""
    from repro_torch.models.model import context_input

    spec = context_input(cfg)
    if spec is None:
        return {}
    key, length = spec
    rng = np.random.default_rng(seed)
    return {key: (0.05 * rng.standard_normal((batch, length, cfg.d_model))).astype(np.float32)}


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
    None)]: layer ``r * period + i`` of a stack (``blocks``, or the
    encoder's ``enc.blocks``) is ``<stack>[i][leaf][r]``, with the period of
    that stack's layer program."""
    from repro_torch.models.transformer import find_period

    periods = {"blocks.": find_period(model.program)[0]}
    if model.enc is not None:
        periods["enc.blocks."] = find_period(model.enc_program)[0]
    targets: dict[str, list] = {}
    for name, _ in model.named_parameters():
        stack = next((s for s in periods if name.startswith(s)), None)
        if stack is None:
            targets[name] = [(name, None)]
            continue
        li, rest = name[len(stack):].split(".", 1)
        i, r = int(li) % periods[stack], int(li) // periods[stack]
        targets.setdefault(f"{stack}{i}.{rest}", []).append((name, r))
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
