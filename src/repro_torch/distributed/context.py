"""Activation-sharding policy, threaded to model code without plumbing the
mesh through every layer (port of ``repro/distributed/context.py``).

DTensor propagates placements op by op, as GSPMD propagates shardings, and
the same ties arise: FSDP shards weight contraction dims over "data",
which also carries the batch.  The sharded steps install a policy; model
code calls ``constrain(x, kind)`` at the points that pin the residual
stream (embedding output, block boundaries: ``btd``) and the logits
(``logits``), and ``constrain`` redistributes the DTensor there.  The
reference's other kinds (``tokens``, ``attn_q``, ``attn_kv``, ``moe_gtd``,
``moe_gecd``) pin layouts that the port sets inside ``local_map`` instead
(attention, the MoE experts, the embedding), with ``row_axes`` and
``mesh_placements`` below; ``gather_fsdp`` pins the dense products'
weights.

Outside a policy, or on a plain tensor, these return ``x`` itself, so
every unsharded path runs exactly as before.
"""
from __future__ import annotations

import contextlib
import types
from typing import Optional

import torch

from repro_torch.distributed.sharding import P, _axis_sizes, _divisible_spec, _names, placements

# The policy is process-wide, not thread-local as the reference's: autograd
# runs a CUDA backward on its own device thread, and remat's recompute
# there must see the policy the forward ran under.
_STATE = types.SimpleNamespace(policy=None)


class ActivationPolicy:
    """kind -> spec of the activations of the running step, on ``mesh`` (a
    ``DeviceMesh`` with named dims)."""

    def __init__(self, mesh, batch_axes, model_axis: str = "model"):
        self.mesh = mesh
        self.batch = batch_axes
        self.model = model_axis

    def axis_size(self, name: str) -> int:
        return _axis_sizes(self.mesh).get(name, 1)

    def spec(self, kind: str) -> Optional[P]:
        if kind == "btd":  # (B, S, D) residual-stream activations
            return P(self.batch, None, None)
        if kind == "logits":  # (B, S, V): vocab model-sharded
            return P(self.batch, None, self.model)
        return None


def set_policy(policy: Optional[ActivationPolicy]):
    _STATE.policy = policy


def get_policy() -> Optional[ActivationPolicy]:
    return _STATE.policy


@contextlib.contextmanager
def activation_policy(policy: ActivationPolicy):
    prev = get_policy()
    set_policy(policy)
    try:
        yield
    finally:
        set_policy(prev)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def constrain(x, kind: str):
    """Redistribute ``x``, and its gradient in the backward pass, to the
    active policy's spec for ``kind`` (a dim its axes do not divide left
    unsharded); ``x`` itself without a policy or for a plain tensor."""
    pol = get_policy()
    if pol is None or not is_dtensor(x):
        return x
    spec = pol.spec(kind)
    if spec is None:
        return x
    spec = _divisible_spec(spec, tuple(x.shape), pol.mesh)
    return _Pin.apply(x, placements(x.device_mesh, spec))


def row_axes(pol: ActivationPolicy, mesh, rows: int, tokens_per_row: int = 1,
             group: int = 1) -> list:
    """The policy's batch axes over which ``rows`` batch rows split, in
    order: each mesh dim of more than one rank that, with those before it,
    leaves every rank whole rows and, with ``group``, a whole number of
    groups of ``group`` tokens (``tokens_per_row`` a row; the MoE's routing
    groups).  The rule every ``local_map`` body of the model shards its
    rows by."""
    sizes = _axis_sizes(mesh)
    axes, n = [], 1
    for ax in _names(pol.batch) if pol.batch else ():
        k = n * sizes.get(ax, 1)
        if k > n and rows % k == 0 and (rows // k * tokens_per_row) % group == 0:
            axes.append(ax)
            n = k
    return axes


def shard_axes(x, dim: int) -> list:
    """The names of the mesh dims of more than one rank on which DTensor
    ``x`` is ``Shard(dim)``."""
    return [ax for ax, pl, n in zip(x.device_mesh.mesh_dim_names, x.placements,
                                    tuple(x.device_mesh.shape))
            if pl.is_shard() and pl.dim == dim % x.ndim and n > 1]


def mesh_placements(mesh, by_axis: dict, other=None) -> tuple:
    """One placement a mesh dim: ``by_axis[name]`` on the dims it names,
    ``other`` (``Replicate``) on the rest, and ``Replicate`` on every dim of
    one rank, where a shard is the whole tensor."""
    from torch.distributed.tensor import Replicate

    other = Replicate() if other is None else other
    return tuple(Replicate() if n == 1 else by_axis.get(ax, other)
                 for ax, n in zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def gather_fsdp(w):
    """Weight ``w`` with its shards on every mesh dim but "model" gathered
    (the all-gather of a ZeRO-3 weight at its use; its gradient is
    reduce-scattered back in the backward pass).  So placed, the weight
    meets the ``btd`` activations with no redistribution, and every torch
    version runs the product on the rank's rows and columns.  Left to
    DTensor's cost model, a decode step's products took the whole batch
    with the contraction split over "data" (torch 2.11), and 2.13 also
    gathered the MLP's "model" shards: every column on every rank, 16x the
    work.  ``w`` itself without a policy or for a plain tensor."""
    pol = get_policy()
    if pol is None or not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate

    target = tuple(pl if ax == pol.model else Replicate()
                   for ax, pl in zip(w.device_mesh.mesh_dim_names, w.placements))
    return w if target == tuple(w.placements) else w.redistribute(w.device_mesh, target)


class _Pin(torch.autograd.Function):
    """Redistribute to ``target`` in the forward pass, and the gradient to
    ``target`` in the backward pass, as GSPMD's sharding constraint holds
    both.  Left alone, DTensor keeps a gradient partial and gathers the
    weights of the next product whole (the backward of a row-parallel
    product then runs unsharded on every model rank)."""

    @staticmethod
    def forward(ctx, x, target):
        ctx.target = target
        if tuple(x.placements) == target:
            return x.view_as(x)
        return x.redistribute(x.device_mesh, target)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) != ctx.target:
            grad = grad.redistribute(grad.device_mesh, ctx.target)
        return grad, None


def whole(t):
    """A DTensor gathered whole (a collective on its mesh); a plain tensor
    as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def reduce_partial(x):
    """``x`` with its ``Partial`` placements reduced to ``Replicate`` (the
    all-reduce after a row-parallel product); ``x`` itself for a plain
    tensor or one with nothing partial."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, tuple(Replicate() if p.is_partial() else p
                                               for p in x.placements))


def replicate_dim(x, dim: int):
    """``x`` with every ``Shard(dim)`` placement made ``Replicate`` (a
    gather along that dim); ``x`` itself for a plain tensor."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    dim = dim % x.ndim
    target = tuple(Replicate() if isinstance(pl, Shard) and pl.dim == dim else pl
                   for pl in x.placements)
    if target == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, target)


def split_dim(x, dim: int, sizes: tuple):
    """``x`` with ``dim`` split into ``sizes`` (a reshape).  On a DTensor
    sharded along ``dim``, DTensor shards the first of the new dims only
    where its size divides by the shards: a mesh dim that would not
    (qwen3's 8 kv heads over 16) is gathered first, as the reference's
    GSPMD pads or gathers there."""
    dim = dim % x.ndim
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard

        prod, target = 1, []
        for pl, n in zip(x.placements, tuple(x.device_mesh.shape)):
            if isinstance(pl, Shard) and pl.dim == dim:
                if sizes[0] % (prod * n) == 0:
                    prod *= n
                else:
                    pl = Replicate()
            target.append(pl)
        if tuple(target) != tuple(x.placements):
            x = x.redistribute(x.device_mesh, tuple(target))
    return x.reshape(tuple(x.shape[:dim]) + tuple(sizes) + tuple(x.shape[dim + 1:]))


def local_range(size: int, mesh, placements_, dim: int) -> tuple[int, int]:
    """(global offset, length) of this rank's part of a dim of ``size``
    split by ``placements_`` on ``mesh`` (``torch.chunk``'s split, in mesh
    dim order, as DTensor's ``Shard``).  Reads the rank's mesh coordinate,
    no tensor, so it holds under fake tensors too."""
    off, length = 0, size
    for pl, n, c in zip(placements_, tuple(mesh.shape), mesh.get_coordinate()):
        if getattr(pl, "dim", None) == dim and pl.is_shard():
            chunk = -(-length // n)
            lo = min(c * chunk, length)
            off, length = off + lo, min(chunk, length - lo)
    return off, length


@torch.no_grad()
def write_along(dest, start: int, value, dim: int = 1) -> None:
    """``dest[.., start:start + n, ..] = value`` along ``dim``, in place.

    On a plain tensor that is the slice assignment.  On a DTensor the
    assignment would land on a temporary and be lost (a DTensor sharded on
    ``dim`` has no view of a global slice), so each rank writes its own
    shard: ``value`` is first placed as ``dest`` is but whole along
    ``dim``, then the rows of ``[start, start + n)`` that this rank holds
    are copied into its local tensor.  The rank that holds none writes
    nothing; where ``dest`` is not sharded on ``dim``, every rank writes."""
    n = value.shape[dim]
    if not is_dtensor(dest):
        idx = [slice(None)] * dest.ndim
        idx[dim] = slice(start, start + n)
        dest[tuple(idx)] = value.to(dest.dtype)
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard

    target = tuple(Replicate() if isinstance(pl, Shard) and pl.dim == dim else pl
                   for pl in dest.placements)
    if isinstance(value, DTensor):
        value = value.redistribute(dest.device_mesh, target).to_local()
    else:  # the same whole tensor on every rank: take this rank's part
        value = value[tuple(slice(*_span(local_range(value.shape[d], dest.device_mesh,
                                                         target, d)))
                            for d in range(value.ndim))]
    off, length = local_range(dest.shape[dim], dest.device_mesh, dest.placements, dim)
    lo, hi = max(start, off), min(start + n, off + length)
    if lo >= hi:
        return
    local = dest.to_local()
    src = value.narrow(dim, lo - start, hi - lo)
    local.narrow(dim, lo - off, hi - lo).copy_(src.to(local.dtype))


def _span(off_len: tuple[int, int]) -> tuple[int, int]:
    return off_len[0], off_len[0] + off_len[1]


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def contiguous_grad(x: torch.Tensor) -> torch.Tensor:
    """``x``, with its gradient made contiguous in the backward pass.  The
    local function of a ``local_map`` applies it to its inputs: DTensor
    takes a local gradient to be laid out as its global metadata says
    (contiguous), and a view of a strided one fails."""
    return _ContiguousGrad.apply(x) if x.requires_grad else x
