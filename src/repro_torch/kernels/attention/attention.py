"""Attention forward: the CUDA kernel's wrapper and its plain PyTorch version.

``attention_fwd(q, k, v, causal)`` takes q ``(B, S, nq, hd)`` and k, v
``(B, S, nkv, hd)`` with ``nq % nkv == 0`` (grouped-query attention: query
head h reads kv head ``h // (nq // nkv)``) and returns
``softmax(q kᵀ / sqrt(hd)) v`` as ``(B, S, nq, hd)`` in q's dtype.  On a
CUDA tensor it launches the hand-written kernel ``csrc/attention.cu`` (the
port of ``repro/kernels/attention/attention.py::flash_attention_pallas``)
or raises; on a CPU tensor it takes ``attention_plain``.  The kernel takes
f32 (scalar FMAs) and bf16 (wgmma, fed by TMA), head_dim 32, 64 and 128,
and any S.  It has no backward: on the card, a call that autograd would
differentiate raises (training attends through ``models.attention._sdpa``,
as the reference trains).

The kernel is also the operator ``repro_torch::flash_attention``
(``torch.library.custom_op``), which DTensors, fake tensors and calls under
a dispatch mode (the op counter) go through: a fake implementation gives
its shape to ``FakeTensorMode`` (the dry run), its FLOPs, 4·B·nq·S²·hd
halved when causal, are registered with ``torch.utils.flop_counter``, and
a DTensor sharding rule (``_register_dtensor_rule``) runs it on each rank's
shard of the batch or of whole GQA groups of heads.  A plain CUDA tensor
launches the kernel directly, without the op's dispatch.
"""
from __future__ import annotations

import ctypes

import torch
import torch.utils.flop_counter
from torch.utils._python_dispatch import _get_current_dispatch_mode

from repro_torch.kernels import _build
from repro_torch.kernels._platform import LAUNCHES

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = _build.load("attention").attention_fwd_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, S, nq, hd) and k, v equal (B, S, nkv, hd); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, nq, hd = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, hd):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    nkv = k.shape[2]
    if nkv == 0 or nq % nkv:
        raise ValueError(f"{nq} query heads are not a multiple of {nkv} kv heads")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def _check_alignment(name: str, t: torch.Tensor) -> None:
    """Raises unless ``t`` is laid out as the bf16 kernel's TMA tensor maps
    take it: a 16-byte-aligned base, a unit innermost stride and every other
    stride a multiple of 16 bytes.  The f32 kernel is held to the same."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")
    size = t.element_size()
    if t.stride(-1) != 1 or any(st * size % 16 for st in t.stride()[:-1]):
        raise ValueError(f"{name}'s strides {t.stride()} (elements of {size} bytes) "
                         f"must be multiples of 16 bytes, the innermost 1")


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """Attention of ``(B, S, nq, hd)`` queries over ``(B, S, nkv, hd)`` keys
    and values; returns ``(B, S, nq, hd)`` in q's dtype.  CUDA tensors
    launch the kernel on the current stream (no sync), and raise where
    autograd would need a backward; CPU tensors take the plain version,
    which autograd differentiates.  DTensors (the sharded serving steps),
    fake tensors and calls under a dispatch mode go through the op
    ``repro_torch::flash_attention``, whose sharding rule
    (``_register_dtensor_rule``) runs it on each rank's shard: the kernel
    on the card, the plain version on the CPU.  Anything else raises."""
    _check(q, k, v)
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor

    dtensor = isinstance(q, DTensor)
    if q.device.type == "cpu" and not dtensor and not isinstance(q, FakeTensor):
        return attention_plain(q, k, v, causal=causal)
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "the attention kernel has no backward: training takes "
            "models.attention._sdpa (train_self_attention); call the kernel "
            "under torch.no_grad() or on tensors that do not require grad")
    if type(q) is torch.Tensor and _get_current_dispatch_mode() is None:
        return _launch(q, k, v, causal)
    if dtensor:
        _register_dtensor_rule()
    return torch.ops.repro_torch.flash_attention(q, k, v, causal)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool) -> torch.Tensor:
    """The kernel as an operator: launched on CUDA tensors, the plain
    version on CPU ones (a DTensor's CPU shards), contiguous as the
    kernel's output is."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal).contiguous()
    return _launch(q, k, v, causal)


@flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, causal):
    return torch.empty_like(q)


def attention_flops(q_shape, k_shape, v_shape, causal: bool, *args, **kwargs) -> int:
    """4·B·nq·S²·hd (the QKᵀ and PV products), halved when causal."""
    b, s, nq, hd = q_shape
    flops = 4 * b * nq * s * s * hd
    return flops // 2 if causal else flops


torch.utils.flop_counter.register_flop_formula(torch.ops.repro_torch.flash_attention)(
    attention_flops)

_RULE_REGISTERED = False


def _register_dtensor_rule() -> None:
    """Teach DTensor the op: q, k and v sharded alike on the batch (dim 0),
    or on the heads (dim 2) where the kv heads divide the whole mesh, so
    that every rank holds whole GQA groups of query heads beside their kv
    head; S and hd are never sharded.  The output is placed as q."""
    global _RULE_REGISTERED
    if _RULE_REGISTERED:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.flash_attention.default)
    def _rule(q, k, v, causal):
        rules = [([Replicate()], [Replicate(), Replicate(), Replicate(), None]),
                 ([Shard(0)], [Shard(0), Shard(0), Shard(0), None])]
        nkv = k.tensor_meta.shape[2]
        if nkv % k.mesh.size() == 0:
            rules.append(([Shard(2)], [Shard(2), Shard(2), Shard(2), None]))
        return rules

    _RULE_REGISTERED = True


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> torch.Tensor:
    """Launch the kernel on plain CUDA tensors; raises on what it does not
    take."""
    b, s, nq, hd = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"the attention kernel takes float32 or bfloat16, not {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"the attention kernel takes head_dim in {HEAD_DIMS}, not {hd}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        _check_alignment(name, t)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, nq,
            k.shape[2], hd, _DTYPE_CODE[q.dtype], int(causal), 1.0 / hd ** 0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    with torch.cuda.device(q.device):
        err = _kernel_fn()(*args)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {err}")
    LAUNCHES["attention"] += 1
    return out


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """The same function in plain PyTorch, as ``repro/kernels/attention/
    ref.py::attention_ref`` computes it: kv heads repeated to the query
    heads, explicit ``(S, S)`` scores in f32 with -1e30 above the diagonal,
    an f32 softmax, and the probabilities cast to v's dtype before the PV
    product."""
    _check(q, k, v)
    s, nq, hd = q.shape[1:]
    group = nq // k.shape[2]
    if group > 1:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (1.0 / hd ** 0.5)
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype)
