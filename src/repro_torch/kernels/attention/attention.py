"""Attention: the CUDA kernels' wrappers and their plain PyTorch versions.

``attention_fwd(q, k, v, causal)`` takes q ``(B, S, nq, hd)`` and k, v
``(B, S, nkv, hd)`` with ``nq % nkv == 0`` (grouped-query attention: query
head h reads kv head ``h // (nq // nkv)``) and returns
``softmax(q kᵀ / sqrt(hd)) v`` as ``(B, S, nq, hd)`` in q's dtype.  On a
CUDA tensor it launches the hand-written kernel ``csrc/attention.cu`` (the
port of ``repro/kernels/attention/attention.py::flash_attention_pallas``)
or raises; on a CPU tensor it takes ``attention_plain``.  The kernel takes
f32 (scalar FMAs) and bf16 (wgmma, fed by TMA), head_dim 32, 64 and 128,
and any S.  ``attention_fwd`` itself is not differentiable on the card: a
call that autograd would differentiate raises.

``attention_train(q, k, v, causal)`` is the same function for training, a
``torch.autograd.Function`` (``_FlashAttention``) whose forward and
backward are kernels too, for bf16 and head_dim 64 or 128 on the card.
Its forward is the bf16 kernel that also stores each query row's
log-sum-exp (``attention_fwd_lse_bf16_kernel``); it saves q, k, v, the
output and the log-sum-exp.  Its backward computes ``D = rowsum(dO ∘ O)``,
then dQ in one kernel (a block a query tile, looping over key tiles) and
dK, dV in another (a block a key tile, looping over the GQA group's query
heads and the query tiles that see it), recomputing the probabilities
from the log-sum-exp.  Every gradient element is written once: no
atomics, the same bits on every run.  Backward launches count under
``LAUNCHES["attention_bwd"]``.  The reference's kernel has no backward
(it trains through its einsum attention); the JAX package's ``jax.grad``
of ``repro/kernels/attention/ref.py::attention_ref`` is the function these
gradients are held to.  On the CPU ``attention_train`` takes
``attention_lse_plain`` and ``attention_bwd_plain``.

The kernels are also operators, ``repro_torch::flash_attention``,
``repro_torch::flash_attention_lse`` and ``repro_torch::flash_attention_bwd``
(``torch.library.custom_op``), which DTensors, fake tensors and calls under
a dispatch mode (the op counter, selective remat's caching mode) go
through: a fake implementation gives their shapes to ``FakeTensorMode``
(the dry run), and their FLOPs are registered with
``torch.utils.flop_counter``: 4·B·nq·S²·hd forward (QKᵀ and PV), 10·B·nq·S²·hd
backward (the scores recomputed, dP, dQ, dK and dV), halved when causal.
A DTensor sharding rule (``_register_dtensor_rule``) runs the serving op
on each rank's shard of the batch or of whole GQA groups of heads.  A
plain CUDA tensor launches the kernels directly, without the ops' dispatch.
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
TRAIN_HEAD_DIMS = (64, 128)  # the training kernels' head dims (bf16 only)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# each entry point of the library: its pointer arguments, then its ints
_ARGS = {"attention_fwd_launch": (4, 7), "attention_fwd_lse_launch": (5, 6),
         "attention_bwd_launch": (10, 6)}
_FNS: dict = {}


def _kernel_fn(name: str = "attention_fwd_launch"):
    if name not in _FNS:
        fn = getattr(_build.load("attention"), name)
        ptrs, ints = _ARGS[name]
        fn.argtypes = ([ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


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
    autograd would need a backward (``attention_train`` has one); CPU
    tensors take the plain version,
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
            "attention_fwd has no backward: training takes attention_train, "
            "whose backward is a kernel too; call attention_fwd under "
            "torch.no_grad() or on tensors that do not require grad")
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


def _check_launch(tensors: dict, dtypes, head_dims) -> None:
    """Raises unless the kernel takes these CUDA tensors: dtype, head_dim,
    contiguity and the TMA maps' alignment."""
    q = tensors["q"]
    if q.dtype not in dtypes:
        raise TypeError(f"the attention kernel takes {[str(d) for d in dtypes]}, "
                        f"not {q.dtype}")
    if q.shape[-1] not in head_dims:
        raise ValueError(f"the attention kernel takes head_dim in {head_dims}, "
                         f"not {q.shape[-1]}")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        _check_alignment(name, t)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> torch.Tensor:
    """Launch the kernel on plain CUDA tensors; raises on what it does not
    take."""
    b, s, nq, hd = q.shape
    _check_launch({"q": q, "k": k, "v": v}, tuple(_DTYPE_CODE), HEAD_DIMS)
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
    probs = torch.softmax(_plain_logits(q, k, causal), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), _repeat_kv(v, q.shape[2]))
    return out.to(q.dtype)


def _repeat_kv(t: torch.Tensor, nq: int) -> torch.Tensor:
    """kv heads ``(B, S, nkv, hd)`` repeated to the query heads."""
    group = nq // t.shape[2]
    return t.repeat_interleave(group, dim=2) if group > 1 else t


def _plain_logits(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """``attention_plain``'s scaled scores ``(B, nq, S, S)`` in f32, -1e30
    above the diagonal when causal."""
    s, nq, hd = q.shape[1:]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, _repeat_kv(k, nq)).float() * (1.0 / hd ** 0.5)
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, NEG_INF)
    return logits


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """``attention_plain``'s output and each query row's log-sum-exp of
    its scaled scores, ``(B, nq, S)`` in f32: what the training forward
    kernel returns."""
    out = attention_plain(q, k, v, causal=causal)
    return out, torch.logsumexp(_plain_logits(q, k, causal), dim=-1)


def attention_bwd_plain(d_out: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor, *,
                        causal: bool = True) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' math in plain PyTorch, all in f32: P = exp(S·scale
    − lse), D = rowsum(dO ∘ O), dS = P (dO Vᵀ − D), dQ = dS K·scale,
    dK = dSᵀ Q·scale and dV = Pᵀ dO, each kv head's dK and dV summed over
    its GQA group; returned in q's, k's and v's dtypes."""
    _check(q, k, v)
    b, s, nq, hd = q.shape
    nkv = k.shape[2]
    qf, dof = q.float(), d_out.float()
    kf, vf = _repeat_kv(k.float(), nq), _repeat_kv(v.float(), nq)
    scale = 1.0 / hd ** 0.5
    p = torch.exp(_plain_logits(qf, kf, causal) - lse[..., None])
    dsum = (dof * out.float()).sum(-1).transpose(1, 2)  # (B, nq, S)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - dsum[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk, dv = (t.reshape(b, s, nkv, nq // nkv, hd).sum(3) for t in (dk, dv))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _launch_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The training forward on plain CUDA tensors: the output and each
    query row's log-sum-exp ``(B, nq, S)`` f32."""
    b, s, nq, hd = q.shape
    _check_launch({"q": q, "k": k, "v": v}, (torch.bfloat16,), TRAIN_HEAD_DIMS)
    out = torch.empty_like(q)
    lse = torch.empty(b, nq, s, dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), b, s,
            nq, k.shape[2], hd, int(causal), 1.0 / hd ** 0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    with torch.cuda.device(q.device):
        err = _kernel_fn("attention_fwd_lse_launch")(*args)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {err}")
    LAUNCHES["attention"] += 1
    return out, lse


def _launch_bwd(d_out: torch.Tensor, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                out: torch.Tensor, lse: torch.Tensor,
                causal: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels on plain CUDA tensors: dq, dk, dv."""
    b, s, nq, hd = q.shape
    _check_launch({"q": q, "k": k, "v": v, "out": out, "d_out": d_out}, (torch.bfloat16,),
                  TRAIN_HEAD_DIMS)
    if lse.shape != (b, nq, s) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous ({b}, {nq}, {s}) float32 tensor")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dq.numel() == 0:
        return dq, dk, dv
    dsum = torch.empty(b, nq, s, dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), d_out.data_ptr(),
            lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, s, nq, k.shape[2], hd, int(causal), 1.0 / hd ** 0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    with torch.cuda.device(q.device):
        err = _kernel_fn("attention_bwd_launch")(*args)
    if err != 0:
        raise RuntimeError(f"attention backward launch failed: CUDA error {err}")
    LAUNCHES["attention_bwd"] += 1
    return dq, dk, dv


@torch.library.custom_op("repro_torch::flash_attention_lse", mutates_args=())
def flash_attention_lse_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The training forward as an operator: the kernel on CUDA tensors,
    the plain version on CPU ones."""
    if q.device.type == "cpu":
        return tuple(t.contiguous() for t in attention_lse_plain(q, k, v, causal=causal))
    return _launch_lse(q, k, v, causal)


@flash_attention_lse_op.register_fake
def _flash_attention_lse_fake(q, k, v, causal):
    b, s, nq, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, nq, s), dtype=torch.float32)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def flash_attention_bwd_op(d_out: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                           causal: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward as an operator: the kernels on CUDA tensors, the plain
    version on CPU ones."""
    if q.device.type == "cpu":
        return tuple(t.contiguous() for t in
                     attention_bwd_plain(d_out, q, k, v, out, lse, causal=causal))
    return _launch_bwd(d_out, q, k, v, out, lse, causal)


@flash_attention_bwd_op.register_fake
def _flash_attention_bwd_fake(d_out, q, k, v, out, lse, causal):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def attention_bwd_flops(d_out_shape, q_shape, k_shape, v_shape, o_shape, lse_shape,
                        causal: bool, *args, **kwargs) -> int:
    """10·B·nq·S²·hd (QKᵀ recomputed, dO Vᵀ, dS K, dSᵀ Q and Pᵀ dO), halved
    when causal."""
    return 5 * attention_flops(q_shape, k_shape, v_shape, causal) // 2


torch.utils.flop_counter.register_flop_formula(torch.ops.repro_torch.flash_attention_lse)(
    attention_flops)
torch.utils.flop_counter.register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)(
    attention_bwd_flops)


def _direct(q: torch.Tensor) -> bool:
    """A plain tensor outside any dispatch mode: on the card the kernels
    are launched without the operators."""
    return type(q) is torch.Tensor and _get_current_dispatch_mode() is None


class _FlashAttention(torch.autograd.Function):
    """``attention_train``: the training forward kernel, saving q, k, v, the
    output and the rows' log-sum-exp; the backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if _direct(q) and q.is_cuda:
            out, lse = _launch_lse(q, k, v, causal)
        else:
            out, lse = torch.ops.repro_torch.flash_attention_lse(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        d_out = d_out.contiguous()
        if _direct(q) and q.is_cuda:
            grads = _launch_bwd(d_out, q, k, v, out, lse, ctx.causal)
        else:
            grads = torch.ops.repro_torch.flash_attention_bwd(d_out, q, k, v, out, lse,
                                                              ctx.causal)
        return (*grads, None)


def attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """``attention_fwd``'s function, differentiable: ``(B, S, nq, hd)`` in q's
    dtype.  On CUDA tensors the training kernels (bf16, head_dim 64 or
    128; anything else raises), on CPU tensors the plain versions; under a
    dispatch mode or on fake tensors, their operators."""
    _check(q, k, v)
    return _FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), causal)
