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
"""
from __future__ import annotations

import ctypes

import torch

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
    which autograd differentiates.  Anything else raises."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "the attention kernel has no backward: training takes "
            "models.attention._sdpa (train_self_attention); call the kernel "
            "under torch.no_grad() or on tensors that do not require grad")
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
