"""Public attention op: the reference's layout and contract
(``repro/kernels/attention/ops.py::flash_attention``).

``flash_attention(q, k, v)`` takes q ``(B, S, nq, hd)`` and k, v
``(B, S, nkv, hd)`` and returns ``(B, S, nq * hd)`` in q's dtype, with
``scale = 1/sqrt(hd)``.  Grouped-query heads are indexed inside the kernel,
and the kernel masks a ragged sequence tail itself, so nothing is repeated
or padded here.  Unlike the reference's wrapper, which asserts that a
non-causal S is a multiple of its 128-row block, this one takes any S
either way: the kernel and ``attention_plain`` mask keys past S in every
tile (whisper's encoder attends over 1,500 frames).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.attention.attention import attention_fwd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Returns the ``(B, S, nq * hd)`` attention output (pre-WO): the CUDA
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    b, s, nq, hd = q.shape
    return attention_fwd(q, k, v, causal=causal).reshape(b, s, nq * hd)
