"""Edge-centric min-propagation: the CUDA kernel's wrapper and its plain
PyTorch version.

``edge_update(src, dst, delta, values)`` returns ``acc`` (n,) with
``acc[d] = min over edges (s -> d) of values[s] + delta``.  An edge with
``src < 0`` is skipped, a source at the dtype's sentinel stays at the
sentinel (it adds no delta), and a vertex with no live in-edge holds the
sentinel (``sentinel_max``: +inf for f32, the int32 max for int32).  As in
the reference (``ref.py``: ``segment_min`` over ``max(dst, 0)`` into ``n``
segments), an edge with ``dst < 0`` goes to vertex 0 and an edge with
``dst >= n`` is dropped.

On a CUDA tensor it launches the hand-written kernel ``csrc/edge_update.cu``
(the port of ``repro/kernels/edge_update/edge_update.py::edge_update_pallas``)
or raises; on a CPU tensor it takes ``edge_update_plain``.  Min is
order-independent, so the two are equal bit for bit.

The library's one call launches two kernels: a fill of the output with the
sentinel, then the edges, each warp over a chunk of consecutive edges
(``launch_plan``, sized from the card's SM count), with one atomic per run
of equal ``dst`` in each round of 32 or 128 edges.  The wrapper's host
path is kept short, since the path's many small calls are paced by it: the
library's function and the card's resident blocks are cached per device,
the stream is read once, and the device context is entered only when
``values`` is not on the current device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._platform import LAUNCHES

# dtype -> the kernel's type code (csrc/edge_update.cu)
DTYPE_CODES = {torch.float32: 0, torch.int32: 1}
THREADS = 256  # a block's threads (csrc/edge_update.cu kThreads)
BLOCKS_PER_SM = 6  # blocks an SM holds at once (the kernel's launch bounds)

_FN = None
# device index -> (the launch function, blocks the device holds at once)
_DEVICES: dict[int, tuple] = {}


def sentinel_max(dtype: torch.dtype):
    """The min-identity of ``dtype``: +inf for floats, the dtype max for
    integers (WCC labels and other integer-valued problems have no inf)."""
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def launch_plan(m: int, resident: int) -> tuple[int, int, int]:
    """(per_lane, blocks, chunk) of the edge kernel's launch for ``m`` edges
    on a card that holds ``resident`` blocks of ``THREADS`` threads at once.

    A warp takes rounds of ``32 * per_lane`` consecutive edges: one edge a
    lane while the card can give every 32 edges a warp of their own, four
    beyond.  ``blocks`` is enough for a warp per round, up to ``resident``;
    each warp takes ``chunk`` consecutive edges, a whole number of rounds,
    the same for every warp (the last ones may get fewer, or none)."""
    warps_per_block = THREADS // 32
    per_lane = 1 if m <= resident * warps_per_block * 32 else 4
    rnd = 32 * per_lane
    rounds = max(1, -(-m // rnd))
    blocks = min(resident, -(-rounds // warps_per_block))
    return per_lane, blocks, rnd * -(-rounds // (blocks * warps_per_block))


def _device(index: int) -> tuple:
    """The launch function and the blocks CUDA device ``index`` holds at
    once: ``BLOCKS_PER_SM`` for each of its SMs."""
    global _FN
    if index not in _DEVICES:
        if _FN is None:
            fn = _build.load("edge_update").edge_update_launch
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 + [
                ctypes.c_int] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _FN = fn
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        _DEVICES[index] = (_FN, sms * BLOCKS_PER_SM)
    return _DEVICES[index]


def _check(src: torch.Tensor, dst: torch.Tensor, delta: torch.Tensor,
           values: torch.Tensor) -> None:
    if values.dim() != 1:
        raise ValueError(f"values must be 1-D (n,), got {tuple(values.shape)}")
    if values.dtype not in DTYPE_CODES:
        raise TypeError(f"values must be float32 or int32, got {values.dtype}")
    if src.dim() != 1 or dst.shape != src.shape or delta.shape != src.shape:
        raise ValueError(f"src/dst/delta must be equal (m,), got {tuple(src.shape)}, "
                         f"{tuple(dst.shape)} and {tuple(delta.shape)}")
    for name, t, dtype in (("src", src, torch.int32), ("dst", dst, torch.int32),
                           ("delta", delta, values.dtype)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    for name, t in (("src", src), ("dst", dst), ("delta", delta), ("values", values)):
        if t.device != values.device:
            raise ValueError(f"{name} is on {t.device}, values on {values.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def edge_update(src: torch.Tensor, dst: torch.Tensor, delta: torch.Tensor,
                values: torch.Tensor) -> torch.Tensor:
    """Segment-min of ``values[src] + delta`` over ``dst``; returns (n,).

    ``dst`` may hold any int32: a negative one is vertex 0 and an edge with
    ``dst >= n`` is dropped, as the reference takes them, so no address
    outside ``[0, n)`` is ever written.  CUDA tensors launch the kernel on
    the current stream (no sync); CPU tensors take the plain version.
    Anything else raises."""
    dev = values.device
    # the common case in one expression; anything else goes through _check,
    # which raises on whatever it is
    if not (values.dim() == 1 and src.dim() == 1 and values.dtype in DTYPE_CODES
            and src.dtype == torch.int32 and dst.dtype == torch.int32
            and delta.dtype == values.dtype and dst.shape == src.shape
            and delta.shape == src.shape and src.device == dev and dst.device == dev
            and delta.device == dev and src.is_contiguous() and dst.is_contiguous()
            and delta.is_contiguous() and values.is_contiguous()):
        _check(src, dst, delta, values)
    if dev.type == "cpu":
        return edge_update_plain(src, dst, delta, values)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _launch(src, dst, delta, values)


def _launch(src: torch.Tensor, dst: torch.Tensor, delta: torch.Tensor,
            values: torch.Tensor, resident: int | None = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors that ``edge_update`` accepts, with
    ``launch_plan`` for ``resident`` blocks: by default all that the card
    holds; fewer give each warp more rounds, and four edges a lane from
    ``resident * 256`` edges on (``chip_smoke.py`` forces both this way)."""
    if values.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {values.device}")
    out = torch.empty_like(values)
    n, m = values.shape[0], src.shape[0]
    if n == 0:
        return out
    index = values.device.index
    fn, card = _DEVICES.get(index) or _device(index)
    if resident is None:
        resident = card
    elif not 1 <= resident <= card:
        raise ValueError(f"resident must be in 1..{card}, got {resident}")
    per_lane, blocks, chunk = launch_plan(m, resident)
    args = (src.data_ptr(), dst.data_ptr(), delta.data_ptr(), values.data_ptr(),
            out.data_ptr(), m, n, DTYPE_CODES[values.dtype], per_lane, blocks, chunk,
            torch._C._cuda_getCurrentRawStream(index))  # the current stream's handle
    if index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"edge_update kernel launch failed: CUDA error {err}")
    LAUNCHES["edge_update"] += 1
    return out


def edge_update_plain(src: torch.Tensor, dst: torch.Tensor, delta: torch.Tensor,
                      values: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: a gather, then an ``amin``
    scatter into a sentinel-filled output (``repro/kernels/edge_update/
    ref.py::edge_update_ref``).  A dropped edge (``dst >= n``) scatters the
    sentinel into vertex 0, which changes nothing."""
    top = sentinel_max(values.dtype)
    n = values.shape[0]
    sv = values[src.clamp_min(0).long()]
    # a source at the sentinel is unreached: keep it saturated instead of
    # adding delta (int32 would overflow; float inf absorbs the add anyway)
    kept = dst < n
    valid = (src >= 0) & (sv != top) & kept
    cand = torch.where(valid, sv + delta, top)
    out = torch.full((n,), top, dtype=values.dtype, device=values.device)
    index = torch.where(kept, dst.clamp_min(0), 0).long()
    return out.scatter_reduce_(0, index, cand, "amin", include_self=True)
