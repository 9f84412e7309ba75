"""Per-device op analysis of an eager step, the port's twin of
``repro/roofline/hlo.py``.

The reference parses the partitioned XLA HLO of a compiled step.  PyTorch
runs eagerly and has no such program, so the twin counts every aten op as
it executes, on one rank, through a ``TorchDispatchMode``:

- FLOPs by ``torch.utils.flop_counter``'s formulas (matmuls, convolutions,
  attention), with the attention kernel's op
  (``repro_torch::flash_attention``) registered beside them;
- bytes as operands plus results of every op that moves data, skipping
  views, aliases, allocations and collective waits as the reference's
  ``_NO_BYTES`` skips plumbing; an in-place write into a slice (a view,
  then ``copy_``) counts the slice, not the buffer;
- collective bytes by op, from the result bytes of the
  ``_c10d_functional`` ops that DTensor's redistributions issue.

On DTensor arguments the mode steps aside (returns ``NotImplemented``), so
DTensor desugars the op into the local ops and collectives of this rank,
which the mode then counts: the numbers are per device, as the
reference's.  DTensor also runs an op once on fake tensors of the global
shapes, the first time it sees a signature, to learn the output's shape,
and runs the decomposition of an op without a sharding rule (softplus,
say) on fake global shapes to find its placements; the counter pauses
while DTensor's sharding propagator does either, since that work is not
the rank's.  Eager execution has no loops to multiply (``n_loops`` 0): a
Python loop of N matmuls is N matmuls.

``OpCounter`` can also follow the live bytes of the tensors it sees made
(``track_memory``): a storage counts from the op that made it until its
last tensor is gone, and ``track(tensors)`` adds tensors made before the
mode, such as parameters.  ``peak_bytes`` is the largest live total.  It
works on fake tensors, so the dry run reads a step's footprint without
allocating it.
"""
from __future__ import annotations

import collections
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# collective op (``_c10d_functional`` name prefix) -> the reference's name
_COLLECTIVES = {"all_gather": "all-gather", "all_reduce": "all-reduce",
                "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
                "broadcast": "broadcast"}
COLLECTIVE_OPS = tuple(_COLLECTIVES.values())

# ops that move no bytes: allocation, reshapes and metadata (views are
# found by ``OpOverload.is_view``, and the ``prim`` namespace is metadata)
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
             "detach", "alias", "lift_fresh", "lift_fresh_copy", "_local_scalar_dense",
             "_unsafe_view", "wait_tensor", "sym_size", "sym_stride", "sym_numel",
             "sym_storage_offset", "is_contiguous", "set_", "resize_"}


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _collective(func) -> str | None:
    if not func.namespace.startswith("_c10d_functional"):
        return None
    name = func._overloadpacket.__name__
    for prefix, kind in _COLLECTIVES.items():
        if name.startswith(prefix):
            return kind
    return None


class OpCounter(TorchDispatchMode):
    """Counts FLOPs, bytes and collective bytes of every op run under it
    (``with OpCounter() as c: ...``), in totals and by op."""

    def __init__(self, track_memory: bool = False):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.flop_registry = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.coll_by_op: dict[str, float] = collections.defaultdict(float)
        # op name -> [count, flops, bytes, collective bytes]
        self.by_op: dict[str, list] = collections.defaultdict(lambda: [0, 0.0, 0.0, 0.0])
        # (op name, operand shapes) -> [count, flops], for ops with FLOPs
        self.by_shape: dict[tuple, list] = collections.defaultdict(lambda: [0, 0.0])
        self.track_memory = track_memory
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages: dict[int, list] = {}  # storage key -> [bytes, live tensors]
        self._paused = 0
        self._unpatch = None

    def __enter__(self):
        # pause while DTensor's sharding propagator runs an op on global
        # fake shapes (its output metadata, or an op without a rule through
        # its decomposition), which no rank executes
        import importlib
        import inspect

        sites = [("torch.distributed.tensor._sharding_prop", "ShardingPropagator",
                  "_propagate_tensor_meta_non_cached"),
                 ("torch.distributed.tensor._decompositions", "DecompShardingStrategy",
                  "propagate_strategy")]
        patched = []
        for module, cls_name, name in sites:
            cls = getattr(importlib.import_module(module), cls_name)
            raw = inspect.getattr_static(cls, name)  # by version, static or not
            kind = type(raw) if isinstance(raw, (staticmethod, classmethod)) else None
            fn = raw.__func__ if kind else raw

            def paused(*args, _fn=fn, **kwargs):
                self._paused += 1
                try:
                    return _fn(*args, **kwargs)
                finally:
                    self._paused -= 1

            setattr(cls, name, kind(paused) if kind else paused)
            patched.append((cls, name, raw))

        def unpatch():
            for cls, name, raw in patched:
                setattr(cls, name, raw)

        self._unpatch = unpatch
        return super().__enter__()

    def __exit__(self, *exc):
        self._unpatch()
        return super().__exit__(*exc)

    # ---- live memory ----

    def track(self, tensors) -> None:
        """Count ``tensors`` (made before the mode: parameters, optimizer
        state, inputs) as live from now on; DTensors by their local shard."""
        for t in _tensors(tensors):
            local = getattr(t, "_local_tensor", t)
            self._see(local)

    def _see(self, t: torch.Tensor, new: bool = True) -> None:
        """Count ``t``'s storage live while ``t`` is; a view (``new``
        false) only adds a reference to a storage already counted."""
        try:
            storage = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = storage._cdata
        entry = self._storages.get(key)
        if entry is None:
            if not new:  # a view of a tensor made outside the count
                return
            entry = self._storages[key] = [storage.nbytes(), 0]
            self.live_bytes += entry[0]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        entry[1] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key: int) -> None:
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live_bytes -= entry[0]
            del self._storages[key]

    # ---- counting ----

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # let DTensor desugar into this rank's ops
        out = func(*args, **kwargs)
        if func.namespace == "prim" or self._paused:
            return out
        name = func._overloadpacket.__name__
        row = self.by_op[name]
        row[0] += 1
        kind = _collective(func)
        if kind is not None:
            b = sum(_nbytes(t) for t in _tensors(out))
            self.coll_by_op[kind] += b
            row[3] += b
        elif not func.is_view and name not in _NO_BYTES:
            b = sum(_nbytes(t) for t in _tensors((args, kwargs)) + _tensors(out))
            self.bytes += b
            row[2] += b
        formula = self.flop_registry.get(func._overloadpacket)
        if formula is not None:
            f = float(formula(*args, **kwargs, out_val=out))
            self.flops += f
            row[1] += f
            shaped = self.by_shape[(name, tuple(tuple(t.shape) for t in _tensors(args)))]
            shaped[0] += 1
            shaped[1] += f
        if self.track_memory:
            for t in _tensors(out):
                self._see(t, new=not func.is_view)
        return out

    # ---- results ----

    @property
    def collective_bytes(self) -> float:
        return float(sum(self.coll_by_op.values()))

    def analysis(self) -> dict:
        """The reference's ``analyze_hlo`` keys, per device."""
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "bytes_op_level": self.bytes,
            "collective_bytes": self.collective_bytes,
            "collectives_by_op": {k: float(v) for k, v in self.coll_by_op.items()},
            "n_loops": 0,
            "loops": [],
        }

    def top_ops(self, k: int = 20, by: str = "traffic") -> list[dict]:
        """The largest contributors by op, the twin of ``hlo.top_ops``:
        ``by`` "traffic" (bytes), "collective" or "flops".  Rows: value, op,
        count."""
        col = {"flops": 1, "traffic": 2, "collective": 3}[by]
        rows = [{"value": r[col], "op": op, "count": r[0]}
                for op, r in self.by_op.items() if r[col] > 0]
        rows.sort(key=lambda r: -r["value"])
        return rows[:k]

    def top_shapes(self, k: int = 20) -> list[dict]:
        """The largest FLOP contributors by op and operand shapes (the
        rank's local shapes: how DTensor placed a product).  Rows: value
        (FLOPs), op, shapes, count."""
        rows = [{"value": r[1], "op": op, "shapes": list(shapes), "count": r[0]}
                for (op, shapes), r in self.by_shape.items()]
        rows.sort(key=lambda r: -r["value"])
        return rows[:k]


def analyze(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` under an ``OpCounter``; its analysis."""
    with OpCounter() as counter:
        fn(*args, **kwargs)
    return counter.analysis()

