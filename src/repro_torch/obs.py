"""Named spans and counters inside the port, live only while
``torch.profiler`` records.

The JAX package has no counterpart: XLA's profiler names the compiled
program's ops itself, while the port runs eagerly and names its layers
here.  The module's one switch is ``torch.autograd.profiler._is_profiler_enabled``:
with no profiler running, ``span`` returns one shared null context and
``count`` returns at once, so a span site costs a flag check.

- ``span(name, device=None, tag=None)`` opens ``_RecordFunctionFast(name)``:
  a host event on the profiler's clock, recorded with the ``FUNCTION``
  scope and not as a user annotation, so Kineto makes no device-side copy
  of it (``record_function``'s ranges are copied onto the device timeline,
  where they would count as device work).  It also appends a record to
  memory: the name, the index of the enclosing open span's record
  (``parent``; one stack for the process, so a span the autograd engine's
  thread opens while the caller waits in the backward nests in the
  caller's span) and ``tag``.  With ``device`` a CUDA ``torch.device`` it
  records a CUDA event on the current stream at entry and at exit; the
  seconds between them (``device_s``) are resolved only by ``snapshot``.
- ``count(name, value)`` adds a host integer or a 0-d device tensor (kept
  on the device, no synchronisation) to the counter ``name`` of the phase,
  the outermost open span of ``PHASES``.  It counts nothing inside the
  backward (``torch._C._current_graph_task_id() != -1``), so remat's
  recompute of a forward is not counted twice.  ``recording()`` says
  whether a count would be kept, for call sites whose value costs a
  kernel to make.
- ``snapshot()`` returns the records and the counters as plain Python
  after one synchronisation; ``reset()`` clears both.

Nothing is written to a file: what is recorded stays in memory until it is
read.
"""
from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

# every span the port opens, from the train step and the engine down
SPANS = ("train_step", "model.forward", "model.backward", "model.recompute",
         "optimizer.update", "engine.wave", "model.prefill", "model.decode_step",
         "engine.decode", "engine.sample", "attention", "mlp",
         "moe.route", "moe.dispatch", "moe.experts", "moe.combine")
# the spans that key a counter
PHASES = ("train_step", "model.prefill", "model.decode_step")

_NULL = contextlib.nullcontext()
_records: list = []  # {"name", "parent", "tag", "events"}
_open: list = []  # indexes into _records of the open spans, outermost first
_counts: dict = {}  # (name, phase) -> [host total, [device tensors]]


def recording() -> bool:
    """True while a profiler records, outside the backward."""
    return _profiler._is_profiler_enabled and torch._C._current_graph_task_id() == -1


class _Span:
    __slots__ = ("name", "device", "tag", "_fast", "_index")

    def __init__(self, name: str, device, tag):
        self.name, self.device, self.tag = name, device, tag

    def __enter__(self):
        self._fast = torch._C._profiler._RecordFunctionFast(self.name)
        self._fast.__enter__()
        events = None
        if self.device is not None and self.device.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record()
        self._index = len(_records)
        _records.append({"name": self.name, "parent": _open[-1] if _open else None,
                         "tag": self.tag, "events": events})
        _open.append(self._index)
        return self

    def __exit__(self, *exc):
        events = _records[self._index]["events"]
        if events is not None:
            events[1].record()
        _open.remove(self._index)
        self._fast.__exit__(*exc)
        return False


def span(name: str, device=None, tag=None):
    """A context manager naming the work inside it (see the module's
    docstring); the shared null context while no profiler records."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, device, tag)


def _phase():
    for i in _open:
        if _records[i]["name"] in PHASES:
            return _records[i]["name"]
    return None


def count(name: str, value) -> None:
    """Add ``value`` (an int, or a 0-d tensor on any device) to the counter
    ``name`` of the current phase, while ``recording()``."""
    if not recording():
        return
    slot = _counts.setdefault((name, _phase()), [0, []])
    if isinstance(value, torch.Tensor):
        slot[1].append(value.detach())
    else:
        slot[0] += int(value)


def snapshot() -> dict:
    """``{"records": [{"name", "parent", "tag", "device_s"}], "counters":
    {name: {phase: total}}}`` (``device_s`` None without CUDA events; phase
    None outside every phase), after one synchronisation of the card."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    records = []
    for r in _records:
        ev = r["events"]
        records.append({"name": r["name"], "parent": r["parent"], "tag": r["tag"],
                        "device_s": ev[0].elapsed_time(ev[1]) / 1e3 if ev else None})
    counters: dict = {}
    for (name, phase), (host, tensors) in _counts.items():
        counters.setdefault(name, {})[phase] = host + sum(int(t.item()) for t in tensors)
    return {"records": records, "counters": counters}


def reset() -> None:
    """Forget every record and counter."""
    _records.clear()
    _open.clear()
    _counts.clear()
