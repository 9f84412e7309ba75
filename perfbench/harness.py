"""The benchmark's general machinery: the manifest, a cell's files, the
port's model built from a configuration file, weights and inputs from the
seed, the card's description, the trace's reduction and the result line.

Nothing here knows a particular configuration, traffic mix or metric:
those are files found by the names in ``BENCHMARK.json``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

PERFBENCH = Path(__file__).resolve().parent
ROOT = PERFBENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WEIGHT_CHUNK = 1 << 28  # normal draws a generator call (1 GiB of f32)
NAME_CHARS = 160  # a kernel's name in the breakdown, at most
_MIX = 0x9E3779B97F4A7C15


# ---------------------------------------------------------------------------
# the manifest and a cell's files
# ---------------------------------------------------------------------------


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything it names."""

    name: str
    entry: dict  # the manifest's entry
    workload: dict  # workloads/<cell>.json
    config: dict  # configs/<config>.json
    end_to_end: list  # the manifest's end-to-end metrics this cell reports
    per_layer: list  # the manifest's per-layer metrics this cell reports

    @property
    def arch(self) -> dict:
        return self.config["arch"]

    @property
    def traffic(self) -> dict:
        return self.workload["traffic"]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = ROOT, man: dict | None = None) -> Cell:
    """The cell ``name`` of the manifest, its workload file
    (``perfbench/workloads/<name>.json``) and its configuration's file."""
    man = man if man is not None else manifest(root)
    entries = {w["name"]: w for w in man["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    configs = {c["name"]: c for c in man["configs"]}
    config = load_json(root / configs[entry["config"]]["file"])
    workload = load_json(Path(root) / "perfbench" / "workloads" / f"{name}.json")
    if workload["config"] != entry["config"]:
        raise ValueError(f"{name}: workload file names config {workload['config']!r}, "
                         f"the manifest {entry['config']!r}")
    e2e = [m for m in man["end_to_end"] if _reports(m, name)]
    per_layer = [m for m in man["per_layer"] if _reports(m, name)]
    return Cell(name, entry, workload, config, e2e, per_layer)


def load_module(path: Path, name: str):
    """A module from a file that need not be importable by name (a metric's
    file is named after the metric, dots and all)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str, root: Path = ROOT):
    return load_module(Path(root) / "perfbench" / "drivers" / f"{kind}.py",
                       f"perfbench_driver_{kind}")


def reader(metric: str, root: Path = ROOT):
    return load_module(Path(root) / "perfbench" / "metrics" / f"{metric}.py",
                       "perfbench_metric_" + metric.replace(".", "_"))


# ---------------------------------------------------------------------------
# the port's model from a configuration file
# ---------------------------------------------------------------------------


def arch_config(arch: dict):
    """The port's ``ArchConfig`` with exactly the configuration file's
    fields (the rest at the class's defaults)."""
    from repro_torch.configs.base import ArchConfig

    return ArchConfig(**arch)


# ---------------------------------------------------------------------------
# seeds, weights and inputs
# ---------------------------------------------------------------------------


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of its own for each stream (weights 0, inputs 1, the
    sample the check takes 2) from the run's ``--seed``."""
    x = (int(seed) * _MIX + stream * 0xBF58476D1CE4E5B9 + 0x94D049BB133111EB) % (1 << 64)
    x ^= x >> 31
    return x % (1 << 63)


def _init_kind(name: str, shape: tuple, init_std: dict) -> tuple[float, float]:
    """(mean, std) of a leaf: the configuration's ``init_std`` where it
    names the leaf, else by the last part of its name: norm scales 1 +
    0.02 z, biases 0.02 z, the token embedding 0.01 z, every matrix z /
    sqrt(fan_in) (fan_in the second to last dim)."""
    if name in init_std:
        return 0.0, float(init_std[name])
    last = name.rsplit(".", 1)[-1]
    if last == "scale":
        return 1.0, 0.02
    if last in ("bq", "bk", "bv"):
        return 0.0, 0.02
    if name == "embed.tok":
        return 0.0, 0.01
    return 0.0, float(shape[-2]) ** -0.5


def fill_weights(leaves: list, seed: int, init_std: dict | None = None) -> None:
    """Fill ``leaves`` ((name, tensor), in order, on one device) in place from
    the seed: standard normal draws clamped at 3, made in ``WEIGHT_CHUNK``
    blocks by a generator on the tensors' device and handed out leaf after
    leaf, then shifted and scaled by ``_init_kind``.  The same names, shapes
    and seed give the same values."""
    import torch

    if not leaves:
        return
    device = leaves[0][1].device
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 0))
    left = sum(t.numel() for _, t in leaves)  # draws still to make
    buf, used = None, 0
    with torch.no_grad():
        for name, t in leaves:
            mean, std = _init_kind(name, tuple(t.shape), init_std or {})
            flat = t.view(-1)
            done = 0
            while done < flat.numel():
                if buf is None or used == buf.numel():
                    buf = torch.randn(min(WEIGHT_CHUNK, left), generator=gen, device=device)
                    buf.clamp_(-3.0, 3.0)
                    left -= buf.numel()
                    used = 0
                n = min(flat.numel() - done, buf.numel() - used)
                flat[done:done + n].copy_(buf[used:used + n] * std + mean)
                done += n
                used += n


def make_weights(shapes: list, seed: int, device, init_std: dict | None = None) -> dict:
    """``{name: tensor}`` for ``shapes`` ((name, shape, dtype), in order),
    allocated on ``device`` and filled by ``fill_weights``."""
    import torch

    leaves = [(n, torch.empty(s, dtype=dt, device=device)) for n, s, dt in shapes]
    fill_weights(leaves, seed, init_std)
    return dict(leaves)


def param_shapes(model) -> list:
    return [(n, tuple(p.shape), p.dtype) for n, p in model.named_parameters()]


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


def card_line() -> str | None:
    """``nvidia-smi``'s name and power limit of the card, or None."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def peak_of(kind: str | None) -> dict | None:
    """The table's peaks for a card whose name contains the table's key."""
    table = load_json(PERFBENCH / "peaks.json")["cards"]
    for key, peak in table.items():
        if kind and key in kind:
            return peak
    return None


def device_block(device, count: int, memory_peak: int) -> dict:
    import torch

    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": count, "memory_peak_bytes": int(memory_peak)}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": int(memory_peak)}


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def now(device) -> float:
    """``time.perf_counter()`` once the device has finished its queued work."""
    sync(device)
    return time.perf_counter()


def reset_peak(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    import torch

    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free(device) -> None:
    import gc

    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------


class Tracer:
    """``torch.profiler`` over a few calls, reduced to plain lists: the
    device's operations ``(name, start_us, end_us)``, the harness's own
    spans ``(name, start_us, end_us)`` (``record_function`` around each call
    into a layer) and the window ``(start_us, end_us)``."""

    def __init__(self, device, span_names: tuple):
        self.device = device
        self.span_names = set(span_names) | {"perfbench.window"}
        self.record: dict | None = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        sync(self.device)
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._window = torch.profiler.record_function("perfbench.window")
        self._window.__enter__()
        return self

    def __exit__(self, *exc):
        sync(self.device)
        self._window.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.record = reduce_events(self._prof.events(), self.span_names)
        return False


def reduce_events(events, span_names: set) -> dict:
    from torch.autograd import DeviceType

    device_ops, spans, host_ops = [], [], []
    for e in events:
        start, end = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            # the device-side copies of the harness's own spans are no operations
            if end > start and e.name not in span_names:
                device_ops.append((e.name, start, end))
        elif e.name in span_names:
            spans.append((e.name, start, end))
        elif end > start:
            host_ops.append((e.name, start, end))
    window = [s for s in spans if s[0] == "perfbench.window"]
    t0, t1 = (window[0][1], window[0][2]) if window else (0.0, 0.0)
    if device_ops:
        t1 = max(t1, max(end for _, _, end in device_ops))
    return {"device_ops": device_ops, "spans": [s for s in spans if s[0] != "perfbench.window"],
            "host_ops": host_ops, "window": (t0, t1)}


def union_length(intervals) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def busy_and_window(trace: dict) -> tuple[float, float] | None:
    """Seconds in which an operation ran on the device within the window,
    and the window's seconds; None when the trace holds no device
    operation."""
    t0, t1 = trace["window"]
    ops = [(max(s, t0), min(e, t1)) for _, s, e in trace["device_ops"] if e > t0 and s < t1]
    if not ops or t1 <= t0:
        return None
    return union_length(ops) / 1e6, (t1 - t0) / 1e6


def _innermost(events, times: list) -> list:
    """For each of ``times`` (sorted), the name of the latest-started event
    of ``events`` ((name, start, end)) still running then, or None: one
    sweep, as the events of a thread nest."""
    import heapq

    order = sorted(events, key=lambda ev: ev[1])
    running: list = []  # (-start, end, name)
    out, i = [], 0
    for t in times:
        while i < len(order) and order[i][1] <= t:
            heapq.heappush(running, (-order[i][1], order[i][2], order[i][0]))
            i += 1
        stale = [r for r in running if r[1] < t]
        if stale:
            running = [r for r in running if r[1] >= t]
            heapq.heapify(running)
        out.append(running[0][2] if running else None)
    return out


def breakdown(trace: dict, top: int = 10) -> dict:
    """The device operations that took most time (summed by name) and the
    idle time between device operations, summed by what the host was doing
    when the device went idle (the harness's span / the innermost host op)."""
    by_name: dict = {}
    for name, s, e in trace["device_ops"]:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    device_ops = [(n[:NAME_CHARS], v) for n, v in device_ops]
    t0, t1 = trace["window"]
    ops = sorted((s, e) for _, s, e in trace["device_ops"])
    gaps, end = [], t0
    for s, e in ops:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if t1 > end:
        gaps.append((end, t1))
    mids = [(s + e) / 2 for s, e in gaps]
    spans = _innermost(trace["spans"], mids)
    host = _innermost(trace["host_ops"], mids)
    idle: dict = {}
    for (s, e), span, op in zip(gaps, spans, host):
        label = f"{span or 'outside'}/{op or 'host'}"
        idle[label] = idle.get(label, 0.0) + (e - s) / 1e6
    idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v] for n, v in device_ops],
            "idle_gaps": [[n, v] for n, v in idle_gaps]}


# ---------------------------------------------------------------------------
# the result
# ---------------------------------------------------------------------------


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` of JAX or the JAX package."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def metric_value(value: float, unit: str) -> dict:
    return {"value": float(value), "unit": unit}


def finite(x) -> bool:
    return x is not None and isinstance(x, (int, float)) and math.isfinite(x)


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Every number the cell's ``limits`` name beside its limit; correct
    when each is finite and at most its limit."""
    checks, ok = {}, True
    for key, limit in limits.items():
        value = numbers.get(key)
        good = finite(value) and value <= limit
        ok = ok and good
        checks[key] = {"value": value if finite(value) else str(value), "limit": limit}
    return ok, checks


MARKS: dict = {}  # set-up's milestones: name -> time.perf_counter()


def mark(name: str, device=None) -> None:
    """Note the time a step of set-up ended (``readings["setup_marks_s"]``),
    once ``device`` has finished its queued work."""
    if device is not None:
        sync(device)
    MARKS[name] = time.perf_counter()


def set_cache_dirs(root: Path = ROOT) -> None:
    """Fixed cache directories inside the checkout for whatever the program
    or PyTorch builds (the port's nvcc libraries go to ``build/repro_torch``
    on their own)."""
    build = Path(root) / "build" / "perfbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
