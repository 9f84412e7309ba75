"""Full-size goldens of the PyTorch port, and its device policy.

``tests/data/torch_golden_reports.json`` records, for 18 scenarios on each
of the paper graphs ``lj`` and ``sd``, what the JAX reference produces:
the request-stream hash, the ``TimingReport``, the iteration count and a
hash of the final values.  The card's machine has no JAX, so
``chip_smoke.py`` holds the port's full-size (``lj``) runs on the card
against this file.  Here, on the CPU, the ``sd`` half is recomputed from
both packages and must equal the file, so the file cannot drift.

Regenerate the file (about a minute on a CPU):

    PYTHONPATH=src python tests/test_torch_golden.py --write
"""
from __future__ import annotations

import ast
import hashlib
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs.graphsim import default_config as ref_default_config  # noqa: E402
from repro.core.accelerators import ACCELERATORS as REF_ACCELERATORS  # noqa: E402
from repro.core.dram import dram_config as ref_dram_config  # noqa: E402
from repro.core.trace import trace_stream_hash as ref_trace_stream_hash  # noqa: E402
from repro.graph.generators import PAPER_GRAPHS as REF_PAPER_GRAPHS  # noqa: E402
from repro.graph.problems import PROBLEMS as REF_PROBLEMS  # noqa: E402
from repro_torch.configs.graphsim import default_config  # noqa: E402
from repro_torch.core.accelerators import ACCELERATORS, AccelConfig, run_accelerator  # noqa: E402
from repro_torch.core.dram import dram_config  # noqa: E402
from repro_torch.core.trace import trace_stream_hash  # noqa: E402
from repro_torch.graph.generators import PAPER_GRAPHS  # noqa: E402
from repro_torch.graph.problems import PROBLEMS  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
GOLDEN_PATH = ROOT / "tests" / "data" / "torch_golden_reports.json"
GOLDEN_GRAPHS = ("lj", "sd")


def golden_scenarios(graph: str) -> list[dict]:
    """4 accelerators x {bfs, pr} x {the accelerator's own preset, hbm},
    plus two controller corners: 18 scenarios."""
    out = []
    for accel, cls in REF_ACCELERATORS.items():
        for prob in ("bfs", "pr"):
            for dram in (cls.default_dram, "hbm"):
                out.append(dict(graph=graph, accelerator=accel, problem=prob,
                                dram=dram, mapping="row", page_policy="open",
                                pseudo_channels=False))
    out.append(dict(graph=graph, accelerator="hitgraph", problem="bfs",
                    dram="hbm", mapping="bank_xor", page_policy="open",
                    pseudo_channels=True))
    out.append(dict(graph=graph, accelerator="thundergp", problem="bfs",
                    dram="default", mapping="row", page_policy="closed",
                    pseudo_channels=False))
    for sc in out:
        key = f"{graph}/{sc['accelerator']}/{sc['problem']}/{sc['dram']}"
        if sc["mapping"] != "row":
            key += f"/{sc['mapping']}"
        if sc["pseudo_channels"]:
            key += "/pc"
        if sc["page_policy"] != "open":
            key += f"/{sc['page_policy']}"
        sc["key"] = key
    return out


def _record(traces_hash: str, rep) -> dict:
    return dict(trace_hash=traces_hash[:16], timing=rep.timing.to_dict(),
                iterations=int(rep.iterations),
                values_sha256=hashlib.sha256(
                    np.ascontiguousarray(rep.values).tobytes()).hexdigest())


def run_reference(sc: dict, graphs: dict) -> dict:
    spec = REF_PAPER_GRAPHS[sc["graph"]]
    if ("ref", sc["graph"]) not in graphs:
        graphs[("ref", sc["graph"])] = spec.build()
    g = graphs[("ref", sc["graph"])]
    dram = ref_dram_config(sc["dram"], mapping=sc["mapping"],
                           page_policy=sc["page_policy"],
                           pseudo_channels=sc["pseudo_channels"])
    acc = REF_ACCELERATORS[sc["accelerator"]](ref_default_config(sc["accelerator"]))
    pending = acc.prepare(g, REF_PROBLEMS[sc["problem"]], root=spec.root, dram=dram)
    return _record(ref_trace_stream_hash(pending.traces()), pending.finalize())


def run_port(sc: dict, graphs: dict) -> dict:
    spec = PAPER_GRAPHS[sc["graph"]]
    if ("port", sc["graph"]) not in graphs:
        graphs[("port", sc["graph"])] = spec.build()
    g = graphs[("port", sc["graph"])]
    dram = dram_config(sc["dram"], mapping=sc["mapping"],
                       page_policy=sc["page_policy"],
                       pseudo_channels=sc["pseudo_channels"])
    acc = ACCELERATORS[sc["accelerator"]](default_config(sc["accelerator"]))
    pending = acc.prepare(g, PROBLEMS[sc["problem"]], root=spec.root, dram=dram)
    return _record(trace_stream_hash(pending.traces()), pending.finalize(device="cpu"))


def write_golden() -> None:
    graphs: dict = {}
    scenarios = []
    for graph in GOLDEN_GRAPHS:
        for sc in golden_scenarios(graph):
            rec = run_reference(sc, graphs)
            scenarios.append({**sc, **rec})
            print(sc["key"], rec["trace_hash"], rec["timing"]["time_ns"], flush=True)
    GOLDEN_PATH.parent.mkdir(parents=True, exist_ok=True)
    GOLDEN_PATH.write_text(json.dumps(dict(scenarios=scenarios), indent=1) + "\n")


def _golden() -> dict:
    return {s["key"]: s for s in json.loads(GOLDEN_PATH.read_text())["scenarios"]}


def test_golden_file_covers_the_scenarios():
    golden = _golden()
    for graph in GOLDEN_GRAPHS:
        for sc in golden_scenarios(graph):
            assert sc["key"] in golden, sc["key"]
            assert {k: golden[sc["key"]][k] for k in sc} == sc
    assert len(golden) == 18 * len(GOLDEN_GRAPHS)


_GRAPHS: dict = {}  # built graphs, shared by the cases below


@pytest.mark.parametrize("key", [sc["key"] for sc in golden_scenarios("sd")])
def test_sd_goldens_match_reference_and_port(key):
    """The sd half of the file, recomputed: reference == file == port.
    Exact: ints, floats (same float code), iterations and value bytes."""
    golden = _golden()
    sc = next(s for s in golden_scenarios("sd") if s["key"] == key)
    want = {k: golden[key][k]
            for k in ("trace_hash", "timing", "iterations", "values_sha256")}
    assert run_reference(sc, _GRAPHS) == want
    assert run_port(sc, _GRAPHS) == want


# ---------------- device policy ----------------------------------------------


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = PAPER_GRAPHS["sd"].build()
    with pytest.raises(RuntimeError, match="CUDA"):
        run_accelerator("hitgraph", g, PROBLEMS["bfs"], 0)
    from repro_torch.graph.problems import reference_solve
    with pytest.raises(RuntimeError, match="CUDA"):
        reference_solve(g, PROBLEMS["bfs"], 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_accelerator("hitgraph", g, PROBLEMS["bfs"], 0, device="cuda")


def test_semexec_device_is_accepted():
    assert AccelConfig(semexec="device").semexec == "device"
    with pytest.raises(ValueError, match="unknown semantic engine"):
        AccelConfig(semexec="gpu")
    from repro_torch.core import semexec
    assert semexec.resolve_engine("hitgraph", "bfs", "numpy") == "numpy"
    assert semexec.resolve_engine("hitgraph", "bfs", "device") == "device"


_FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_port_imports_nothing_of_jax_or_the_reference():
    port = ROOT / "src" / "repro_torch"
    # the port's bench harness and the pure-data module it reads
    files = sorted(port.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "kernel_ab.py",
                                          ROOT / "benchmarks" / "run_torch.py",
                                          ROOT / "benchmarks" / "paper_data.py"]
    files += sorted((ROOT / "benchmarks").glob("bench_*_torch.py"))
    assert len(files) > 20
    # every CUDA source's Python wrapper and ops, and the device engine
    must_cover = [port / "core" / "semexec.py", port / "core" / "trace.py",
                  port / "kernels" / "_build.py", port / "kernels" / "_platform.py"]
    for cu in sorted((port / "csrc").glob("*.cu")):
        pkg = port / "kernels" / cu.stem
        must_cover += [pkg / "__init__.py", pkg / f"{cu.stem}.py"]
    assert {"dram_timing", "edge_update", "spmv", "attention"} <= \
        {p.parent.name for p in must_cover}
    must_cover += [port / "kernels" / k / "ops.py" for k in ("edge_update", "spmv", "attention")]
    # the LM serving path: configs, models, the engine and the weight carrier
    must_cover += [port / "configs" / "base.py", port / "configs" / "qwen3_0_6b.py",
                   port / "interop.py", port / "serve" / "legacy" / "engine.py",
                   port / "serve" / "legacy" / "serve_step.py"]
    must_cover += [port / "models" / f"{m}.py"
                   for m in ("__init__", "layers", "attention", "transformer", "model",
                             "moe", "ssm")]
    # the sweep runner, its fault plans and the whole-trace DRAM timing ops
    must_cover += [port / "sweep" / f"{m}.py"
                   for m in ("__init__", "__main__", "spec", "cache", "runner", "results")]
    must_cover += [port / "distributed" / "__init__.py", port / "distributed" / "faults.py",
                   port / "kernels" / "dram_timing" / "ops.py"]
    # multi-host serving and the port's twins of the serve benches
    must_cover += [port / "distributed" / "remote.py",
                   ROOT / "benchmarks" / "bench_multihost_torch.py",
                   ROOT / "benchmarks" / "bench_faults_torch.py"]
    for f in must_cover:
        assert f in files, f"{f.relative_to(ROOT)} is missing"
    for f in files:
        bad = _imported_roots(f) & set(_FORBIDDEN)
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: PYTHONPATH=src python tests/test_torch_golden.py --write")
    write_golden()
