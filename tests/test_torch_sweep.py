"""The port's sweep runner (``repro_torch.sweep``) against the reference's
(``repro.sweep``): spec expansion, cache keys, result rows in every
execution mode, cache behaviour, the semantic-engine axis, the CLI, and
the device policy.  Everything runs on the CPU (``device="cpu"``).

``tests/data/torch_golden_sweep.json`` holds the reference's ``tab4`` rows
on the paper graph ``lj``; ``chip_smoke.py`` holds the port's sweeps on the
card against it (the card's machine has no JAX).  Regenerate it (about
half a minute on a CPU):

    PYTHONPATH=src python tests/test_torch_sweep.py --write
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
from pathlib import Path

import pytest

if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
pytest.importorskip("jax")
import torch  # noqa: E402

import repro.configs.graphsim as ref_graphsim  # noqa: E402
import repro.sweep as ref_sweep  # noqa: E402
import repro.sweep.__main__ as ref_cli  # noqa: E402
import repro.sweep.cache as ref_cache  # noqa: E402
import repro_torch.configs.graphsim as graphsim  # noqa: E402
import repro_torch.sweep as sweep  # noqa: E402
import repro_torch.sweep.__main__ as cli  # noqa: E402
import repro_torch.sweep.cache as cache_mod  # noqa: E402
from repro.graph.generators import GraphSpec as RefGraphSpec  # noqa: E402
from repro_torch.core.dram import dram_config  # noqa: E402
from repro_torch.graph.generators import GraphSpec  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
GOLDEN_PATH = ROOT / "tests" / "data" / "torch_golden_sweep.json"
# the paper's tab4 (benchmarks/run.py::bench_tab4) on lj: what chip_smoke
# drives through the port on the card
GOLDEN_SPEC = dict(accelerators=("accugraph", "foregraph", "hitgraph", "thundergp"),
                   graphs=("lj",), problems=("bfs", "pr", "wcc"))
ACCELS = GOLDEN_SPEC["accelerators"]

_GRAPH_ARGS = dict(tiny=("tiny", "uniform", 256, 1024, True, 1, 0),
                   tiny2=("tiny2", "uniform", 200, 800, True, 2, 0),
                   broken=("broken", "no-such-generator", 64, 128, True, 1, 0))


class Side:
    """One package's sweep API, so that a test builds the same spec in
    both: ``Side(ref=True)`` is the JAX reference, ``Side()`` the port."""

    def __init__(self, ref: bool = False):
        self.ref = ref
        self.mod = ref_sweep if ref else sweep
        gs = RefGraphSpec if ref else GraphSpec
        self.g = {k: gs(*v) for k, v in _GRAPH_ARGS.items()}

    def spec(self, name="t", accels=("accugraph",), problems=("bfs",),
             graphs=("tiny",), **kw):
        graphs = tuple(self.g.get(g, g) for g in graphs)
        if "overrides" in kw:
            kw["overrides"] = tuple(self.mod.ConfigOverride(**o) for o in kw["overrides"])
        return self.mod.SweepSpec(name=name, accelerators=tuple(accels),
                                  graphs=graphs, problems=tuple(problems), **kw)

    def run(self, spec, **kw):
        if not self.ref:
            kw.setdefault("device", "cpu")
        return self.mod.run_sweep(spec, **kw)


REF, PORT = Side(ref=True), Side()

# the specs of tests/test_sweep.py, plus every axis the expansion knows
SPECS = {
    "cross_product": dict(accels=("accugraph", "hitgraph"), problems=("bfs", "pr"),
                          graphs=("tiny", "tiny2")),
    "weighted_filter": dict(accels=ACCELS, problems=("bfs", "sssp")),
    "multichannel": dict(accels=("accugraph", "hitgraph"),
                         drams=(("default", 1), ("default", 4))),
    "model_rejected": dict(accels=("foregraph",),
                           overrides=(dict(label="huge", interval_size=1 << 20),)),
    "ablations": dict(accels=("hitgraph",), overrides=(
        dict(), dict(label="none", optimizations=frozenset()),
        dict(label="pes", n_pes=2, engine="fast"))),
    "memory_axes": dict(accels=ACCELS, drams=("default", "hbm", "ddr3"),
                        mappings=("row", "bank", "bank_xor", "row@32"),
                        page_policies=("open", "closed"), pseudo_channels=(False, True)),
    "layout_axes": dict(accels=ACCELS, reorders=("identity", "degree", "bfs", "random"),
                        interval_scales=(1, 2, 32)),
    "engines": dict(accels=ACCELS, problems=("bfs", "pr", "wcc", "sssp", "spmv"),
                    engines=("numpy", "device")),
    "paper_graphs": dict(accels=ACCELS, graphs=("sd", "db"), problems=("bfs", "pr")),
}


def _scenario_view(s) -> tuple:
    return (s.scenario_id, s.graph.canonical(), s.accelerator, s.problem,
            dataclasses.asdict(s.dram), dataclasses.asdict(s.config), s.root, s.label)


# ---- spec expansion ----------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SPECS))
def test_expand_matches_reference_point_for_point(name):
    ref_sc, ref_sk = REF.spec(**SPECS[name]).expand()
    port_sc, port_sk = PORT.spec(**SPECS[name]).expand()
    assert [_scenario_view(s) for s in port_sc] == [_scenario_view(s) for s in ref_sc]
    assert [dataclasses.astuple(s) for s in port_sk] == \
        [dataclasses.astuple(s) for s in ref_sk]
    spec = PORT.spec(**SPECS[name])
    assert spec.n_points == REF.spec(**SPECS[name]).n_points
    assert [p.scenario_id if isinstance(p, sweep.Scenario) else p.reason
            for p in spec.iter_points()] == \
        [p.scenario_id if isinstance(p, ref_sweep.Scenario) else p.reason
         for p in REF.spec(**SPECS[name]).iter_points()]


def test_expand_covers_every_kind_of_skip():
    reasons = " ".join(sk.reason for name in SPECS
                       for sk in PORT.spec(**SPECS[name]).expand()[1])
    # (every preset has a power-of-two bank count, so bank_xor never skips)
    for part in ("weighted", "multi-channel", "65,536", "pseudo-channels require HBM",
                 "channel-interleave granularity"):
        assert part in reasons, part


@pytest.mark.parametrize("bad", [
    dict(accels=("bogus",)), dict(drams=("nodram",)), dict(graphs=("nograph",)),
    dict(drams=(("default", 0),)), dict(problems=("nope",)), dict(mappings=("diag",)),
    dict(page_policies=("ajar",)), dict(pseudo_channels=(2,)), dict(reorders=("spiral",)),
    dict(interval_scales=(3,)), dict(engines=("gpu",)),
])
def test_expand_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError) as ref_err:
        REF.spec(**bad).expand()
    with pytest.raises(ValueError) as port_err:
        PORT.spec(**bad).expand()
    assert str(port_err.value) == str(ref_err.value)


def test_sweep_axes_presets_match_reference():
    for name in ("MEMORY_AXES", "MEMORY_SENSITIVITY_AXES", "LAYOUT_AXES"):
        assert getattr(graphsim, name) == getattr(ref_graphsim, name), name


# ---- cache keys --------------------------------------------------------------


@pytest.mark.parametrize("name", ["memory_axes", "layout_axes", "engines", "ablations"])
def test_scenario_key_is_the_reference_key_plus_the_backend_tag(name):
    for p, r in zip(PORT.spec(**SPECS[name]).scenarios(),
                    REF.spec(**SPECS[name]).scenarios(), strict=True):
        key = sweep.scenario_key(p)
        assert key.pop("backend") == cache_mod.BACKEND == "repro_torch"
        assert key == ref_sweep.scenario_key(r)
        assert sweep.scenario_hash(p) != ref_sweep.scenario_hash(r)


def _variants(base):
    """``base`` moved along every axis of the key, one at a time."""
    cfg, dram = base.config, base.dram
    return [
        dataclasses.replace(base, graph=dataclasses.replace(base.graph, seed=9)),
        dataclasses.replace(base, accelerator="hitgraph"),
        dataclasses.replace(base, problem="pr"),
        dataclasses.replace(base, root=1),
        dataclasses.replace(base, dram=dram_config("hbm")),
        dataclasses.replace(base, dram=dram_config("default", channels=2)),
        dataclasses.replace(base, dram=dram_config("default", mapping="bank")),
        dataclasses.replace(base, dram=dram_config("default", page_policy="closed")),
        dataclasses.replace(base, dram=dram_config("hbm", pseudo_channels=True)),
    ] + [dataclasses.replace(base, config=dataclasses.replace(cfg, **kw)) for kw in (
        dict(interval_size=512), dict(n_pes=2), dict(optimizations=frozenset()),
        dict(engine="fast"), dict(max_iters=7), dict(scan_cutoff=99),
        dict(reorder="degree"), dict(interval_scale=2), dict(semexec="device"))]


def test_scenario_hash_stable_and_sensitive_to_every_axis():
    base = PORT.spec().scenarios()[0]
    assert sweep.scenario_hash(base) == sweep.scenario_hash(PORT.spec().scenarios()[0])
    hashes = [sweep.scenario_hash(s) for s in [base] + _variants(base)]
    assert len(set(hashes)) == len(hashes)
    # the override label is presentation-only, and the device is no axis
    assert sweep.scenario_hash(dataclasses.replace(base, label="x")) == hashes[0]


def test_engine_version_and_backend_move_the_hash(monkeypatch):
    s = PORT.spec().scenarios()[0]
    h = sweep.scenario_hash(s)
    monkeypatch.setattr(cache_mod, "ENGINE_VERSION", "test-bump")
    assert sweep.scenario_hash(s) != h
    monkeypatch.undo()
    monkeypatch.setattr(cache_mod, "BACKEND", "repro")
    assert sweep.scenario_hash(s) != h


def test_result_cache_envelope_and_quarantine_are_the_reference_s(tmp_path):
    port, ref = sweep.ResultCache(str(tmp_path / "p")), ref_sweep.ResultCache(str(tmp_path / "r"))
    h, rec = "ab" * 32, {"status": "ok", "x": 1}
    port.put(h, rec)
    ref.put(h, rec)
    assert open(port.path(h)).read() == open(ref.path(h)).read()
    assert port.lookup_many([h, "cd" * 32]) == {h: rec}
    with open(port.path(h), "w") as f:
        f.write("{torn")
    assert port.get(h) is None and os.path.exists(port.path(h) + ".bad")
    assert cache_mod.record_digest(rec) == ref_cache.record_digest(rec)


# ---- result rows: every execution mode against the reference -----------------

ROW_SPEC = dict(accels=ACCELS, problems=("bfs", "pr", "sssp"), graphs=("tiny", "tiny2"),
                drams=("default", "hbm"))
_REF_ROWS: dict = {}


def _ref_rows(name: str, spec_kw: dict) -> list[dict]:
    if name not in _REF_ROWS:
        _REF_ROWS[name] = ref_sweep.result_rows(REF.run(REF.spec(**spec_kw)))
    return _REF_ROWS[name]


@pytest.mark.parametrize("mode,workers", [("scenario", 0), ("batch", 0), ("batch", 2),
                                          ("scenario", 2)])
def test_rows_equal_reference_rows(mode, workers):
    result = PORT.run(PORT.spec(**ROW_SPEC), mode=mode, workers=workers)
    assert result.n_errors == 0 and len(result.results) == 40
    assert not any("timing_fallback" in r.record for r in result.results)
    assert sweep.result_rows(result) == _ref_rows("rows", ROW_SPEC)


def test_engine_axis_rows_equal_reference_and_numpy_rows():
    """``engines=("numpy", "device")`` on the CPU: the device engine runs
    with the kernels' plain versions, every row equals the reference's, and
    each device row equals its numpy row apart from ``engine``."""
    kw = dict(accels=ACCELS, problems=("bfs", "pr", "wcc", "sssp"),
              engines=("numpy", "device"))
    rows = sweep.result_rows(PORT.run(PORT.spec(**kw), mode="batch"))
    assert rows == _ref_rows("engines", kw)
    numpy_rows, device_rows = rows[0::2], rows[1::2]
    assert {r["engine"] for r in numpy_rows} == {"numpy"}
    assert {r["engine"] for r in device_rows} == {"device"}
    for n, d in zip(numpy_rows, device_rows, strict=True):
        assert {**d, "engine": "numpy"} == n


def test_rows_match_direct_execution():
    from repro_torch.configs.graphsim import default_config
    from repro_torch.core.accelerators import run_accelerator
    from repro_torch.graph.problems import PROBLEMS

    rows = sweep.result_rows(PORT.run(PORT.spec(accels=("accugraph", "hitgraph"))))
    g = PORT.g["tiny"].build()
    for row in rows:
        rep = run_accelerator(row["accelerator"], g, PROBLEMS["bfs"], 0,
                              dram_config("default"), default_config(row["accelerator"]),
                              device="cpu")
        assert (row["runtime_s"], row["mteps"], row["iterations"]) == \
            (rep.runtime_s, rep.mteps, rep.iterations)


def test_batch_timing_fallback_is_recorded_on_the_same_device(monkeypatch):
    """A failure of the shared timing pass falls back to per-scenario
    timing on the same device; every record says so, the rows do not
    change."""
    import repro_torch.core.engine as engine

    def broken(items, device=None):
        raise RuntimeError("grouped pass failed")

    want = sweep.result_rows(PORT.run(PORT.spec(accels=ACCELS), mode="batch"))
    monkeypatch.setattr(engine, "simulate_many", broken)
    result = PORT.run(PORT.spec(accels=ACCELS), mode="batch")
    assert all("grouped pass failed" in r.record["timing_fallback"]
               for r in result.results)
    assert sweep.result_rows(result) == want


# ---- cache behaviour ---------------------------------------------------------


def test_second_run_is_all_cache_hits(tmp_path):
    spec = PORT.spec(accels=("accugraph", "foregraph"))
    first = PORT.run(spec, cache_dir=str(tmp_path))
    assert first.n_executed == 2 and first.n_cached == 0
    second = PORT.run(spec, cache_dir=str(tmp_path), mode="batch")
    assert second.all_cached and second.n_executed == 0
    assert sweep.result_rows(second) == sweep.result_rows(first)


def test_port_and_reference_records_never_share_a_cache_address(tmp_path):
    spec_kw = dict(accels=("accugraph", "hitgraph"))
    REF.run(REF.spec(**spec_kw), cache_dir=str(tmp_path))
    port = PORT.run(PORT.spec(**spec_kw), cache_dir=str(tmp_path))
    assert port.n_cached == 0 and port.n_executed == 2
    assert len(list(tmp_path.rglob("*.json"))) == 4


def test_interrupted_sweep_resumes_with_identical_csv(tmp_path):
    spec = PORT.spec(accels=ACCELS)
    full = PORT.run(spec, cache_dir=str(tmp_path / "full"))
    sweep.write_csv(str(tmp_path / "full.csv"), sweep.result_rows(full))
    done = 0

    def kill_after_two(msg):
        nonlocal done
        if " ok " in msg:
            done += 1
            if done == 2:
                raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        PORT.run(spec, cache_dir=str(tmp_path / "cache"), progress=kill_after_two)
    resumed = PORT.run(spec, cache_dir=str(tmp_path / "cache"))
    assert (resumed.n_cached, resumed.n_executed, resumed.n_errors) == (2, 2, 0)
    sweep.write_csv(str(tmp_path / "resumed.csv"), sweep.result_rows(resumed))
    assert (tmp_path / "resumed.csv").read_bytes() == (tmp_path / "full.csv").read_bytes()


@pytest.mark.parametrize("mode", ["scenario", "batch"])
def test_errors_are_isolated_and_not_cached(tmp_path, mode):
    spec_kw = dict(graphs=("broken", "tiny"), accels=("accugraph", "hitgraph"))
    result = PORT.run(PORT.spec(**spec_kw), cache_dir=str(tmp_path), mode=mode)
    assert result.n_errors == 2 and result.n_executed == 4
    assert all("no-such-generator" in r.record["error"]
               for r in result.results if r.status == "error")
    assert sweep.result_rows(result) == _ref_rows("errors", spec_kw)
    again = PORT.run(PORT.spec(**spec_kw), cache_dir=str(tmp_path), mode=mode)
    assert again.n_cached == 2 and again.n_errors == 2


def test_duplicate_scenarios_execute_once():
    spec = PORT.spec(overrides=(dict(), dict(label="all", optimizations=frozenset({"all"}))))
    result = PORT.run(spec)
    assert result.results[0].hash == result.results[1].hash
    r0, r1 = sweep.result_rows(result)
    assert r0["runtime_s"] == r1["runtime_s"] and r1["label"] == "all"


# ---- device policy -----------------------------------------------------------


def test_default_device_raises_without_cuda(monkeypatch, tmp_path):
    from repro_torch.sweep import runner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = PORT.spec()
    (scn,) = spec.scenarios()
    for call in (lambda: sweep.run_sweep(spec, cache_dir=str(tmp_path)),
                 lambda: sweep.run_sweep(spec, device="cuda"),
                 lambda: sweep.execute_scenario(scn),
                 lambda: sweep.execute_scenario_policied(scn),
                 lambda: sweep.execute_scenarios_batch([scn]),
                 lambda: sweep.execute_chunk([scn], "batch"),
                 lambda: runner.execute_chunk([scn], device="cuda:0")):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not list(tmp_path.rglob("*.json"))  # nothing ran, nothing cached
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--accels", "accugraph", "--graphs", "sd", "--cache", str(tmp_path),
                  "--out", str(tmp_path / "out")])


def test_device_crosses_into_spawn_workers_as_a_string(monkeypatch):
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.sweep import runner

    submitted = []
    real_submit = ProcessPoolExecutor.submit

    def submit(self, fn, *args, **kw):
        submitted.append(kw.get("device"))
        return real_submit(self, fn, *args, **kw)

    monkeypatch.setattr(ProcessPoolExecutor, "submit", submit)
    result = runner.run_sweep(PORT.spec(accels=("accugraph", "hitgraph")),
                              workers=2, mode="batch", device=torch.device("cpu"))
    assert result.n_errors == 0 and submitted == ["cpu", "cpu"]


# ---- CLI ---------------------------------------------------------------------

CLI_AXES = ["--accels", "accugraph,hitgraph", "--graphs", "sd", "--problems", "bfs,pr"]


def test_cli_writes_the_reference_s_rows_then_serves_them_cached(tmp_path, capsys):
    assert ref_cli.main(CLI_AXES + ["--cache", str(tmp_path / "rc"),
                                    "--out", str(tmp_path / "ro")]) == 0
    argv = CLI_AXES + ["--device", "cpu", "--cache", str(tmp_path / "c"),
                       "--out", str(tmp_path / "o")]
    assert cli.main(argv) == 0
    for ext in ("csv", "json"):
        assert (tmp_path / "o" / f"sweep.{ext}").read_bytes() == \
            (tmp_path / "ro" / f"sweep.{ext}").read_bytes()
    capsys.readouterr()
    assert cli.main(argv) == 0
    assert "4 scenarios (4 cached, 0 executed, 0 errors, 0 skipped)" in capsys.readouterr().out


def test_cli_list_and_clean_errors(capsys):
    assert cli.main(["--graphs", "sd", "--problems", "bfs,sssp", "--list"]) == 0
    port_out = capsys.readouterr().out
    assert ref_cli.main(["--graphs", "sd", "--problems", "bfs,sssp", "--list"]) == 0
    assert port_out == capsys.readouterr().out
    assert cli.main(["--accels", "bogus", "--device", "cpu"]) == 2
    assert "unknown accelerator" in capsys.readouterr().err


def test_cli_search_is_not_ported(tmp_path, capsys):
    """The ``search`` subcommand (ported since; the name is kept) runs on
    the CPU with ``--device cpu``: every point of a 2-point space, then
    again all warm from the cache."""
    argv = ["search", "--accels", "accugraph,hitgraph", "--graphs", "sd", "--budget", "2",
            "--device", "cpu", "--cache", str(tmp_path / "c"), "--out", str(tmp_path / "o")]
    assert cli.main(argv) == 0
    assert "search[objective]: 2 executed (+0 cached, +0 warm) of 2" in \
        capsys.readouterr().out
    assert (tmp_path / "o" / "sweep_probes.csv").exists()
    assert cli.main(argv) == 0
    assert "0 executed (+0 cached, +2 warm) of 2" in capsys.readouterr().out


# ---- the golden rows chip_smoke.py holds the card against ----------------------


def golden_spec(side: Side, **kw):
    return side.mod.SweepSpec(name="tab4", **{**GOLDEN_SPEC, **kw})


def write_golden() -> None:
    result = REF.run(golden_spec(REF), progress=print)
    assert result.n_errors == 0
    GOLDEN_PATH.write_text(json.dumps(dict(
        spec={k: list(v) for k, v in GOLDEN_SPEC.items()},
        rows=ref_sweep.result_rows(result)), indent=1) + "\n")


def test_sweep_golden_file_matches_reference():
    """The file's spec is the port's tab4 on lj, its rows in expansion
    order, and its first rows are what ``repro.sweep`` produces now."""
    golden = json.loads(GOLDEN_PATH.read_text())
    assert golden["spec"] == {k: list(v) for k, v in GOLDEN_SPEC.items()}
    rows = golden["rows"]
    assert [(r["graph"], r["accelerator"], r["problem"]) for r in rows] == \
        [(s.graph.name, s.accelerator, s.problem) for s in golden_spec(PORT).scenarios()]
    first = REF.run(golden_spec(REF, accelerators=("accugraph",), problems=("bfs", "pr")))
    assert ref_sweep.result_rows(first) == rows[:2]


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: PYTHONPATH=src python tests/test_torch_sweep.py --write")
    write_golden()
