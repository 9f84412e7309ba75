"""BENCHMARK.json against the rules its format sets, and against the files it
names."""
import json
import re

import pytest

from perfbench import harness as hx

MAN = hx.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
E2E = {m["name"]: m for m in MAN["end_to_end"]}
CELLS = [w["name"] for w in MAN["workloads"]]


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level_keys_and_limits():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert 1 <= len(MAN["paths"]) <= 16 and 1 <= len(MAN["command"]) <= 32
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) <= 64 * 1024
    for p in MAN["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", p) and ".." not in p
        assert (hx.ROOT / p).is_dir()
    for word in MAN["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        if word.endswith(".py"):
            assert any(word.startswith(p + "/") for p in MAN["paths"])


def test_names_and_units():
    names = ([c["name"] for c in MAN["configs"]] + CELLS
             + [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in MAN["workloads"]:
        assert NAME.match(w["traffic"]) and 1 <= len(w["why"]) <= 200
    for c in MAN["configs"]:
        for key in c["reduced"]:
            assert NAME.match(key)


def test_end_to_end_bounds_and_sources():
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for cell in CELLS:
        e2e = [m for m in MAN["end_to_end"] if _reports(m, cell)]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert any(_reports(m, cell) for m in MAN["per_layer"])


def test_every_moves_is_reported_where_the_metric_is():
    for m in MAN["per_layer"]:
        assert m["moves"] in E2E and m["moves"] != "setup_s"
        for cell in [c for c in CELLS if _reports(m, c)]:
            assert _reports(E2E[m["moves"]], cell), (m["name"], cell)
    layers = {}
    for m in MAN["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])


def test_cells_one_chip_and_files():
    configs = {c["name"]: c for c in MAN["configs"]}
    used = set()
    pairs = set()
    for w in MAN["workloads"]:
        assert w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        cell = hx.find_cell(w["name"])
        assert (hx.PERFBENCH / "drivers" / f"{cell.workload['kind']}.py").is_file()
        assert set(cell.workload["limits"]) and all(v > 0 for v in cell.workload["limits"].values())
    assert used == set(configs)
    for c in MAN["configs"]:
        data = hx.load_json(hx.ROOT / c["file"])
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert sorted(data["reduced"]) == sorted(c["reduced"])
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["per_layer"]])
def test_each_per_layer_metric_has_a_reader(metric):
    mod = hx.reader(metric)
    assert mod.read({}, None) is None


def test_reduced_names_no_width():
    width = re.compile(r"(_size$|_dim$|_rank$|latent|state|projection|expansion|expand|"
                       r"per_tok)")
    for c in MAN["configs"]:
        for key in c["reduced"]:
            assert key == "vocab_size" or not width.search(key), key
