"""``repro_torch.kernels._build``: a kernel's library is named by the hash
of its source, of the local headers it includes (directly or through
another header) and of the nvcc flags, so an edited header or flag builds a
new library instead of loading a stale one.  Runs on the CPU: it computes
paths and never calls nvcc."""
from __future__ import annotations

import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (src / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\n'
                              "int f() { return g(); }\n")
    (src / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n'
                               "inline int g() { return h(); }\n")
    (src / "b.cuh").write_text('#pragma once\n#include "a.cuh"  // a cycle\n'
                               "inline int h() { return 1; }\n")
    (src / "other.cu").write_text("int u() { return 2; }\n")
    (src / "unused.cuh").write_text("inline int z() { return 3; }\n")
    return src


def test_sources_follow_local_includes_recursively(csrc):
    assert sorted(p.name for p in _build.sources("k")) == ["a.cuh", "b.cuh", "k.cu"]
    assert [p.name for p in _build.sources("other")] == ["other.cu"]


@pytest.mark.parametrize("edit", ["k.cu", "a.cuh", "b.cuh"])
def test_path_changes_with_the_source_or_an_included_header(csrc, edit):
    before = _build.library_path("k")
    path = csrc / edit
    text = path.read_text()
    path.write_text(text + "// edited\n")
    assert _build.library_path("k") != before
    path.write_text(text)
    assert _build.library_path("k") == before


@pytest.mark.parametrize("edit", ["other.cu", "unused.cuh"])
def test_path_stays_when_a_file_it_does_not_include_changes(csrc, edit):
    before = _build.library_path("k")
    (csrc / edit).write_text("// edited\n")
    assert _build.library_path("k") == before


@pytest.mark.parametrize("flag", ["-I/usr/local/cutlass/include", "-lcuda", "-lineinfo"])
def test_path_changes_with_the_nvcc_flags(csrc, monkeypatch, flag):
    before = {name: _build.library_path(name) for name in ("k", "other")}
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + (flag,))
    for name, path in before.items():
        assert _build.library_path(name) != path
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS[:-1])
    assert {name: _build.library_path(name) for name in before} == before


def test_path_is_stable_and_named_after_the_kernel(csrc):
    path = _build.library_path("k")
    assert path == _build.library_path("k")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("k-") and path.suffix == ".so"


def test_the_attention_kernel_hashes_its_header():
    assert [p.name for p in _build.sources("attention")] == ["attention.cu", "hopper.cuh"]
    for name in ("dram_timing", "edge_update", "spmv"):
        assert [p.name for p in _build.sources(name)] == [f"{name}.cu"]
