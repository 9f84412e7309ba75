"""What the harness may import: never JAX or the JAX package (``repro``,
compared by the whole top-level name, so ``repro_torch`` passes); never
the repository's ``benchmarks`` or ``chip_smoke``; and nothing of the port
from the plain reference."""
import ast
from pathlib import Path

import pytest

from perfbench import harness as hx

FILES = sorted(hx.PERFBENCH.rglob("*.py"))
NEVER = {"jax", "jaxlib", "flax", "repro", "benchmarks", "chip_smoke", "kernel_ab"}
NOT_IN_REFERENCE = NEVER | {"repro_torch"}


def top_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(hx.PERFBENCH)))
def test_no_forbidden_import(path):
    forbidden = NOT_IN_REFERENCE if "reference" in path.parts else NEVER
    assert not top_names(path) & forbidden


def test_the_check_compares_whole_names(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import repro_torch.models\nfrom repro_torch import x\n"
                     "import jax.numpy\nfrom repro.models import y\n")
    assert top_names(probe) == {"repro_torch", "jax", "repro"}


def test_forbidden_modules_reads_sys_modules(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "repro_torch_fake", types.ModuleType("repro_torch_fake"))
    assert "repro" not in hx.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", types.ModuleType("jaxlib.fake"))
    assert "jaxlib" in hx.forbidden_modules()
