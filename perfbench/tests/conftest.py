"""CPU tests of the benchmark: ``python -m pytest perfbench/tests`` from the
repository's root.  Tests that need the card carry the ``card`` marker and
skip, deciding inside the test, where there is none."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
