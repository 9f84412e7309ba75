"""``tab8`` (the per-optimization ablations) through the port's and the
reference's bench harness: the check of ``test_torch_benches.py``, in a
file of its own so that ``--dist loadfile`` runs it beside the others."""
from __future__ import annotations

import pytest

pytest.importorskip("jax")

from test_torch_benches import check_bench  # noqa: E402


def test_tab8_writes_the_reference_s_rows_and_validation(tmp_path, monkeypatch):
    check_bench("tab8", tmp_path, monkeypatch)
