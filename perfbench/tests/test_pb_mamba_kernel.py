"""The reader of ``serve.mamba_kernel_pct`` on made-up snapshots: the
share of prefill's Mamba scans that ran the selective-scan kernel, and
None where there is nothing to read (a program that does not count the
kernel's scans, a training record, a program without ``obs.py``)."""
import sys

import pytest

from perfbench import harness as hx

SERVE = {"kind": "serve"}


@pytest.fixture
def snap(monkeypatch):
    from repro_torch import obs

    def use(counters):
        monkeypatch.setattr(obs, "snapshot", lambda: {"records": [], "counters": counters})
    return use


def read(rec):
    return hx.reader("serve.mamba_kernel_pct").read(rec, None)


@pytest.mark.parametrize("kernel,want", [
    ({"model.prefill": 7}, 100.0),  # every scan of the wave's prefill
    ({"model.prefill": 0}, 0.0),  # the plain version's route counts 0
    ({"model.prefill": 3, "model.decode_step": 9}, 3 / 7 * 100),  # prefill's alone
    (None, None),  # a program without the kernel counts nothing
])
def test_kernel_share(kernel, want, snap):
    counters = {"mamba.scan_calls": {"model.prefill": 7}}
    if kernel is not None:
        counters["mamba.scan_kernel"] = kernel
    snap(counters)
    got = read(SERVE)
    assert got == (None if want is None else pytest.approx(want))


def test_nothing_to_read_is_none(snap, monkeypatch):
    snap({"mamba.scan_calls": {"model.prefill": 7}, "mamba.scan_kernel": {"model.prefill": 7}})
    assert read({"kind": "train"}) is None
    snap({"mamba.scan_kernel": {"model.prefill": 0}})  # no scan ran
    assert read(SERVE) is None
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)  # a program without obs.py
    assert read(SERVE) is None
