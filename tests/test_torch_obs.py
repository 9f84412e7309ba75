"""The port's spans and counters (``repro_torch.obs``) on the CPU.

- With no profiler running, ``span`` hands out one shared null context and
  nothing is recorded, under ``OpCounter`` too.
- Under ``torch.profiler`` every span of ``obs.SPANS`` is a host event
  that is not a user annotation, the kind Kineto copies onto the device
  timeline, so none lands among the card's operations.
- Records nest by ``parent``; counters are keyed by the outermost phase.
- Remat's recompute opens one ``model.recompute`` a period, inside
  ``model.backward``, and no counter counts it.
- The MoE's counters equal the routing's own numbers; the engine counts
  every decode step and the ones whose token is served; mamba counts each
  scan's tokens once a phase, not in remat's recompute.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.configs.base import get_arch
from repro_torch.models import Model
from repro_torch.models import moe as moe_mod
from repro_torch.roofline.counter import OpCounter
from repro_torch.serve.legacy.engine import Request, ServeEngine
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step


@pytest.fixture(autouse=True)
def _fresh():
    obs.reset()
    yield
    obs.reset()


def _model(arch: str, **changes) -> Model:
    cfg = dataclasses.replace(get_arch(arch).reduced(), **changes)
    return Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))


def _batch(model: Model, b: int = 2, s: int = 32) -> dict:
    ids = torch.randint(0, model.cfg.vocab, (b, s + 1), generator=torch.Generator().manual_seed(1))
    return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}


def _train_step(model: Model) -> None:
    params = dict(model.named_parameters())
    make_train_step(model)(opt.init(opt.OptimizerConfig(), params), _batch(model))


def _serve(model: Model, max_new: list[int]) -> list:
    engine = ServeEngine(model, batch=len(max_new), max_seq=48)
    prompt = np.arange(16, dtype=np.int32)
    return engine.run([Request(rid=i, prompt=prompt, max_new=n) for i, n in enumerate(max_new)])


def _names(snap: dict) -> list[str]:
    return [r["name"] for r in snap["records"]]


def _ancestors(records: list, i: int) -> list[str]:
    out = []
    while records[i]["parent"] is not None:
        i = records[i]["parent"]
        out.append(records[i]["name"])
    return out


@pytest.fixture(scope="module")
def moe_model():
    return _model("qwen2_moe_a2_7b")


@pytest.fixture(scope="module")
def profiled_events(moe_model):
    """Every host event of one MoE train step with remat and one served
    wave, and one wave of the hybrid family, under a CPU profiler."""
    hybrid = _model("jamba_v0_1_52b")  # the mamba spans
    obs.reset()
    with torch.profiler.profile() as prof:
        _train_step(moe_model)
        _serve(moe_model, [3, 3])
        _serve(hybrid, [2, 2])
    obs.reset()
    return list(prof.events())


@pytest.mark.parametrize("around", ["plain", "op_counter"])
def test_nothing_recorded_without_a_profiler(around, moe_model):
    assert obs.span("train_step") is obs.span("moe.route")
    assert isinstance(obs.span("mlp", device=torch.device("cpu")), contextlib.nullcontext)
    with OpCounter() if around == "op_counter" else contextlib.nullcontext():
        _train_step(moe_model)
        _serve(moe_model, [2, 2])
    assert obs.snapshot() == {"records": [], "counters": {}}


@pytest.mark.parametrize("name", obs.SPANS)
def test_each_span_is_a_host_event_with_no_device_copy(name, profiled_events):
    mine = [e for e in profiled_events if e.name == name]
    assert mine, f"no {name} event"
    assert not any(e.is_user_annotation for e in mine)
    assert all(e.time_range.end >= e.time_range.start for e in mine)


def test_parents_nest_and_counters_take_the_outermost_phase():
    with torch.profiler.profile():
        obs.count("c", 1)
        with obs.span("engine.wave", tag=(7, 2)):
            with obs.span("model.prefill", device=torch.device("cpu")):
                with obs.span("attention"):
                    obs.count("c", 2)
                with obs.span("model.decode_step"):  # nested phase: the outer one keys
                    obs.count("c", torch.tensor(3))
            with obs.span("engine.decode"):
                pass
    snap = obs.snapshot()
    assert [(r["name"], r["parent"]) for r in snap["records"]] == [
        ("engine.wave", None), ("model.prefill", 0), ("attention", 1),
        ("model.decode_step", 1), ("engine.decode", 0)]
    assert snap["records"][0]["tag"] == (7, 2)
    assert all(r["device_s"] is None for r in snap["records"])  # no CUDA events on the CPU
    assert snap["counters"] == {"c": {None: 1, "model.prefill": 5}}
    obs.reset()
    assert obs.snapshot() == {"records": [], "counters": {}}


@pytest.mark.parametrize("remat,policy", [(True, "full"), (True, "dots"), (False, "full")])
def test_one_recompute_a_period_inside_the_backward(remat, policy):
    model = _model("qwen3_0_6b", remat=remat, remat_policy=policy)
    with torch.profiler.profile() as prof:
        _train_step(model)
    records = obs.snapshot()["records"]
    recomputes = [i for i, r in enumerate(records) if r["name"] == "model.recompute"]
    periods = model.cfg.n_layers  # qwen3's program repeats every layer
    assert len(recomputes) == (periods if remat else 0)
    for i in recomputes:
        assert "model.backward" in _ancestors(records, i)
        assert "model.forward" not in _ancestors(records, i)
    events = {e.name: [] for e in prof.events()}
    for e in prof.events():
        events[e.name].append(e.time_range)
    (backward,) = events["model.backward"]
    for t in events.get("model.recompute", []):
        assert backward.start <= t.start and t.end <= backward.end


@pytest.mark.parametrize("phase", obs.PHASES)
def test_moe_counters_equal_the_routing(phase, moe_model):
    p = moe_model.blocks[0].moe
    cfg = moe_model.cfg
    x = torch.randn(2, 24, cfg.d_model, generator=torch.Generator().manual_seed(2))
    factor = 1.25
    with torch.profiler.profile():
        with obs.span(phase):
            moe_mod._routed(p.router, p.wg, p.wi, p.wo, cfg, x, factor)
    t, k, e = 48, cfg.top_k, cfg.n_experts
    group = moe_mod._group_size(t)
    cap = moe_mod._capacity(group, k, e, factor)
    r = moe_mod.route(p.router, x.reshape(t // group, group, -1), k, cap)
    assert obs.snapshot()["counters"] == {
        "moe.pairs": {phase: t * k}, "moe.slots": {phase: e * (t // group) * cap},
        "moe.kept": {phase: int(r.keep.sum())}}


def test_moe_counts_the_forward_once_under_remat(moe_model):
    assert moe_model.cfg.remat
    with torch.profiler.profile():
        _train_step(moe_model)
    counters = obs.snapshot()["counters"]
    cfg = moe_model.cfg
    n_moe = sum(1 for b in moe_model.blocks if b.spec.ffn == "moe")
    assert counters["moe.pairs"] == {"train_step": n_moe * 2 * 32 * cfg.top_k}
    assert 0 < counters["moe.kept"]["train_step"] <= counters["moe.pairs"]["train_step"]


@pytest.mark.parametrize("max_new,steps,used", [([1, 1], 1, 0), ([3, 3], 3, 2), ([2, 5], 5, 4)])
def test_engine_counts_decode_steps_and_the_used_ones(max_new, steps, used):
    model = _model("qwen3_0_6b")
    with torch.profiler.profile():
        served = _serve(model, max_new)
    snap = obs.snapshot()
    assert [len(r.out) for r in served] == max_new
    assert snap["counters"] == {"engine.decode_steps": {None: steps},
                                "engine.decode_steps_used": {None: used}}
    names = _names(snap)
    assert names.count("engine.decode") == names.count("model.decode_step") == steps
    assert names.count("engine.sample") == steps + 1  # the prefill's token too
    wave = names.index("engine.wave")
    assert snap["records"][wave]["tag"] == (0, len(max_new))
    assert wave == 0
    assert all("engine.wave" in _ancestors(snap["records"], i) for i in range(1, len(names)))


def test_mamba_counts_each_scan_once_a_phase():
    model = _model("jamba_v0_1_52b")
    n_mamba = sum(1 for b in model.blocks if b.spec.mixer == "mamba")
    with torch.profiler.profile():
        _train_step(model)  # remat: the recompute scans again, uncounted
        _serve(model, [2, 2])  # a prompt of 16, then decode: no scan
    snap = obs.snapshot()
    assert snap["counters"]["mamba.scan_calls"] == {"train_step": n_mamba,
                                                    "model.prefill": n_mamba}
    assert snap["counters"]["mamba.scan_tokens"] == {"train_step": n_mamba * 2 * 32,
                                                     "model.prefill": n_mamba * 2 * 16}
    records = snap["records"]
    scans = [i for i, r in enumerate(records) if r["name"] == "mamba.scan"]
    assert scans and all(records[records[i]["parent"]]["name"] == "mamba" for i in scans)
    decodes = [i for i, r in enumerate(records) if r["name"] == "mamba.decode"]
    assert len(decodes) == n_mamba * 2
    assert all("model.decode_step" in _ancestors(records, i) for i in decodes)
