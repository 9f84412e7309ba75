"""The port's LM serving path (``repro_torch.serve.legacy``) against the JAX
package's, and the serve goldens.

With the reference's own weights carried over, the port's ``ServeEngine``
on the CPU must give the reference ``ServeEngine``'s tokens on the
``tests/test_serving.py`` scenarios.

``tests/data/torch_golden_serve.json`` records what the reference serves
for f32 configurations, with weights from
``interop.lm_params_numpy(cfg, seed)``: ``qwen3_0_6b.reduced()`` and
``qwen3_0_6b`` at its full widths cut to 2 layers and a 1,024-token vocab
(head_dim 128, GQA 16/8); the ``reduced()`` configs of the MoE, hybrid,
SSM, encoder-decoder and vision-language architectures; ``rwkv6_1_6b`` at
full width cut to 2 layers; ``qwen2_moe_a2_7b`` at full width cut to 1
layer (60 experts, ~0.57 B parameters, 2.3 GB in f32); ``whisper_small``
at full width cut to 2 decoder and 2 encoder layers over all 1,500 frames
(the encoder's non-causal attention at a ragged S); and
``llama3_2_vision_90b`` at full width cut to one period of 5 layers (4
self-attention, 1 image layer over 1,601 patches; ~4.3 B parameters, 17.2
GB in f32), each with a 1,024-token vocab.  The stub front ends' inputs
(``enc_frames``, ``img_embeds``) come from
``interop.context_inputs_numpy`` with seed ``STUB_SEED + weight seed``.
Two seeded 160-token prompts (S crosses a 128-row block with a ragged
tail) are decoded greedily for 8 tokens; the file keeps the tokens, the
logits of every step and each step's top-2 margin, and for a MoE
configuration the smallest gap between the k-th and (k+1)-th router
probability over every routing of those steps (a gap within float noise
could flip an expert).  The card's machine has no JAX, so
``chip_smoke.py`` holds the port on the card against this file; here the
port on the CPU is, but for the full-width MoE and vision cuts
(``ON_CARD``: too large for the CPU suite), which the card alone serves.
The logits must agree within ``tolerance`` at every step
(teacher-forced), and the greedy tokens must agree up to the first
step whose top-2 margin is within 10 x ``tolerance`` (a near-tie may
flip).

Regenerate the file (about 200 s on an 8-core CPU, most of it the
full-width vision cut, whose writing peaks at ~27 GB of host memory):

    PYTHONPATH=src python tests/test_torch_serve.py --write
"""
from __future__ import annotations

import base64
import dataclasses
import json
import os
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import get_arch as ref_get_arch  # noqa: E402
from repro.models import Model as RefModel  # noqa: E402
from repro.serve.legacy.engine import Request as RefRequest  # noqa: E402
from repro.serve.legacy.engine import ServeEngine as RefServeEngine  # noqa: E402
from repro.serve.legacy.serve_step import make_decode_step as ref_make_decode_step  # noqa: E402
from repro_torch.configs.base import ArchConfig, get_arch  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    context_inputs_numpy,
    lm_params_numpy,
    load_lm_params,
)
from repro_torch.kernels import _platform  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serve.legacy.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.legacy.serve_step import make_decode_step, make_prefill_step  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
GOLDEN_PATH = ROOT / "tests" / "data" / "torch_golden_serve.json"
TOLERANCE = 1e-4  # f32 logits, port against the reference (matmul sum order)
NEAR_TIE = 10 * TOLERANCE
PROMPT_LEN, N_PROMPTS, MAX_NEW = 160, 2, 8


FAMILIES = ["qwen2_moe_a2_7b", "arctic_480b", "jamba_v0_1_52b", "rwkv6_1_6b"]
CONTEXT_FAMILIES = ["whisper_small", "llama3_2_vision_90b"]
# held by chip_smoke.py alone
ON_CARD = ("qwen2_moe_a2_7b.full_width.1_layer", "llama3_2_vision_90b.full_width.5_layers")
STUB_SEED = 2000  # + the weight seed: the stub front ends' inputs


def golden_configs() -> list[tuple[str, ArchConfig, int]]:
    """(name, f32 config, weight seed) of each golden."""
    full = get_arch("qwen3_0_6b")
    out = [("qwen3_0_6b.reduced", full.reduced(), 0),
           ("qwen3_0_6b.full_width.2_layers", dataclasses.replace(
               full, n_layers=2, vocab=1024, dtype="float32"), 1)]
    out += [(f"{arch}.reduced", get_arch(arch).reduced(), 2 + i)
            for i, arch in enumerate(FAMILIES)]
    out += [("rwkv6_1_6b.full_width.2_layers", dataclasses.replace(
                get_arch("rwkv6_1_6b"), n_layers=2, vocab=1024, dtype="float32"), 6),
            (ON_CARD[0], dataclasses.replace(
                get_arch("qwen2_moe_a2_7b"), n_layers=1, vocab=1024, dtype="float32"), 7)]
    out += [(f"{arch}.reduced", get_arch(arch).reduced(), 8 + i)
            for i, arch in enumerate(CONTEXT_FAMILIES)]
    out += [("whisper_small.full_width.2_layers", dataclasses.replace(
                get_arch("whisper_small"), n_layers=2, n_enc_layers=2, vocab=1024,
                dtype="float32"), 10),
            (ON_CARD[1], dataclasses.replace(
                get_arch("llama3_2_vision_90b"), n_layers=5, vocab=1024, dtype="float32"), 11)]
    return out


def stub_inputs(cfg, seed: int) -> dict:
    """The stub front ends' inputs of a golden's prompts (``{}`` for a
    text-only config); the file records their seed (``stub_seed``) and
    shapes."""
    return context_inputs_numpy(cfg, N_PROMPTS, STUB_SEED + seed)


def _prompts(cfg, seed: int) -> np.ndarray:
    rng = np.random.default_rng(1000 + seed)
    return rng.integers(0, cfg.vocab, (N_PROMPTS, PROMPT_LEN)).astype(np.int32)


def _b64(a: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(a, np.float32).tobytes()).decode()


def _unb64(s: str, shape) -> np.ndarray:
    return np.frombuffer(base64.b64decode(s), np.float32).reshape(shape)


def _jax_leaves(node):
    """The tree with each numpy leaf replaced by a JAX array in turn, so
    that the numpy copy of a leaf is freed before the next is converted."""
    for key in (list(node) if isinstance(node, dict) else range(len(node))):
        if isinstance(node[key], (dict, list)):
            _jax_leaves(node[key])
        else:
            node[key] = jnp.asarray(node[key])
    return node


def min_router_gap(model, params, prompts, tokens) -> float:
    """The smallest gap between the k-th and (k+1)-th router probability
    over every routing the reference makes in the golden's steps (prefill,
    then the decode steps teacher-forced on ``tokens``), un-jitted, with
    ``jax.lax.top_k`` recording each routing's probabilities."""
    gaps = []
    top_k = jax.lax.top_k

    def recording(probs, k):
        top = np.sort(np.asarray(probs), axis=-1)[..., -k - 1:]
        gaps.append(float((top[..., 1] - top[..., 0]).min()))
        return top_k(probs, k)

    with mock.patch.object(jax.lax, "top_k", recording):
        cache = model.init_cache(len(prompts), PROMPT_LEN + MAX_NEW)
        _, cache = model.prefill(params, {"tokens": jnp.asarray(prompts)}, cache)
        for step in range(MAX_NEW - 1):
            _, cache = model.decode_step(params, jnp.asarray(tokens[:, step:step + 1]),
                                         cache, jnp.int32(PROMPT_LEN + step))
    return min(gaps)


def write_golden() -> None:
    """Serve each golden configuration with the JAX reference on the CPU."""
    records = []
    for name, cfg, seed in golden_configs():
        ref_cfg = dataclasses.replace(ref_get_arch(cfg.arch), **dataclasses.asdict(cfg))
        model = RefModel(ref_cfg)
        params = _jax_leaves(lm_params_numpy(cfg, seed))
        prompts = _prompts(cfg, seed)
        extras = {k: jnp.asarray(v) for k, v in stub_inputs(cfg, seed).items()}
        max_seq = PROMPT_LEN + MAX_NEW
        # stepwise greedy, keeping the logits each token was chosen from
        cache = model.init_cache(N_PROMPTS, max_seq)
        logits, cache = jax.jit(model.prefill)(
            params, {"tokens": jnp.asarray(prompts), **extras}, cache)
        decode = jax.jit(model.decode_step)
        steps, tokens = [], []
        for step in range(MAX_NEW):
            last = np.asarray(logits[:, -1, : cfg.vocab], np.float32)
            steps.append(last)
            tokens.append(last.argmax(-1).astype(np.int32))
            if step + 1 < MAX_NEW:
                logits, cache = decode(params, jnp.asarray(tokens[-1][:, None]), cache,
                                       jnp.int32(PROMPT_LEN + step))
        tokens = np.stack(tokens, 1)  # (N_PROMPTS, MAX_NEW)
        served = RefServeEngine(model, params, batch=N_PROMPTS, max_seq=max_seq).run(
            [RefRequest(rid=i, prompt=p, max_new=MAX_NEW) for i, p in enumerate(prompts)],
            extras=extras)
        for r in served:
            assert r.out.tolist() == tokens[r.rid].tolist(), "engine != stepwise greedy"
        logits = np.stack(steps, 1)  # (N_PROMPTS, MAX_NEW, vocab)
        top2 = np.sort(logits, axis=-1)[..., -2:]
        record = dict(
            name=name, config=dataclasses.asdict(cfg), weight_seed=seed,
            prompts=prompts.tolist(), max_new=MAX_NEW, tokens=tokens.tolist(),
            margins=(top2[..., 1] - top2[..., 0]).tolist(),
            logits_shape=list(logits.shape), logits_f32_b64=_b64(logits),
            stub_seed=STUB_SEED + seed, stub_inputs={k: list(v.shape) for k, v in extras.items()})
        if cfg.n_experts:
            record["router_min_gap"] = min_router_gap(model, params, prompts, tokens)
        records.append(record)
        print(name, tokens.tolist(), record.get("router_min_gap", ""), flush=True)
        del params, model, cache, extras
    GOLDEN_PATH.parent.mkdir(parents=True, exist_ok=True)
    GOLDEN_PATH.write_text(json.dumps(dict(tolerance=TOLERANCE, near_tie=NEAR_TIE,
                                           configs=records), indent=1) + "\n")


def _golden() -> dict:
    return {g["name"]: g for g in json.loads(GOLDEN_PATH.read_text())["configs"]}


def test_golden_file_covers_the_configurations():
    golden = _golden()
    assert list(golden) == [name for name, _, _ in golden_configs()]
    for name, cfg, seed in golden_configs():
        g = golden[name]
        assert g["config"] == dataclasses.asdict(cfg) and g["weight_seed"] == seed
        assert g["prompts"] == _prompts(cfg, seed).tolist()
        assert g["logits_shape"] == [N_PROMPTS, MAX_NEW, cfg.vocab]
        assert ("router_min_gap" in g) == bool(cfg.n_experts)
        assert g.get("router_min_gap", 1.0) > 0  # no exact tie among the k-th choices
        assert g["stub_seed"] == STUB_SEED + seed
        assert g["stub_inputs"] == {k: list(v.shape) for k, v in stub_inputs(cfg, seed).items()}
    # the card's full-width MoE and vision cuts: the published config but
    # for depth (one period of the vision model's layer program), vocab and
    # dtype
    for name, arch, layers in zip(ON_CARD, ("qwen2_moe_a2_7b", "llama3_2_vision_90b"), (1, 5)):
        published = dataclasses.asdict(get_arch(arch))
        cut = golden[name]["config"]
        assert {k for k in cut if cut[k] != published[k]} == {"n_layers", "vocab", "dtype"}
        assert (cut["n_layers"], cut["vocab"], cut["dtype"]) == (layers, 1024, "float32")
    assert golden[ON_CARD[1]]["stub_inputs"] == {"img_embeds": [N_PROMPTS, 1601, 8192]}
    assert golden["whisper_small.full_width.2_layers"]["stub_inputs"] == \
        {"enc_frames": [N_PROMPTS, 1500, 768]}


@pytest.mark.parametrize("name", [name for name, _, _ in golden_configs()
                                  if name not in ON_CARD])
def test_port_matches_serve_golden(name):
    g = _golden()[name]
    cfg = ArchConfig(**g["config"])
    model = load_lm_params(Model(cfg, device="cpu"), lm_params_numpy(cfg, g["weight_seed"]))
    extras = stub_inputs(cfg, g["weight_seed"])
    prompts = np.asarray(g["prompts"], np.int32)
    tokens = np.asarray(g["tokens"], np.int32)
    want = _unb64(g["logits_f32_b64"], g["logits_shape"])
    n, max_new = tokens.shape
    # teacher-forced: every step's logits
    cache = model.init_cache(n, PROMPT_LEN + max_new)
    logits, cache = model.prefill(
        {"tokens": torch.from_numpy(prompts), **{k: torch.from_numpy(v)
                                                 for k, v in extras.items()}}, cache)
    for step in range(max_new):
        np.testing.assert_allclose(logits[:, -1, : cfg.vocab].numpy(), want[:, step],
                                   rtol=TOLERANCE, atol=TOLERANCE, err_msg=f"step {step}")
        if step + 1 < max_new:
            logits, cache = model.decode_step(torch.from_numpy(tokens[:, step:step + 1]),
                                              cache, PROMPT_LEN + step)
    # greedy through the engine, up to each request's first near-tie
    served = ServeEngine(model, batch=n, max_seq=PROMPT_LEN + max_new).run(
        [Request(rid=i, prompt=p, max_new=max_new) for i, p in enumerate(prompts)], extras)
    margins = np.asarray(g["margins"])
    for r in served:
        ties = np.flatnonzero(margins[r.rid] <= NEAR_TIE)
        upto = int(ties[0]) if len(ties) else max_new  # a near-tie's token may flip
        assert r.out[:upto].tolist() == tokens[r.rid, :upto].tolist()


# ---------------- the tests/test_serving.py scenarios, port vs reference ------


@pytest.fixture(scope="module")
def small_models():
    cfg = ref_get_arch("qwen3_0_6b").reduced()
    ref = RefModel(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    port = load_lm_params(Model(get_arch("qwen3_0_6b").reduced(), device="cpu"),
                          jax.tree.map(np.asarray, params))
    return cfg, ref, params, port


def _serve_both(small_models, prompts, max_new, batch, max_seq):
    _, ref, params, port = small_models
    want = RefServeEngine(ref, params, batch=batch, max_seq=max_seq).run(
        [RefRequest(rid=i, prompt=p, max_new=max_new) for i, p in enumerate(prompts)])
    got = ServeEngine(port, batch=batch, max_seq=max_seq).run(
        [Request(rid=i, prompt=p, max_new=max_new) for i, p in enumerate(prompts)])
    return ({r.rid: r.out.tolist() for r in got}, {r.rid: r.out.tolist() for r in want})


def test_engine_serves_all_requests_as_reference(small_models):
    cfg = small_models[0]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 12).astype(np.int32) for _ in range(7)]
    _platform.reset_launches()
    got, want = _serve_both(small_models, prompts, 6, batch=4, max_seq=48)
    assert sorted(got) == list(range(7))  # 7 requests, waves of 4
    assert all(len(o) == 6 and all(0 <= t < cfg.vocab for t in o) for o in got.values())
    assert got == want
    assert _platform.LAUNCHES["attention"] == 0  # the CPU runs the plain version


def test_engine_matches_stepwise_greedy(small_models):
    """Engine output == manual prefill + greedy decode (through the serve
    steps) for one wave of equal-length prompts, and == the reference."""
    cfg, _, _, port = small_models
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, 10).astype(np.int32) for _ in range(2)]
    got, want = _serve_both(small_models, prompts, 5, batch=2, max_seq=32)
    assert got == want
    prefill, decode = make_prefill_step(port), make_decode_step(port)
    cache = port.init_cache(2, 32)
    logits, cache = prefill({"tokens": torch.from_numpy(np.stack(prompts))}, cache)
    cur = torch.argmax(logits[:, -1, : cfg.vocab], dim=-1).to(torch.int32)[:, None]
    outs = [[], []]
    for step in range(5):
        for i in range(2):
            outs[i].append(int(cur[i, 0]))
        cur, logits, cache = decode(cur, cache, 10 + step)
    assert [got[0], got[1]] == outs


def test_decode_step_matches_reference_serve_step(small_models):
    cfg, ref, params, port = small_models
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    rcache = ref.init_cache(2, 12)
    _, rcache = jax.jit(ref.prefill)(params, {"tokens": jnp.asarray(toks[:, :8])}, rcache)
    rnext, rlogits, _ = jax.jit(ref_make_decode_step(ref))(
        params, jnp.asarray(toks[:, 8:]), rcache, jnp.int32(8))
    pcache = port.init_cache(2, 12)
    _, pcache = port.prefill({"tokens": torch.from_numpy(toks[:, :8])}, pcache)
    pnext, plogits, _ = make_decode_step(port)(torch.from_numpy(toks[:, 8:]), pcache, 8)
    np.testing.assert_array_equal(pnext.numpy(), np.asarray(rnext))
    np.testing.assert_allclose(plogits[..., : cfg.vocab].numpy(),
                               np.asarray(rlogits)[..., : cfg.vocab],
                               rtol=TOLERANCE, atol=TOLERANCE)


def test_engine_deterministic(small_models):
    cfg, _, _, port = small_models
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, 8).astype(np.int32) for _ in range(3)]
    runs = [ServeEngine(port, batch=4, max_seq=32).run(
        [Request(rid=i, prompt=p, max_new=4) for i, p in enumerate(prompts)])
        for _ in range(2)]
    for a, b in zip(*(sorted(r, key=lambda x: x.rid) for r in runs)):
        np.testing.assert_array_equal(a.out, b.out)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("qwen3_0_6b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg, device="cuda")
    assert Model(cfg, device="cpu").device.type == "cpu"


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: PYTHONPATH=src python tests/test_torch_serve.py --write")
    write_golden()
