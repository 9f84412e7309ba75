"""A plain float32 Jamba, for the CPU tests of the port's hybrid family.

Plain ``torch`` operations only: nothing of JAX, nothing of ``repro_torch``.
It reads the weights by name (``embed.tok``, ``embed.head``,
``blocks.<i>.mixer.in_proj``, ``blocks.<i>.attn.wq``,
``blocks.<i>.moe.router``, ``final_norm.scale``, ...) and the
configuration as an ``arch`` dict with the port's field names.  Run it with
TF32 off on a card, so that every product is float32.

The layers, as AI21's published Jamba models lay them out (transformers'
``JambaForCausalLM``; https://huggingface.co/ai21labs/AI21-Jamba2-Mini):

- layer ``i`` attends where ``i % attn_period == attn_period // 2``
  (``attn_layer_offset`` 4 of ``attn_layer_period`` 8), else it is a
  Mamba-1 mixer; its ffn is the routed experts where ``i % moe_every ==
  moe_every - 1`` (``expert_layer_offset`` 1 of 2), else a dense SwiGLU;
  each sublayer is pre-normed (RMS, eps 1e-6) and added to the residual;
- Mamba-1: ``x, z = h in_proj``; ``x = silu(causal depthwise conv(x) +
  conv_b)`` over the last ``d_conv`` tokens; ``dt, B, C = x x_proj``, each
  RMS-normed where ``ssm_dt_bc_norm`` (the published ``dt_layernorm``,
  ``b_layernorm``, ``c_layernorm``); ``dt = softplus(dt dt_proj +
  dt_bias)``; the state, from zero, ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t
  B_t`` with ``A = -exp(A_log)``, run here a token at a time; ``y_t = h_t
  C_t + D x_t``; ``out = (y silu(z)) out_proj``;
- attention: grouped-query, causal, rotary positions only where
  ``attn_rope`` (Jamba has none);
- experts: an f32 softmax router, each token's top-k experts, gates the
  top-k probabilities, renormalised to sum to one only where
  ``norm_topk_prob``; each expert a SwiGLU.

Departures from the published model, each as the port runs it: the experts
take tokens in routing groups (``serve_groups``: the prompts' tokens in
consecutive groups of at most ``GROUP_TARGET``, each later position's
tokens of every sequence as one group) and each expert at most
``capacity`` of a group's (token, slot) pairs, slot-major, at the
configured factor (at least ``DECODE_MIN_FACTOR`` for the positions after
the prompts); the published router drops nothing.  The load-balance and
z-losses are not computed.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

GROUP_TARGET = 512  # tokens a routing group, at most
DECODE_MIN_FACTOR = 2.0  # the capacity factor after the prompts, at least
EPS = 1e-6


def rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + EPS) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, hd) rotated by position, the two halves."""
    s, _, hd = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    ang = torch.arange(s, device=x.device).float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def group_size(t: int) -> int:
    g = min(t, GROUP_TARGET)
    while t % g:
        g -= 1
    return g


def capacity(group: int, k: int, e: int, factor: float) -> int:
    c = int(group * k * factor / e) + 1
    return max(4, -(-c // 4) * 4) if group >= 4 else max(1, c)


def serve_groups(b: int, p: int, n: int, factor: float, device=None) -> list:
    """Routing groups of a pass over ``b`` sequences of ``p`` prompt tokens
    and ``n - 1`` served ones: [(flat token indexes (G, g), factor)]."""
    length = p + n - 1
    prompt = (torch.arange(b, device=device)[:, None] * length
              + torch.arange(p, device=device)[None, :]).reshape(-1)
    g = group_size(prompt.numel())
    parts = [(prompt.reshape(-1, g), factor)]
    for j in range(n - 1):
        parts.append(((torch.arange(b, device=device) * length + p + j)[None, :],
                      max(factor, DECODE_MIN_FACTOR)))
    return parts


class PlainJamba:
    """The model over ``weights`` ({name: tensor}, read in float32)."""

    def __init__(self, arch: dict, weights: dict):
        self.a = arch
        self.w = weights

    def p(self, name: str) -> torch.Tensor:
        return self.w[name].float()

    def head_dim(self) -> int:
        return self.a.get("d_head") or self.a["d_model"] // self.a["n_heads"]

    def is_attention(self, i: int) -> bool:
        return i % self.a["attn_period"] == self.a["attn_period"] // 2

    def is_moe(self, i: int) -> bool:
        every = self.a.get("moe_every", 1)
        return bool(self.a.get("n_experts")) and i % every == every - 1

    # ---- mixers ----

    def mamba(self, i: int, h: torch.Tensor) -> torch.Tensor:
        """h (B, S, D) -> the Mamba-1 mixer's output (B, S, D)."""
        a, pre = self.a, f"blocks.{i}.mixer."
        b, s, d = h.shape
        d_in = a.get("ssm_expand", 2) * d
        dt_rank = math.ceil(d / 16)
        ds = a.get("ssm_d_state", 16)
        xz = h @ self.p(pre + "in_proj")
        x, z = xz[..., :d_in], xz[..., d_in:]
        conv_w = self.p(pre + "conv_w")  # (K, d_in): tap k reads token t - K + 1 + k
        taps = conv_w.shape[0]
        xp = F.pad(x, (0, 0, taps - 1, 0))
        x = F.silu(sum(xp[:, k:k + s] * conv_w[k] for k in range(taps)) + self.p(pre + "conv_b"))
        proj = x @ self.p(pre + "x_proj")
        dt, bm, cm = torch.split(proj, [dt_rank, ds, ds], dim=-1)
        if a.get("ssm_dt_bc_norm"):
            dt = rmsnorm(dt, self.p(pre + "dt_norm.scale"))
            bm = rmsnorm(bm, self.p(pre + "b_norm.scale"))
            cm = rmsnorm(cm, self.p(pre + "c_norm.scale"))
        dt = F.softplus(dt @ self.p(pre + "dt_proj") + self.p(pre + "dt_bias"))
        A = -torch.exp(self.p(pre + "A_log"))  # (d_in, ds)
        state = h.new_zeros(b, d_in, ds)
        ys = []
        for t in range(s):
            state = torch.exp(dt[:, t, :, None] * A) * state \
                + (dt[:, t] * x[:, t])[:, :, None] * bm[:, t, None, :]
            ys.append((state * cm[:, t, None, :]).sum(-1))
        y = torch.stack(ys, dim=1) + x * self.p(pre + "D")
        return (y * F.silu(z)) @ self.p(pre + "out_proj")

    def attention(self, i: int, h: torch.Tensor) -> torch.Tensor:
        a, pre = self.a, f"blocks.{i}.attn."
        b, s, _ = h.shape
        hd, nq, nkv = self.head_dim(), a["n_heads"], a["n_kv_heads"]
        q = (h @ self.p(pre + "wq")).reshape(b, s, nq, hd)
        k = (h @ self.p(pre + "wk")).reshape(b, s, nkv, hd)
        v = (h @ self.p(pre + "wv")).reshape(b, s, nkv, hd)
        if a.get("attn_rope", True):
            theta = float(a.get("rope_theta", 10_000.0))
            q = torch.stack([rope(q[r], theta) for r in range(b)])
            k = torch.stack([rope(k[r], theta) for r in range(b)])
        k = k.repeat_interleave(nq // nkv, dim=2)
        v = v.repeat_interleave(nq // nkv, dim=2)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        future = torch.ones(s, s, dtype=torch.bool, device=h.device).triu(1)
        probs = torch.softmax(scores.masked_fill(future, float("-inf")), dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, nq * hd)
        return out @ self.p(pre + "wo")

    # ---- ffns ----

    def mlp(self, pre: str, x: torch.Tensor) -> torch.Tensor:
        return (F.silu(x @ self.p(pre + "wg")) * (x @ self.p(pre + "wi"))) @ self.p(pre + "wo")

    def moe(self, i: int, h: torch.Tensor, groups: list) -> torch.Tensor:
        a, pre = self.a, f"blocks.{i}.moe."
        b, s, d = h.shape
        e, k = a["n_experts"], a["top_k"]
        flat = h.reshape(b * s, d)
        out = torch.zeros_like(flat)
        for idx, factor in groups:
            n_g, g = idx.shape
            cap = capacity(g, k, e, factor)
            probs = torch.softmax(flat[idx] @ self.p(pre + "router"), dim=-1)  # (G, g, E)
            gate, choice = torch.topk(probs, k, dim=-1)
            if a.get("norm_topk_prob", True):
                gate = gate / gate.sum(-1, keepdim=True)
            for grp in range(n_g):
                filled = [0] * e
                for slot in range(k):  # every token's first choice before any second
                    for tok in range(g):
                        ex = int(choice[grp, tok, slot])
                        filled[ex] += 1
                        if filled[ex] > cap:
                            continue  # over capacity: dropped
                        row = idx[grp, tok]
                        y = self.mlp_expert(pre, ex, flat[row])
                        out[row] += gate[grp, tok, slot] * y
        if a.get("n_shared_experts"):
            out = out + self.mlp(pre + "shared.", flat)
        return out.reshape(b, s, d)

    def mlp_expert(self, pre: str, ex: int, x: torch.Tensor) -> torch.Tensor:
        wg, wi, wo = (self.w[pre + n][ex].float() for n in ("wg", "wi", "wo"))
        return (F.silu(x @ wg) * (x @ wi)) @ wo

    # ---- the model ----

    def forward(self, tokens: torch.Tensor, groups: list) -> torch.Tensor:
        """Logits (B, S, vocab) of ``tokens`` (B, S), the experts routing
        in ``groups``."""
        x = self.p("embed.tok")[tokens.long()]
        for i in range(self.a["n_layers"]):
            pre = f"blocks.{i}."
            h = rmsnorm(x, self.p(pre + "norm1.scale"))
            x = x + (self.attention(i, h) if self.is_attention(i) else self.mamba(i, h))
            h = rmsnorm(x, self.p(pre + "norm2.scale"))
            x = x + (self.moe(i, h, groups) if self.is_moe(i) else self.mlp(pre + "mlp.", h))
        x = rmsnorm(x, self.p("final_norm.scale"))
        v = self.a["vocab"]
        if self.a.get("tie_embeddings"):
            return x @ self.p("embed.tok")[:v].t()
        return x @ self.p("embed.head")[:, :v]


def contiguous_groups(t: int, factor: float, device=None) -> list:
    """One pass's routing groups: ``t`` tokens in consecutive groups."""
    g = group_size(t)
    return [(torch.arange(t, device=device).reshape(t // g, g), factor)]
