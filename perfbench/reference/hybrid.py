"""A plain float32 Jamba (Mamba-1 and attention layers, dense SwiGLU and
routed experts), for the check of the hybrid serving cell: the benchmark's
frozen copy of the repository's ``tests/plain_jamba.py``, computed in
blocks so that it fits on one card at the cell's size.

Plain PyTorch, independent of the program: it reads the weights by name
(``blocks.<i>.mixer.in_proj``, ``blocks.<i>.mixer.dt_norm.scale``,
``blocks.<i>.attn.wq``, ``blocks.<i>.moe.router``, ...), the same tensors
the benchmark made for the program.  TF32 is off (``run.py`` sets it), so
every product is float32; ``precision="fp8"`` is ``model.py``'s control.

The layers as AI21's published Jamba models have them (transformers'
``JambaForCausalLM``): layer ``i`` attends where ``i % attn_period ==
attn_period // 2``, else it is a Mamba-1 mixer; its ffn is the routed
experts where ``i % moe_every == moe_every - 1``, else a dense SwiGLU.
Mamba-1: ``x, z = h in_proj``; ``x = silu(causal depthwise conv(x) +
conv_b)``; ``dt, B, C = x x_proj``, each RMS-normed where
``ssm_dt_bc_norm``; ``dt = softplus(dt dt_proj + dt_bias)``; from a zero
state ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t``, ``A = -exp(A_log)``,
run a token at a time; ``y_t = h_t C_t + D x_t``; ``out = (y silu(z))
out_proj``.  Attention is causal, grouped-query, with rotary positions
only where ``attn_rope`` (Jamba has none).  The router's gates are the
top-k softmax probabilities, renormalised only where ``norm_topk_prob``.

Departures from the published model, as the port runs it (listed under
``assumed`` in the configuration file): the experts route in groups with a
capacity and drop what overflows (``serve.serve_groups``: the prompts'
tokens in groups of 512 at the configured factor, each later position's
tokens as one group at 2.0), where the published router drops nothing; no
auxiliary loss is computed.  Departures in form only, to fit the card: the
projections and the dense SwiGLU run a sequence at a time, and the
recurrence's per-token decays and inputs are made ``SCAN_BLOCK`` tokens at
a time.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .model import RefLM, capacity, causal_attention, rmsnorm, rope
from .serve import serve_groups, token_gaps  # noqa: F401 (the check reads both here)

SCAN_BLOCK = 256  # tokens whose decays and inputs are made at once


def recurrence(dt, bm, cm, x, A, keep_at: int | None = None):
    """y_t = h_t C_t, h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t from h_0 = 0,
    a token at a time: dt, x (B, S, d_in), bm, cm (B, S, ds), A (d_in, ds).
    Returns (y (B, S, d_in), h after token ``keep_at`` (B, d_in, ds) or
    None)."""
    b, s, d_in = x.shape
    state = x.new_zeros(b, d_in, A.shape[1])
    y = torch.empty_like(x)
    kept = None
    for lo in range(0, s, SCAN_BLOCK):
        hi = min(s, lo + SCAN_BLOCK)
        dtb = dt[:, lo:hi].transpose(0, 1)  # (L, B, d_in), token-major
        decay = torch.exp(dtb[..., None] * A)
        inp = (dtb * x[:, lo:hi].transpose(0, 1))[..., None] * bm[:, lo:hi].transpose(0, 1)[:, :, None, :]
        states = torch.empty_like(decay)
        for t in range(hi - lo):
            state = torch.addcmul(inp[t], decay[t], state, out=states[t])
        y[:, lo:hi] = torch.einsum("tbis,bts->bti", states, cm[:, lo:hi])
        if keep_at is not None and lo <= keep_at < hi:
            kept = states[keep_at - lo].clone()
        del decay, inp, states
    return y, kept


class RefJamba(RefLM):
    """``RefLM`` with Jamba's mixers, ffn layout and router.  With
    ``state_at`` a position, each Mamba layer appends its state after that
    position to ``states``."""

    state_at: int | None = None
    states: list | None = None

    def is_attention(self, i: int) -> bool:
        return i % self.a["attn_period"] == self.a["attn_period"] // 2

    def attention(self, i: int, h: torch.Tensor) -> torch.Tensor:
        a, pre = self.a, f"blocks.{i}.attn."
        b, s, _ = h.shape
        outs = []
        for r in range(b):
            q, k, v = (self.mm(h[r], self.p(pre + n)) for n in ("wq", "wk", "wv"))
            q = q.reshape(s, a["n_heads"], self.hd)
            k = k.reshape(s, a["n_kv_heads"], self.hd)
            v = v.reshape(s, a["n_kv_heads"], self.hd)
            if a.get("attn_rope", True):
                pos = torch.arange(s, device=h.device)
                theta = float(a.get("rope_theta", 10_000.0))
                q, k = rope(q, pos, theta), rope(k, pos, theta)
            outs.append(self.mm(causal_attention(q, k, v, self.precision), self.p(pre + "wo")))
        return torch.stack(outs)

    def mamba(self, i: int, h: torch.Tensor) -> torch.Tensor:
        a, pre = self.a, f"blocks.{i}.mixer."
        b, s, d = h.shape
        d_in = a.get("ssm_expand", 2) * d
        dt_rank = math.ceil(d / 16)
        ds = a.get("ssm_d_state", 16)
        conv_w = self.p(pre + "conv_w")  # (K, d_in): tap k reads token t - K + 1 + k
        taps = conv_w.shape[0]
        xs, zs, dts, bms, cms = [], [], [], [], []
        for r in range(b):  # a sequence at a time
            xz = self.mm(h[r], self.p(pre + "in_proj"))
            x, z = xz[:, :d_in], xz[:, d_in:]
            xp = F.pad(x, (0, 0, taps - 1, 0))
            conv = self.p(pre + "conv_b").expand(s, d_in).clone()
            for k in range(taps):
                conv.addcmul_(xp[k:k + s], conv_w[k])
            x = F.silu(conv)
            del xz, xp, conv
            dt, bm, cm = torch.split(self.mm(x, self.p(pre + "x_proj")), [dt_rank, ds, ds], dim=-1)
            if a.get("ssm_dt_bc_norm"):
                dt = rmsnorm(dt, self.p(pre + "dt_norm.scale"), self.eps)
                bm = rmsnorm(bm, self.p(pre + "b_norm.scale"), self.eps)
                cm = rmsnorm(cm, self.p(pre + "c_norm.scale"), self.eps)
            dts.append(F.softplus(self.mm(dt, self.p(pre + "dt_proj")) + self.p(pre + "dt_bias")))
            xs.append(x)
            zs.append(z.clone())
            bms.append(bm)
            cms.append(cm)
        x = torch.stack(xs)
        del xs
        y, kept = recurrence(torch.stack(dts), torch.stack(bms), torch.stack(cms), x,
                             -torch.exp(self.p(pre + "A_log")), self.state_at)
        if self.states is not None:
            self.states.append(kept)
        del dts
        y = y + x * self.p(pre + "D")
        del x
        return torch.stack([self.mm(y[r] * F.silu(zs[r]), self.p(pre + "out_proj"))
                            for r in range(b)])

    def moe(self, i: int, h: torch.Tensor, groups):
        """h (B, S, D) -> the routed experts' output (B, S, D), the pairs
        counted in ``self.pairs``."""
        a, pre = self.a, f"blocks.{i}.moe."
        b, s, d = h.shape
        e, k = a["n_experts"], a["top_k"]
        flat = h.reshape(b * s, d)
        router = self.p(pre + "router")
        wg, wi, wo = (self.w[pre + n] for n in ("wg", "wi", "wo"))
        out = torch.zeros_like(flat)
        for idx, factor in groups.parts:
            n_g, g = idx.shape
            cap = capacity(g, k, e, factor)
            probs = torch.softmax(self.mm(flat[idx], router), dim=-1)
            gate, choice = torch.topk(probs, k, dim=-1)  # (G, g, k)
            if a.get("norm_topk_prob", True):
                gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
            # queue place: pairs of earlier slots, then earlier tokens of this slot
            order = choice.transpose(1, 2).reshape(n_g, k * g)
            onehot = F.one_hot(order, e)
            place = (torch.cumsum(onehot, dim=1) - onehot).gather(-1, order[..., None])[..., 0]
            keep = place.reshape(n_g, k, g).transpose(1, 2) < cap
            del onehot, place
            count = self.pairs.setdefault(factor, [0, 0])
            count[0] += keep.numel()
            count[1] += int((~keep).sum())
            tok = idx[:, :, None].expand(n_g, g, k)
            for ex in range(e):
                sel = (choice == ex) & keep
                if not bool(sel.any()):
                    continue
                rows = tok[sel]
                xe = flat[rows]
                y = self.mm(F.silu(self.mm(xe, wg[ex].float())) * self.mm(xe, wi[ex].float()),
                            wo[ex].float())
                out.index_add_(0, rows, y * gate[sel][:, None])
        if a.get("n_shared_experts"):
            out = out + self.mlp(pre + "shared.", flat)
        return out.reshape(b, s, d)

    def block(self, i: int, x: torch.Tensor, groups) -> torch.Tensor:
        pre = f"blocks.{i}."
        h = rmsnorm(x, self.p(pre + "norm1.scale"), self.eps)
        x = x + (self.attention(i, h) if self.is_attention(i) else self.mamba(i, h))
        h = rmsnorm(x, self.p(pre + "norm2.scale"), self.eps)
        if self.is_moe(i):
            return x + self.moe(i, h, groups)
        return x + torch.stack([self.mlp(pre + "mlp.", h[r]) for r in range(h.shape[0])])


@torch.no_grad()
def served_logits(arch: dict, weights: dict, prompts: torch.Tensor, served: torch.Tensor,
                  precision: str = "f32", pairs: dict | None = None,
                  states: list | None = None) -> torch.Tensor:
    """Logits (B, n, vocab) in float32 of the positions that chose each of
    the ``served`` (B, n) tokens after ``prompts`` (B, P): one causal pass
    over the prompts and the first ``n - 1`` served tokens.  ``pairs``
    ({capacity factor: [routed, dropped]}) gathers the experts' pair
    counts; ``states`` each Mamba layer's state at the prompts' end, (B,
    d_in, ds) in layer order, what prefill leaves in a serving cache."""
    b, p = prompts.shape
    n = served.shape[1]
    lm = RefJamba(arch, weights, precision)
    if pairs is not None:
        lm.pairs = pairs
    if states is not None:
        lm.state_at, lm.states = p - 1, states
    tokens = torch.cat([prompts, served[:, :-1]], dim=1).long()
    groups = serve_groups(b, p, n, arch.get("moe_capacity_factor", 1.25), tokens.device)
    x = lm.embed(tokens)
    for i in range(arch["n_layers"]):
        x = lm.block(i, x, groups)
    return lm.logits(x[:, p - 1:])
