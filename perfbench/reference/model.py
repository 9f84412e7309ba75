"""A plain float32 decoder LM: the dense and MoE families as configured,
for the check of what the port's timed path produces.

Plain PyTorch, independent of the program: it reads the weights by name
(``embed.tok``, ``blocks.<i>.attn.wq``, ``blocks.<i>.moe.router``, ...), the
same tensors the benchmark made for the program, and works out
normalisation, rotary positions, grouped-query attention, the MLP, the
MoE's routing, capacity and combine, and the loss itself.  TF32 is off
(``run.py`` sets it before any product runs), so every product is float32.

``precision="fp8"`` is the control: every product's operands (and, in the
backward pass, the gradient entering it) rounded to float8 e4m3 with a
per-tensor scale, the rest float32.

The MoE follows the port's documented routing, which departs from the
published model (listed under ``assumed`` in the configuration file):
tokens in groups (``Groups``), top-k of an f32 router softmax, the k
gates renormalised, slot-major queue places, at most ``capacity`` pairs an
expert, the rest dropped; one ungated shared MLP; the Switch load-balance
and router z-losses averaged over the MoE layers.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

GROUP_TARGET = 512  # tokens a routing group, at most


# ---------------------------------------------------------------------------
# products, in float32 or in the control's float8
# ---------------------------------------------------------------------------


FP8_MAX = 448.0  # float8 e4m3's largest


def _q8(t: torch.Tensor) -> torch.Tensor:
    scale = FP8_MAX / t.detach().abs().amax().clamp(min=1e-30)
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


class _QIn(torch.autograd.Function):
    """Forward: the operand rounded to float8; backward: the gradient as
    it is (the product's own backward rounds what enters it)."""

    @staticmethod
    def forward(ctx, t):
        return _q8(t)

    @staticmethod
    def backward(ctx, g):
        return g


class _QOut(torch.autograd.Function):
    """Forward: unchanged; backward: the incoming gradient rounded to
    float8 before the product's backward uses it."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _q8(g)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "f32":
        return a @ b
    if precision != "fp8":
        raise ValueError(precision)
    return _QOut.apply(_QIn.apply(a) @ _QIn.apply(b))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., S, H, hd); rotation of the two halves by position x
    theta^(-2i/hd)."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    ang = positions.float()[:, None] * inv  # (S, hd/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, precision: str, q_block: int = 1024) -> torch.Tensor:
    """q (S, nq, hd), k/v (S, nkv, hd) of one sequence; each query attends
    to the keys at or before its position.  Queries go a block at a time,
    against the keys up to the block's last."""
    s, nq, hd = q.shape
    nkv = k.shape[1]
    g = nq // nkv
    kt = k.permute(1, 2, 0)  # (nkv, hd, S)
    vt = v.permute(1, 0, 2)  # (nkv, S, hd)
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for i in range(0, s, q_block):
        j = min(i + q_block, s)
        qb = q[i:j].reshape(j - i, nkv, g, hd).permute(1, 2, 0, 3).reshape(nkv, g * (j - i), hd)
        sc = matmul(qb, kt[:, :, :j], precision).reshape(nkv, g, j - i, j) * scale
        qpos = torch.arange(i, j, device=q.device)[:, None]
        kpos = torch.arange(j, device=q.device)[None, :]
        sc = sc.masked_fill(kpos > qpos, float("-inf"))
        p = torch.softmax(sc, dim=-1).reshape(nkv, g * (j - i), j)
        o = matmul(p, vt[:, :j], precision).reshape(nkv, g, j - i, hd)
        outs.append(o.permute(2, 0, 1, 3).reshape(j - i, nq * hd))
    return torch.cat(outs, dim=0)


@dataclasses.dataclass
class Groups:
    """How a MoE layer groups the flattened tokens: each entry an index
    tensor (G, g) into the flat tokens and its capacity factor."""

    parts: list


def group_size(t: int, target: int = GROUP_TARGET) -> int:
    g = min(t, target)
    while t % g:
        g -= 1
    return g


def capacity(group: int, k: int, e: int, factor: float) -> int:
    c = int(group * k * factor / e) + 1
    return max(4, -(-c // 4) * 4) if group >= 4 else max(1, c)


def contiguous_groups(t: int, factor: float, device) -> Groups:
    g = group_size(t)
    return Groups([(torch.arange(t, device=device).reshape(t // g, g), factor)])


def drop_share(pairs: dict) -> dict:
    """The share of routed (token, expert) pairs over capacity, by the
    groups' capacity factor, from ``RefLM.pairs``."""
    return {str(f): dropped / routed for f, (routed, dropped) in pairs.items() if routed}


class RefLM:
    """The plain model over ``weights`` ({name: tensor}, any float dtype;
    read in float32 at each use)."""

    def __init__(self, arch: dict, weights: dict, precision: str = "f32", eps: float = 1e-6):
        self.a = arch
        self.w = weights
        self.precision = precision
        self.eps = eps
        self.hd = arch.get("d_head") or arch["d_model"] // arch["n_heads"]
        self.pairs: dict = {}  # capacity factor -> [routed pairs, dropped pairs]

    def p(self, name: str) -> torch.Tensor:
        return self.w[name].float()

    def mm(self, x, w):
        return matmul(x, w, self.precision)

    # ---- pieces ----

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.p("embed.tok")[tokens.long()]

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Logits over the configured vocabulary (the table's padding rows
        are not the model's)."""
        v = self.a["vocab"]
        x = rmsnorm(x, self.p("final_norm.scale"), self.eps)
        if self.a.get("tie_embeddings"):
            return self.mm(x, self.p("embed.tok")[:v].t())
        return self.mm(x, self.p("embed.head")[:, :v])

    def attention(self, i: int, h: torch.Tensor) -> torch.Tensor:
        """h (B, S, D) -> the layer's attention output (B, S, D)."""
        a, pre = self.a, f"blocks.{i}.attn."
        b, s, _ = h.shape
        q, k, v = (self.mm(h, self.p(pre + n)) for n in ("wq", "wk", "wv"))
        if a.get("qkv_bias"):
            q, k, v = q + self.p(pre + "bq"), k + self.p(pre + "bk"), v + self.p(pre + "bv")
        q = q.reshape(b, s, a["n_heads"], self.hd)
        k = k.reshape(b, s, a["n_kv_heads"], self.hd)
        v = v.reshape(b, s, a["n_kv_heads"], self.hd)
        if a.get("qk_norm"):
            q = rmsnorm(q, self.p(pre + "q_norm.scale"), self.eps)
            k = rmsnorm(k, self.p(pre + "k_norm.scale"), self.eps)
        pos = torch.arange(s, device=h.device)
        theta = float(a.get("rope_theta", 10_000.0))
        q, k = rope(q, pos, theta), rope(k, pos, theta)
        out = torch.stack([causal_attention(q[r], k[r], v[r], self.precision) for r in range(b)])
        return self.mm(out, self.p(pre + "wo"))

    def mlp(self, pre: str, x: torch.Tensor) -> torch.Tensor:
        g = self.mm(x, self.p(pre + "wg"))
        u = self.mm(x, self.p(pre + "wi"))
        return self.mm(F.silu(g) * u, self.p(pre + "wo"))

    def moe(self, i: int, h: torch.Tensor, groups: Groups):
        """h (B, S, D) -> (out (B, S, D), load-balance loss, z-loss)."""
        a, pre = self.a, f"blocks.{i}.moe."
        b, s, d = h.shape
        e, k = a["n_experts"], a["top_k"]
        flat = h.reshape(b * s, d)
        router = self.p(pre + "router")
        wg, wi, wo = (self.w[pre + n] for n in ("wg", "wi", "wo"))
        out = torch.zeros_like(flat)
        lb_parts, z_parts, n_groups = [], [], 0
        for idx, factor in groups.parts:
            n_g, g = idx.shape
            cap = capacity(g, k, e, factor)
            xg = flat[idx]  # (G, g, D)
            logits = self.mm(xg, router)
            probs = torch.softmax(logits, dim=-1)
            gate, choice = torch.topk(probs, k, dim=-1)  # (G, g, k)
            gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
            # queue place: pairs of earlier slots, then earlier tokens of this slot
            order = choice.transpose(1, 2).reshape(n_g, k * g)
            onehot = F.one_hot(order, e)
            place = (torch.cumsum(onehot, dim=1) - onehot).gather(-1, order[..., None])[..., 0]
            place = place.reshape(n_g, k, g).transpose(1, 2)
            keep = place < cap
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
                out = out.index_add(0, rows, y * gate[sel][:, None])
            frac_tokens = F.one_hot(choice, e).sum(2).float().mean(1)  # (G, E)
            lb_parts.append(e * (frac_tokens * probs.mean(1)).sum(-1))
            z_parts.append(torch.logsumexp(logits, dim=-1).square().mean(1))
            n_groups += n_g
        if a.get("n_shared_experts"):
            out = out + self.mlp(pre + "shared.", flat)
        lb = torch.cat(lb_parts).mean()
        z = torch.cat(z_parts).mean()
        return out.reshape(b, s, d), lb, z

    def is_moe(self, i: int) -> bool:
        every = self.a.get("moe_every", 1)
        return bool(self.a.get("n_experts")) and i % every == every - 1

    def block(self, i: int, x: torch.Tensor, groups: Groups | None):
        """One layer; returns (x, lb, z) (zeros for a dense layer)."""
        pre = f"blocks.{i}."
        x = x + self.attention(i, rmsnorm(x, self.p(pre + "norm1.scale"), self.eps))
        h = rmsnorm(x, self.p(pre + "norm2.scale"), self.eps)
        zero = x.new_zeros(())
        if self.is_moe(i):
            out, lb, z = self.moe(i, h, groups)
            return x + out, lb, z
        return x + self.mlp(pre + "mlp.", h), zero, zero
