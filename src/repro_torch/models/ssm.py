"""State-space and linear-recurrent sequence mixers (port of
``repro/models/ssm.py``).

- ``mamba``: the selective SSM block of Jamba's non-attention layers
  (data-dependent dt/B/C, diagonal A, depthwise causal conv).
- ``rwkv_time_mix``: RWKV-6 "Finch" time mix with data-dependent
  per-channel decay (a matrix-valued state per head), and
  ``rwkv_channel_mix``, the squared-ReLU channel-mix FFN.

Training and prefill run the recurrence as a plain Python loop over the
sequence, one step of the reference's ``lax.scan`` body per token, with the
recurrent state in f32 as there.  Decode is the single-step form of the
same recurrence with the state held in the serving cache.  Leaves that the
reference keeps in f32 in a bf16 model (``A_log``, ``D``, ``mu_*``,
``w0``, ``u``, ``ln_x.scale``) are f32 here too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import RMSNorm, dense_init_, rmsnorm, weight


# ---------------------------------------------------------------------------
# Mamba (Jamba's SSM layers)
# ---------------------------------------------------------------------------


def mamba_dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    dt_rank = max(1, -(-cfg.d_model // 16))
    return d_in, dt_rank


class Mamba(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, ds = cfg.d_model, cfg.ssm_d_state
        d_in, dt_rank = mamba_dims(cfg)
        kw = dict(dtype=dtype, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.in_proj = weight(d, 2 * d_in, **kw)
        self.conv_w = weight(cfg.ssm_d_conv, d_in, **kw)
        self.conv_b = weight(d_in, **kw)
        self.x_proj = weight(d_in, dt_rank + 2 * ds, **kw)
        self.dt_proj = weight(dt_rank, d_in, **kw)
        self.dt_bias = weight(d_in, **kw)
        self.A_log = weight(d_in, ds, **f32)
        self.D = weight(d_in, **f32, fill=1.0)
        self.out_proj = weight(d_in, d, **kw)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        for w in (self.in_proj, self.x_proj, self.dt_proj, self.out_proj):
            dense_init_(w, generator)
        dense_init_(self.conv_w, generator, std=0.5)
        self.conv_b.zero_()
        self.dt_bias.zero_()
        ds = self.A_log.shape[1]
        self.A_log.copy_(torch.log(torch.arange(1, ds + 1, dtype=torch.float32)))
        self.D.fill_(1.0)


def _mamba_conv_full(p: Mamba, x: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over (B, S, d_in): output s reads inputs
    s-K+1 .. s (a cross-correlation over the left-padded input)."""
    k, d_in = p.conv_w.shape
    xp = F.pad(x.transpose(1, 2), (k - 1, 0))  # (B, d_in, S + K - 1)
    out = F.conv1d(xp, p.conv_w.to(x.dtype).t()[:, None, :], groups=d_in)
    return out.transpose(1, 2) + p.conv_b


def _mamba_ssm_inputs(p: Mamba, cfg, xc: torch.Tensor):
    """Data-dependent dt, B, C (f32) from the conv output xc (B, S, d_in)."""
    _, dt_rank = mamba_dims(cfg)
    ds = cfg.ssm_d_state
    proj = xc @ p.x_proj
    dt_low, bmat, cmat = torch.split(proj, [dt_rank, ds, ds], dim=-1)
    dt = dt_low @ p.dt_proj + p.dt_bias
    return F.softplus(dt.float()), bmat.float(), cmat.float()


def mamba(p: Mamba, cfg, x: torch.Tensor, return_state: bool = False):
    """Full-sequence mamba mixer. x: (B, S, D) -> (B, S, D) [, final state]."""
    xin, z = (x @ p.in_proj).chunk(2, dim=-1)
    xc = F.silu(_mamba_conv_full(p, xin).float()).to(x.dtype)
    dt, bmat, cmat = _mamba_ssm_inputs(p, cfg, xc)
    a = -torch.exp(p.A_log)  # (d_in, ds)
    xcf = xc.float()
    b, s, d_in = xc.shape
    h = torch.zeros(b, d_in, cfg.ssm_d_state, dtype=torch.float32, device=x.device)
    ys = []
    for i in range(s):
        dt_t = dt[:, i, :, None]
        h = torch.exp(dt_t * a) * h + (dt_t * bmat[:, i, None, :]) * xcf[:, i, :, None]
        ys.append(torch.einsum("bcs,bs->bc", h, cmat[:, i]))
    y = torch.stack(ys, dim=1) + xcf * p.D  # (B, S, d_in)
    y = y.to(x.dtype) * F.silu(z.float()).to(x.dtype)
    out = y @ p.out_proj
    if not return_state:
        return out
    # conv state: the last (K-1) pre-conv inputs
    km1 = cfg.ssm_d_conv - 1
    xin_f = xin.float()
    conv = xin_f[:, s - km1:, :] if s >= km1 else F.pad(xin_f, (0, 0, km1 - s, 0))
    return out, {"h": h, "conv": conv}


def mamba_state_init(cfg, batch: int, device=None) -> dict:
    d_in, _ = mamba_dims(cfg)
    return {"h": torch.zeros(batch, d_in, cfg.ssm_d_state, dtype=torch.float32,
                             device=device),
            "conv": torch.zeros(batch, cfg.ssm_d_conv - 1, d_in, dtype=torch.float32,
                                device=device)}


def mamba_decode(p: Mamba, cfg, x: torch.Tensor, state: dict):
    """Single-token decode. x: (B, 1, D) -> (out (B, 1, D), new state)."""
    xin, z = (x @ p.in_proj).chunk(2, dim=-1)  # (B, 1, d_in)
    window = torch.cat([state["conv"], xin.float()], dim=1)  # (B, K, d_in)
    xc = torch.einsum("bkc,kc->bc", window, p.conv_w.float()) + p.conv_b.float()
    xc = F.silu(xc)[:, None, :].to(x.dtype)  # (B, 1, d_in)
    dt, bmat, cmat = _mamba_ssm_inputs(p, cfg, xc)
    a = -torch.exp(p.A_log)
    dt_t, b_t, c_t = dt[:, 0], bmat[:, 0], cmat[:, 0]
    xc_f = xc[:, 0].float()
    da = torch.exp(dt_t[:, :, None] * a[None, :, :])
    db = dt_t[:, :, None] * b_t[:, None, :]
    h = da * state["h"] + db * xc_f[:, :, None]
    y = torch.einsum("bcs,bs->bc", h, c_t) + xc_f * p.D
    y = y[:, None, :].to(x.dtype) * F.silu(z.float()).to(x.dtype)
    return y @ p.out_proj, {"h": h, "conv": window[:, 1:, :]}


# ---------------------------------------------------------------------------
# RWKV-6 (Finch)
# ---------------------------------------------------------------------------

RWKV_DECAY_LORA = 64  # rank of the data-dependent decay's LoRA


def rwkv_dims(cfg):
    return cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim


def _mixes(module: nn.Module, names: tuple, d: int, device) -> None:
    """Token-shift interpolation weights ``mu_<name>`` (d,), f32, 0.5."""
    for name in names:
        setattr(module, f"mu_{name}", weight(d, dtype=torch.float32, device=device, fill=0.5))


class RWKVTimeMix(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        d = cfg.d_model
        nh, hd = rwkv_dims(cfg)
        kw = dict(dtype=dtype, device=device)
        _mixes(self, ("r", "k", "v", "w", "g"), d, device)
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name, weight(d, d, **kw))
        # data-dependent decay: w_t = exp(-exp(w0 + tanh(x Wa) Wb))
        self.w0 = weight(d, dtype=torch.float32, device=device, fill=-6.0)
        self.wa = weight(d, RWKV_DECAY_LORA, **kw)
        self.wb = weight(RWKV_DECAY_LORA, d, **kw)
        self.u = weight(nh, hd, dtype=torch.float32, device=device)  # bonus
        self.ln_x = RMSNorm(d, torch.float32, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        for w in (self.wr, self.wk, self.wv, self.wg, self.wo, self.wa, self.wb):
            dense_init_(w, generator)
        for name in ("r", "k", "v", "w", "g"):
            getattr(self, f"mu_{name}").fill_(0.5)
        self.w0.fill_(-6.0)
        u = torch.randn(self.u.shape, dtype=torch.float32, device=generator.device,
                        generator=generator)
        self.u.copy_(u * 0.1)
        self.ln_x.scale.fill_(1.0)


def _rwkv_shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Token shift: prepend x_prev (B, D) to x (B, S, D) shifted by one."""
    return torch.cat([x_prev[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def _mix(x: torch.Tensor, x_shift: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    m = mu.float()
    return (x.float() * (1 - m) + x_shift.float() * m).to(x.dtype)


def _rwkv_projections(p: RWKVTimeMix, x: torch.Tensor, x_shift: torch.Tensor):
    r = _mix(x, x_shift, p.mu_r) @ p.wr
    k = _mix(x, x_shift, p.mu_k) @ p.wk
    v = _mix(x, x_shift, p.mu_v) @ p.wv
    g = _mix(x, x_shift, p.mu_g) @ p.wg
    xw = _mix(x, x_shift, p.mu_w).float()
    dec = p.w0 + torch.tanh(xw @ p.wa.float()) @ p.wb.float()
    w = torch.exp(-torch.exp(dec))  # (B, S, D) in (0, 1): per-channel decay
    return r, k, v, g, w


def _heads(t: torch.Tensor, nh: int, hd: int) -> torch.Tensor:
    b, s, _ = t.shape
    return t.reshape(b, s, nh, hd).float()


def _rwkv_out(p: RWKVTimeMix, x: torch.Tensor, y: torch.Tensor, g: torch.Tensor):
    """Norm the f32 mix y (B, S, D), gate it by silu(g) and project."""
    y = rmsnorm(y, p.ln_x.scale)
    y = y.to(x.dtype) * F.silu(g.float()).to(x.dtype)
    return y @ p.wo


def rwkv_time_mix(p: RWKVTimeMix, cfg, x: torch.Tensor, x_prev=None, state0=None,
                  return_state: bool = False):
    """RWKV-6 time mix over a full sequence. x: (B, S, D)."""
    b, s, d = x.shape
    nh, hd = rwkv_dims(cfg)
    if x_prev is None:
        x_prev = x.new_zeros(b, d)
    r, k, v, g, w = _rwkv_projections(p, x, _rwkv_shift(x, x_prev))
    rh, kh, vh, wh = (_heads(t, nh, hd) for t in (r, k, v, w))
    u = p.u[None, :, :, None]
    state = (state0 if state0 is not None
             else torch.zeros(b, nh, hd, hd, dtype=torch.float32, device=x.device))
    ys = []
    for i in range(s):
        kv = kh[:, i, :, :, None] * vh[:, i, :, None, :]  # (B, nh, hd_k, hd_v)
        ys.append(torch.einsum("bhk,bhkv->bhv", rh[:, i], state + u * kv))
        state = wh[:, i, :, :, None] * state + kv
    y = torch.stack(ys, dim=1).reshape(b, s, d)  # (B, S, D) f32
    out = _rwkv_out(p, x, y, g)
    if not return_state:
        return out
    return out, {"s": state, "x_prev": x[:, -1, :].float()}


def rwkv_time_mix_decode(p: RWKVTimeMix, cfg, x: torch.Tensor, state: dict):
    """Single-token time mix.  state: {"s": (B, nh, hd, hd), "x_prev": (B, D)}."""
    b, _, d = x.shape
    nh, hd = rwkv_dims(cfg)
    r, k, v, g, w = _rwkv_projections(p, x, state["x_prev"][:, None, :].to(x.dtype))
    r_t, k_t, v_t, w_t = (_heads(t, nh, hd)[:, 0] for t in (r, k, v, w))
    kv = k_t[..., :, None] * v_t[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", r_t, state["s"] + p.u[None, :, :, None] * kv)
    new_s = w_t[..., :, None] * state["s"] + kv
    out = _rwkv_out(p, x, y.reshape(b, 1, d), g)
    return out, {"s": new_s, "x_prev": x[:, 0, :].float()}


class RWKVChannelMix(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, dff = cfg.d_model, cfg.d_ff
        kw = dict(dtype=dtype, device=device)
        _mixes(self, ("k", "r"), d, device)
        self.wk = weight(d, dff, **kw)
        self.wv = weight(dff, d, **kw)
        self.wr = weight(d, d, **kw)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        for w in (self.wk, self.wv, self.wr):
            dense_init_(w, generator)
        self.mu_k.fill_(0.5)
        self.mu_r.fill_(0.5)


def rwkv_channel_mix(p: RWKVChannelMix, cfg, x: torch.Tensor, x_prev=None) -> torch.Tensor:
    b, s, d = x.shape
    if x_prev is None:
        x_prev = x.new_zeros(b, d)
    x_shift = _rwkv_shift(x, x_prev)
    k = _mix(x, x_shift, p.mu_k) @ p.wk
    k = torch.square(torch.relu(k.float())).to(x.dtype)
    kv = k @ p.wv
    r = torch.sigmoid((_mix(x, x_shift, p.mu_r) @ p.wr).float()).to(x.dtype)
    return r * kv


def rwkv_state_init(cfg, batch: int, device=None) -> dict:
    nh, hd = rwkv_dims(cfg)
    zeros = dict(dtype=torch.float32, device=device)
    return {"s": torch.zeros(batch, nh, hd, hd, **zeros),
            "x_prev_att": torch.zeros(batch, cfg.d_model, **zeros),
            "x_prev_ffn": torch.zeros(batch, cfg.d_model, **zeros)}
