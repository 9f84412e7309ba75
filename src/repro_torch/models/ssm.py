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

from repro_torch.distributed.context import (
    contiguous_grad,
    is_dtensor,
    mesh_placements,
    reduce_partial,
    shard_axes,
)
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
    s-K+1 .. s (a cross-correlation over the left-padded input).  DTensors
    take ``_mamba_conv_sharded``."""
    if is_dtensor(x):
        return _mamba_conv_sharded(p, x)
    return _conv_local(x, p.conv_w, p.conv_b)


def _conv_local(x: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor) -> torch.Tensor:
    k, d_in = conv_w.shape
    xp = F.pad(x.transpose(1, 2), (k - 1, 0))  # (B, d_in, S + K - 1)
    out = F.conv1d(xp, conv_w.to(x.dtype).t()[:, None, :], groups=d_in)
    return out.transpose(1, 2) + conv_b


def _mamba_conv_sharded(p: Mamba, x):
    """The depthwise conv on each rank's batch rows and channels, through
    ``local_map``: a channel's conv reads only its own channel, so the
    channels shard as ``conv_w``/``conv_b`` do (over "model", where they
    divide), and DTensor's conv rule, which keeps the global group count
    for a local weight, is not asked."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    chan = shard_axes(p.conv_w, 1)
    rows = [ax for ax in shard_axes(x, 0) if ax not in chan]

    def pl(row, ch):
        return mesh_placements(mesh, {**{ax: row for ax in rows}, **{ax: ch for ax in chan}})

    x_pl, w_pl, b_pl = pl(Shard(0), Shard(2)), pl(Replicate(), Shard(1)), pl(Replicate(), Shard(0))

    def conv(*args):
        if mesh.size() > 1:  # one rank's gradients are the whole ones, as laid out
            args = [contiguous_grad(t) for t in args]
        return _conv_local(*args).contiguous()

    return local_map(
        conv,
        out_placements=(x_pl,), in_placements=(x_pl, w_pl, b_pl),
        in_grad_placements=(x_pl, pl(Partial(), Shard(1)), pl(Partial(), Shard(0))),
        device_mesh=mesh, redistribute_inputs=True)(x, p.conv_w, p.conv_b)


def _mamba_ssm_inputs(p: Mamba, cfg, xc: torch.Tensor):
    """Data-dependent dt, B, C (f32) from the conv output xc (B, S, d_in)."""
    _, dt_rank = mamba_dims(cfg)
    ds = cfg.ssm_d_state
    # x_proj is row-parallel: its partial sums are reduced before the split,
    # or DTensor would have to make dt_bias partial to add it
    proj = reduce_partial(xc @ p.x_proj)
    dt_low, bmat, cmat = torch.split(proj, [dt_rank, ds, ds], dim=-1)
    dt = dt_low @ p.dt_proj + p.dt_bias
    return F.softplus(dt.float()), bmat.float(), cmat.float()


def _mamba_scan(dt, bmat, cmat, xcf, a):
    """The selective scan: dt, xcf (B, S, d_in), bmat, cmat (B, S, ds), a
    (d_in, ds), from a zero state.  Returns (y (B, S, d_in), final h)."""
    b, s, d_in = xcf.shape
    h = torch.zeros(b, d_in, a.shape[1], dtype=torch.float32, device=xcf.device)
    ys = []
    for i in range(s):
        dt_t = dt[:, i, :, None]
        h = torch.exp(dt_t * a) * h + (dt_t * bmat[:, i, None, :]) * xcf[:, i, :, None]
        ys.append(torch.einsum("bcs,bs->bc", h, cmat[:, i]))
    return torch.stack(ys, dim=1), h


def _sharded_scan(scan, args: tuple, dims: tuple, out_dims: tuple):
    """``scan(*args)`` for plain tensors.  On DTensors it runs on each
    rank's shard through ``local_map``, so a scan of S tokens costs S steps
    of local ops and not of DTensor dispatch: ``dims`` gives, for each
    argument, its (batch dim, channel dim) (``None`` where it has none);
    batch rows shard over the mesh dims that shard the first argument's
    batch, channels (heads, or mamba's inner dim) over those that shard its
    channels.  A recurrence is independent per row and channel, so the
    shards are exact; an argument without one of the two dims is whole
    there, and its gradient is a ``Partial`` sum over that mesh dim.
    ``out_dims`` gives the outputs' (batch dim, channel dim)."""
    if not is_dtensor(args[0]):
        return scan(*args)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.sharding import place

    first, (bdim, cdim) = args[0], dims[0]
    mesh = first.device_mesh
    role = {ax: r for r, d in enumerate((bdim, cdim)) if d is not None
            for ax in shard_axes(first, d)}  # mesh dim -> 0 (rows) or 1 (channels)

    def placed(dims_, grad=False):
        return mesh_placements(mesh, {ax: Shard(dims_[r]) if dims_[r] is not None else
                                      Partial() if grad else Replicate()
                                      for ax, r in role.items()})

    def body(*local):
        if mesh.size() > 1:  # one rank's gradients are the whole ones, as laid out
            local = [contiguous_grad(t) for t in local]
        return tuple(t.contiguous() for t in scan(*local))

    # a plain argument (a zero initial state) is the same whole tensor on
    # every rank: each keeps its shard
    args = [a if is_dtensor(a) else place(a, mesh, placed(d)) for a, d in zip(args, dims)]
    return local_map(body, out_placements=tuple(placed(d) for d in out_dims),
                     in_placements=tuple(placed(d) for d in dims),
                     in_grad_placements=tuple(placed(d, grad=True) for d in dims),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def mamba(p: Mamba, cfg, x: torch.Tensor, return_state: bool = False):
    """Full-sequence mamba mixer. x: (B, S, D) -> (B, S, D) [, final state]."""
    xin, z = (x @ p.in_proj).chunk(2, dim=-1)
    xc = F.silu(_mamba_conv_full(p, xin).float()).to(x.dtype)
    dt, bmat, cmat = _mamba_ssm_inputs(p, cfg, xc)
    a = -torch.exp(p.A_log)  # (d_in, ds)
    xcf = xc.float()
    b, s, d_in = xc.shape
    ys, h = _sharded_scan(_mamba_scan, (dt, bmat, cmat, xcf, a),
                          ((0, 2), (0, None), (0, None), (0, 2), (None, 0)), ((0, 2), (0, 1)))
    y = ys + xcf * p.D  # (B, S, d_in)
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


def _rwkv_scan(rh, kh, vh, wh, u, state):
    """The time mix's recurrence over (B, S, nh, hd) f32 r, k, v, w, the
    bonus u (nh, hd) and the state (B, nh, hd, hd).  Returns (y (B, S, nh,
    hd), final state)."""
    u = u[None, :, :, None]
    ys = []
    for i in range(rh.shape[1]):
        kv = kh[:, i, :, :, None] * vh[:, i, :, None, :]  # (B, nh, hd_k, hd_v)
        ys.append(torch.einsum("bhk,bhkv->bhv", rh[:, i], state + u * kv))
        state = wh[:, i, :, :, None] * state + kv
    return torch.stack(ys, dim=1), state


def rwkv_time_mix(p: RWKVTimeMix, cfg, x: torch.Tensor, x_prev=None, state0=None,
                  return_state: bool = False):
    """RWKV-6 time mix over a full sequence. x: (B, S, D)."""
    b, s, d = x.shape
    nh, hd = rwkv_dims(cfg)
    if x_prev is None:
        x_prev = x.new_zeros(b, d)
    r, k, v, g, w = _rwkv_projections(p, x, _rwkv_shift(x, x_prev))
    rh, kh, vh, wh = (_heads(t, nh, hd) for t in (r, k, v, w))
    state = (state0 if state0 is not None
             else torch.zeros(b, nh, hd, hd, dtype=torch.float32, device=x.device))
    y, state = _sharded_scan(_rwkv_scan, (rh, kh, vh, wh, p.u, state),
                             ((0, 2),) * 4 + ((None, 0), (0, 1)), ((0, 2), (0, 1)))
    y = y.reshape(b, s, d)  # (B, S, D) f32
    out = _rwkv_out(p, x, y, g)
    if not return_state:
        return out
    return out, {"s": state, "x_prev": x[:, -1, :].float()}


def rwkv_time_mix_decode(p: RWKVTimeMix, cfg, x: torch.Tensor, state: dict):
    """Single-token time mix, one step of the scan.  state: {"s": (B, nh,
    hd, hd), "x_prev": (B, D)}."""
    b, _, d = x.shape
    nh, hd = rwkv_dims(cfg)
    r, k, v, g, w = _rwkv_projections(p, x, state["x_prev"][:, None, :].to(x.dtype))
    rh, kh, vh, wh = (_heads(t, nh, hd) for t in (r, k, v, w))
    y, new_s = _sharded_scan(_rwkv_scan, (rh, kh, vh, wh, p.u, state["s"]),
                             ((0, 2),) * 4 + ((None, 0), (0, 1)), ((0, 2), (0, 1)))
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
