"""State-space and linear-recurrent sequence mixers (port of
``repro/models/ssm.py``).

- ``mamba``: the selective SSM block of Jamba's non-attention layers
  (data-dependent dt/B/C, diagonal A, depthwise causal conv; with the
  config's ``ssm_dt_bc_norm``, RMS norms on dt, B and C after ``x_proj``,
  as the published Jamba models have them and the reference does not).
- ``rwkv_time_mix``: RWKV-6 "Finch" time mix with data-dependent
  per-channel decay (a matrix-valued state per head), and
  ``rwkv_channel_mix``, the squared-ReLU channel-mix FFN.

Training and prefill run the recurrence in chunks of ``SCAN_CHUNK``
tokens, where the reference runs one ``lax.scan`` step a token: every
chunk's own part in closed form, all chunks at once, then the state carried
from chunk to chunk in sequence, a few ops a chunk.  ``_rwkv_scan`` takes
the pairs of a chunk from differences of cumulative log-decays;
``_mamba_scan``, whose decay differs per (channel, state), takes a
log-depth scan of (decay, input) pairs inside each chunk and its own
backward (``_MambaScan``), which keeps only the chunks' input states; its
forward and backward run ``SCAN_GROUP`` chunks at a time, the state (or
its adjoint) carried from group to group, so their temporaries are bounded
by the group and not by the sequence.  Serving's prefill on the card
(``_selective_scan``: a CUDA tensor of which no gradient is wanted) runs
the scan, with its softplus and D skip, as one hand-written kernel
(``kernels/ssm_scan``, ``csrc/ssm_scan.cu``) that keeps the state in
registers; the chunked scan is its plain version and training's path.  The
recurrent state is f32 as in the reference, and the results are allclose
to its ``lax.scan``.  Decode is the single-step form of the same
recurrence with the state held in the serving cache.  Leaves that the
reference keeps in f32 in a bf16 model (``A_log``, ``D``, ``mu_*``,
``w0``, ``u``, ``ln_x.scale``) are f32 here too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils._python_dispatch import _get_current_dispatch_mode

from repro_torch import obs
from repro_torch.distributed.context import (
    contiguous_grad,
    gather_fsdp,
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
        if cfg.ssm_dt_bc_norm:
            self.dt_norm = RMSNorm(dt_rank, dtype, device)
            self.b_norm = RMSNorm(ds, dtype, device)
            self.c_norm = RMSNorm(ds, dtype, device)

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
    """Data-dependent dt before its softplus (xc's dtype) and B, C (f32)
    from the conv output xc (B, S, d_in)."""
    _, dt_rank = mamba_dims(cfg)
    ds = cfg.ssm_d_state
    # x_proj is row-parallel: its partial sums are reduced before the split,
    # or DTensor would have to make dt_bias partial to add it
    proj = reduce_partial(xc @ gather_fsdp(p.x_proj))
    dt_low, bmat, cmat = torch.split(proj, [dt_rank, ds, ds], dim=-1)
    if cfg.ssm_dt_bc_norm:
        dt_low, bmat, cmat = p.dt_norm(dt_low), p.b_norm(bmat), p.c_norm(cmat)
    return dt_low @ gather_fsdp(p.dt_proj) + p.dt_bias, bmat.float(), cmat.float()


# Tokens a chunk of the chunked scans (``_mamba_scan``, ``_rwkv_scan``).
SCAN_CHUNK = 32


def _chunked(t: torch.Tensor, c: int) -> torch.Tensor:
    """(B, S, ...) -> (B, N, c, ...), zero-padded at the end to N = ceil(S / c)
    chunks.  A padded token carries a zero input and a decay of one (zero
    log-decay), so it changes no real output and no final state."""
    b, s = t.shape[:2]
    n = -(-s // c)
    if n * c != s:
        t = torch.cat([t, t.new_zeros((b, n * c - s) + t.shape[2:])], dim=1)
    return t.reshape((b, n, c) + t.shape[2:])


def _pair_scan(decay: torch.Tensor, inp: torch.Tensor, dim: int):
    """Inclusive scan of ``h_t = decay_t * h_{t-1} + inp_t`` from a zero
    state along ``dim``, in log2(length) steps of (decay, input) pairs
    (Hillis-Steele).  Returns (the decays' running products, h)."""
    c = decay.shape[dim]
    off = 1
    while off < c:
        d_cur, d_prev = decay.narrow(dim, off, c - off), decay.narrow(dim, 0, c - off)
        i_cur, i_prev = inp.narrow(dim, off, c - off), inp.narrow(dim, 0, c - off)
        inp = torch.cat([inp.narrow(dim, 0, off), d_cur * i_prev + i_cur], dim)
        decay = torch.cat([decay.narrow(dim, 0, off), d_cur * d_prev], dim)
        off *= 2
    return decay, inp


def _mamba_pairs(dt, bmat, xcf, a):
    """Each token's decay exp(dt a) and input dt x B, (B, N, c, d_in, ds),
    of chunked dt, xcf (B, N, c, d_in) and bmat (B, N, c, ds)."""
    da = torch.exp(dt[..., None] * a)
    db = (dt * xcf)[..., None] * bmat[..., None, :]
    return da, db


def _mamba_states(da, db, h0):
    """The chunks' local scans, then the state carried through them in
    sequence from ``h0``: (every token's h (B, N, c, d_in, ds), the
    chunks' input states (B, N, d_in, ds), the final state)."""
    prod, loc = _pair_scan(da, db, 2)
    h_in, h = [], h0
    for i in range(da.shape[1]):
        h_in.append(h)
        h = prod[:, i, -1] * h + loc[:, i, -1]
    h_in = torch.stack(h_in, dim=1)
    return loc + prod * h_in[:, :, None], h_in, h


def _mamba_group(dtc, bc, xc, cc, a, h0):
    """One group of chunked dt, B, x, C (B, n, c, ...) from the state
    ``h0``: (y (B, n, c, d_in), the chunks' input states, the final state)."""
    da, db = _mamba_pairs(dtc, bc, xc, a)
    h, h_in, h_last = _mamba_states(da, db, h0)
    return torch.einsum("bncis,bncs->bnci", h, cc), h_in, h_last


# Chunks a group of ``_MambaScan``'s forward and backward, which run the
# chunks in groups (the backward the last first): their (B, chunks, c,
# d_in, ds) f32 temporaries live for one group at a time (1.1 GB a tensor
# at 4 prompts and Jamba's d_in of 8,192).
SCAN_GROUP = 16


def _scan_forward(dt, bmat, cmat, xcf, a, keep_states: bool):
    """The chunked scan's forward, ``SCAN_GROUP`` chunks at a time, the
    state carried from group to group: (y (B, S, d_in), the chunks' input
    states (B, N, d_in, ds) if ``keep_states`` else None, the final state)."""
    b, s, d_in = xcf.shape
    c = min(SCAN_CHUNK, s)
    chunked = [_chunked(t, c) for t in (dt, bmat, xcf, cmat)]
    n = chunked[0].shape[1]
    h = xcf.new_zeros(b, d_in, a.shape[1])
    y = xcf.new_empty(b, n, c, d_in)
    h_in = xcf.new_empty(b, n, d_in, a.shape[1]) if keep_states else None
    for lo in range(0, n, SCAN_GROUP):
        hi = min(n, lo + SCAN_GROUP)
        y[:, lo:hi], group_in, h = _mamba_group(*(t[:, lo:hi] for t in chunked), a, h)
        if keep_states:
            h_in[:, lo:hi] = group_in
    return y.reshape(b, -1, d_in)[:, :s], h_in, h


class _MambaScan(torch.autograd.Function):
    """The selective scan in chunks (``_scan_forward``), with its backward:
    the adjoint of h, ``g_t = dy_t C_t + da_{t+1} g_{t+1}``, is the same
    scan run backwards (chunks in reverse, each in log depth, a group at a
    time, the adjoint carried from group to group).  Saves only the inputs
    and the chunks' input states; the backward recomputes each token's h."""

    @staticmethod
    def forward(ctx, dt, bmat, cmat, xcf, a):
        y, h_in, h = _scan_forward(dt, bmat, cmat, xcf, a, keep_states=True)
        ctx.save_for_backward(dt, bmat, cmat, xcf, a, h_in)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh_last):
        dt, bmat, cmat, xcf, a, h_in = ctx.saved_tensors
        b, s, d_in = xcf.shape
        c = min(SCAN_CHUNK, s)
        chunked = [_chunked(t, c) for t in (dt, bmat, xcf, cmat, dy)] + [h_in]
        n = h_in.shape[1]
        carry, parts, d_a = dh_last, [], None
        for hi in range(n, 0, -SCAN_GROUP):
            lo = max(0, hi - SCAN_GROUP)
            group = chunked if hi - lo == n else [t[:, lo:hi] for t in chunked]
            dtc, bc, xc, cc, dyc, hin = group
            da, db = _mamba_pairs(dtc, bc, xc, a)
            prod, loc = _pair_scan(da, db, 2)
            h = loc + prod * hin[:, :, None]
            # g_t = dy_t C_t + da_{t+1} g_{t+1}: flipped, a forward scan
            # whose decay at the chunk's last token is one (the carry
            # enters there)
            shifted = torch.cat([da[:, :, 1:], torch.ones_like(da[:, :, :1])], dim=2)
            rprod, rloc = _pair_scan(shifted.flip(2),
                                     (dyc[..., None] * cc[..., None, :]).flip(2), 2)
            rprod, rloc = rprod.flip(2), rloc.flip(2)
            carries = [carry]
            for i in range(hi - lo - 1, 0, -1):  # into chunk i-1's last token
                carries.append(da[:, i, 0] * (rloc[:, i, 0] + rprod[:, i, 0] * carries[-1]))
            if lo:  # into the group before
                carry = da[:, 0, 0] * (rloc[:, 0, 0] + rprod[:, 0, 0] * carries[-1])
            g = rloc + rprod * torch.stack(carries[::-1], dim=1)[:, :, None]
            h_prev = torch.cat([hin[:, :, None], h[:, :, :-1]], dim=2)
            gda = g * h_prev * da  # through da = exp(dt a)
            gb = torch.einsum("bncis,bncs->bnci", g, bc)
            parts.append((torch.einsum("bncis,is->bnci", gda, a) + gb * xc,
                          torch.einsum("bncis,bnci->bncs", g, dtc * xc),
                          torch.einsum("bncis,bnci->bncs", h, dyc),
                          gb * dtc))
            d_a_group = torch.einsum("bncis,bnci->is", gda, dtc)
            d_a = d_a_group if d_a is None else d_a + d_a_group

        def back(group_parts):
            t = group_parts[0] if len(group_parts) == 1 else torch.cat(group_parts[::-1], dim=1)
            return t.reshape((b, -1) + t.shape[3:])[:, :s]

        d_dt, d_b, d_c, d_x = (back(list(p)) for p in zip(*parts))
        return d_dt, d_b, d_c, d_x, d_a


def _mamba_scan(dt, bmat, cmat, xcf, a):
    """The selective scan: dt, xcf (B, S, d_in), bmat, cmat (B, S, ds), a
    (d_in, ds), from a zero state.  Returns (y (B, S, d_in), final h).
    Without a gradient to take (serving) it keeps no chunk's input state."""
    args = (dt, bmat, cmat, xcf, a)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _MambaScan.apply(*args)
    y, _, h = _scan_forward(*args, keep_states=False)
    return y, h


def selective_scan_plain(dt, bmat, cmat, xc, a, d):
    """The fused selective scan's plain version: dt before its softplus and
    xc (B, S, d_in) in the model's dtype, bmat, cmat (B, S, ds) f32, a
    (d_in, ds), d (d_in,).  Returns (y (B, S, d_in) in xc's dtype, final h
    (B, d_in, ds) f32): ``_mamba_scan`` of ``softplus(dt)`` and xc in f32,
    then the D skip, rounded once to xc's dtype."""
    xcf = xc.float()
    ys, h = _mamba_scan(F.softplus(dt.float()), bmat, cmat, xcf, a)
    return (ys + xcf * d).to(xc.dtype), h


def _takes_scan_kernel(args: tuple) -> bool:
    """Whether the selective scan runs the kernel (``kernels/ssm_scan``):
    real CUDA tensors (not fake, no dispatch mode watching the ops) of which
    no gradient is wanted, as in serving's prefill."""
    xc = args[3]
    return (xc.is_cuda and type(xc) is torch.Tensor and _get_current_dispatch_mode() is None
            and not (torch.is_grad_enabled() and any(t.requires_grad for t in args)))


def _selective_scan(dt, bmat, cmat, xc, a, d):
    """The selective scan with its softplus and D skip
    (``selective_scan_plain``'s arguments and results), on one of two
    routes: the kernel ``ssm_scan_fwd`` where ``_takes_scan_kernel``, else
    the plain version, whose ``_mamba_scan`` takes ``_MambaScan`` when a
    gradient is wanted.  Counts ``mamba.scan_kernel`` (1 on the kernel's
    route, else 0)."""
    args = (dt, bmat, cmat, xc, a, d)
    kernel = _takes_scan_kernel(args)
    obs.count("mamba.scan_kernel", int(kernel))
    if kernel:
        from repro_torch.kernels.ssm_scan import ssm_scan_fwd

        return ssm_scan_fwd(*args)
    return selective_scan_plain(*args)


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


class _SiluGate(torch.autograd.Function):
    """``_silu_gate`` for training: the same forward ops, saving y and z in
    their own dtype where autograd would keep silu's f32 copy of z; the
    backward recomputes silu(z) (the same ops, so the same numbers)."""

    @staticmethod
    def forward(ctx, y, z):
        ctx.save_for_backward(y, z)
        return y * F.silu(z.float()).to(y.dtype)

    @staticmethod
    def backward(ctx, d_out):
        y, z = ctx.saved_tensors
        zf = z.float()
        d_y = d_out * F.silu(zf).to(y.dtype)
        d_z = torch.ops.aten.silu_backward((d_out * y).float(), zf)
        return d_y, d_z.to(z.dtype)


def _silu_gate(y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """y gated by silu(z), silu in f32 and cast to y's dtype."""
    if torch.is_grad_enabled() and (y.requires_grad or z.requires_grad):
        return _SiluGate.apply(y, z)
    return y * F.silu(z.float()).to(y.dtype)


def mamba(p: Mamba, cfg, x: torch.Tensor, return_state: bool = False):
    """Full-sequence mamba mixer. x: (B, S, D) -> (B, S, D) [, final state].
    Spans ``mamba`` (the mixer) and ``mamba.scan``; counters
    ``mamba.scan_tokens`` (B·S), ``mamba.scan_calls`` and
    ``mamba.scan_kernel`` (``_selective_scan``)."""
    with obs.span("mamba", device=x.device):
        xin, z = (x @ gather_fsdp(p.in_proj)).chunk(2, dim=-1)
        # channels contiguous, as the scan kernel reads them: the conv's
        # output is laid out sequence-first; the cast to x's dtype lays it
        # out, and where there is no cast (an f32 model) .contiguous() does
        xc = F.silu(_mamba_conv_full(p, xin).float()).to(
            x.dtype, memory_format=torch.contiguous_format).contiguous()
        dt, bmat, cmat = _mamba_ssm_inputs(p, cfg, xc)
        a = -torch.exp(p.A_log)  # (d_in, ds)
        b, s, _ = xc.shape
        obs.count("mamba.scan_tokens", b * s)
        obs.count("mamba.scan_calls", 1)
        with obs.span("mamba.scan", device=x.device):
            y, h = _sharded_scan(_selective_scan, (dt, bmat, cmat, xc, a, p.D),
                                 ((0, 2), (0, None), (0, None), (0, 2), (None, 0), (None, 0)),
                                 ((0, 2), (0, 1)))
        del dt, bmat, cmat, xc
        out = _silu_gate(y, z) @ gather_fsdp(p.out_proj)
        if not return_state:
            return out
        # conv state: the last (K-1) pre-conv inputs (cut before the copy:
        # a view would keep the whole sequence's f32 inputs in the cache)
        km1 = cfg.ssm_d_conv - 1
        xin_f = xin[:, max(0, s - km1):, :].float()
        conv = xin_f if s >= km1 else F.pad(xin_f, (0, 0, km1 - s, 0))
        return out, {"h": h, "conv": conv}


def mamba_state_init(cfg, batch: int, device=None) -> dict:
    d_in, _ = mamba_dims(cfg)
    return {"h": torch.zeros(batch, d_in, cfg.ssm_d_state, dtype=torch.float32,
                             device=device),
            "conv": torch.zeros(batch, cfg.ssm_d_conv - 1, d_in, dtype=torch.float32,
                                device=device)}


def mamba_decode(p: Mamba, cfg, x: torch.Tensor, state: dict):
    """Single-token decode (span ``mamba.decode``). x: (B, 1, D) -> (out
    (B, 1, D), new state)."""
    with obs.span("mamba.decode", device=x.device):
        xin, z = (x @ gather_fsdp(p.in_proj)).chunk(2, dim=-1)  # (B, 1, d_in)
        window = torch.cat([state["conv"], xin.float()], dim=1)  # (B, K, d_in)
        xc = torch.einsum("bkc,kc->bc", window, p.conv_w.float()) + p.conv_b.float()
        xc = F.silu(xc)[:, None, :].to(x.dtype)  # (B, 1, d_in)
        dt, bmat, cmat = _mamba_ssm_inputs(p, cfg, xc)
        a = -torch.exp(p.A_log)
        dt_t, b_t, c_t = F.softplus(dt[:, 0].float()), bmat[:, 0], cmat[:, 0]
        xc_f = xc[:, 0].float()
        da = torch.exp(dt_t[:, :, None] * a[None, :, :])
        db = dt_t[:, :, None] * b_t[:, None, :]
        h = da * state["h"] + db * xc_f[:, :, None]
        y = torch.einsum("bcs,bs->bc", h, c_t) + xc_f * p.D
        y = _silu_gate(y[:, None, :].to(x.dtype), z)
        return y @ gather_fsdp(p.out_proj), {"h": h, "conv": window[:, 1:, :]}


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
    r = _mix(x, x_shift, p.mu_r) @ gather_fsdp(p.wr)
    k = _mix(x, x_shift, p.mu_k) @ gather_fsdp(p.wk)
    v = _mix(x, x_shift, p.mu_v) @ gather_fsdp(p.wv)
    g = _mix(x, x_shift, p.mu_g) @ gather_fsdp(p.wg)
    xw = _mix(x, x_shift, p.mu_w).float()
    dec = p.w0 + torch.tanh(xw @ gather_fsdp(p.wa).float()) @ gather_fsdp(p.wb).float()
    w = torch.exp(-torch.exp(dec))  # (B, S, D) in (0, 1): per-channel decay
    return r, k, v, g, w


def _heads(t: torch.Tensor, nh: int, hd: int) -> torch.Tensor:
    b, s, _ = t.shape
    return t.reshape(b, s, nh, hd).float()


def _rwkv_out(p: RWKVTimeMix, x: torch.Tensor, y: torch.Tensor, g: torch.Tensor):
    """Norm the f32 mix y (B, S, D), gate it by silu(g) and project."""
    y = _silu_gate(rmsnorm(y, p.ln_x.scale).to(x.dtype), g)
    return y @ gather_fsdp(p.wo)


def _rwkv_step(r, k, v, w, u, state):
    """One token of the time mix's recurrence: r, k, v, w (B, nh, hd), u
    (nh, hd), state (B, nh, hd_k, hd_v).  Returns (y (B, nh, hd), state)."""
    kv = k[..., :, None] * v[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", r, state + u[None, :, :, None] * kv)
    return y, w[..., :, None] * state + kv


def _rwkv_scan(rh, kh, vh, wh, u, state):
    """The time mix's recurrence over (B, S, nh, hd) f32 r, k, v, w, the
    bonus u (nh, hd) and the state (B, nh, hd_k, hd_v).  Returns (y (B, S,
    nh, hd), final state).  One token (decode) is one step; a sequence runs
    in chunks of ``SCAN_CHUNK``: with L_t the cumulative log-decay in the
    chunk, the pair (s < t) weighs k_s v_s by exp(L_{t-1} - L_s), the token
    itself by u, and the chunk's input state reaches t through
    exp(L_{t-1}).  No exponent is positive, so no factor exceeds one."""
    b, s, nh, hd = rh.shape
    if s == 1:
        y, state = _rwkv_step(rh[:, 0], kh[:, 0], vh[:, 0], wh[:, 0], u, state)
        return y[:, None], state
    c = min(SCAN_CHUNK, s)
    # (B, nh, N, c, hd); a decay that underflowed to 0 takes the least normal
    # f32, so no logarithm is -inf
    logw = torch.log(wh.clamp_min(torch.finfo(torch.float32).tiny))
    r, k, v, logw = (_chunked(t, c).permute(0, 3, 1, 2, 4) for t in (rh, kh, vh, logw))
    lc = logw.cumsum(3)  # L_t
    lx = torch.cat([torch.zeros_like(lc[..., :1, :]), lc[..., :-1, :]], dim=3)  # L_{t-1}
    before = torch.ones(c, c, dtype=torch.bool, device=rh.device).tril(-1)[..., None]
    decay = torch.exp(torch.where(before, lx[..., :, None, :] - lc[..., None, :, :],
                                  float("-inf")))  # [t, s]: s < t
    pairs = torch.einsum("bhntsk,bhnsk->bhnts", decay * r[..., :, None, :], k)
    bonus = (r * u[None, :, None, None, :] * k).sum(-1)
    y = (pairs + torch.diag_embed(bonus)) @ v
    # each chunk's own contribution to the state at its end, then the state
    # carried through the chunks in sequence
    last = lc[..., -1:, :]
    kv = (k * torch.exp(last - lc)).transpose(-1, -2) @ v
    keep = torch.exp(last[..., 0, :, None])
    s_in = []
    for i in range(r.shape[2]):
        s_in.append(state)
        state = keep[:, :, i] * state + kv[:, :, i]
    y = y + (r * torch.exp(lx)) @ torch.stack(s_in, dim=2)
    return y.permute(0, 2, 3, 1, 4).reshape(b, -1, nh, hd)[:, :s], state


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
    k = _mix(x, x_shift, p.mu_k) @ gather_fsdp(p.wk)
    k = torch.square(torch.relu(k.float())).to(x.dtype)
    kv = k @ gather_fsdp(p.wv)
    r = torch.sigmoid((_mix(x, x_shift, p.mu_r) @ gather_fsdp(p.wr)).float()).to(x.dtype)
    return r * kv


def rwkv_state_init(cfg, batch: int, device=None) -> dict:
    nh, hd = rwkv_dims(cfg)
    zeros = dict(dtype=torch.float32, device=device)
    return {"s": torch.zeros(batch, nh, hd, hd, **zeros),
            "x_prev_att": torch.zeros(batch, cfg.d_model, **zeros),
            "x_prev_ffn": torch.zeros(batch, cfg.d_model, **zeros)}
