"""Mamba-1 selective SSM block, jamba's sequence mixer (port of
``repro/models/mamba.py``).

Recurrence per channel i with state dimension n:
    h_t = exp(Δ_t · A) ⊙ h_{t-1} + (Δ_t · B_t) · x_t
    y_t = C_t · h_t + D ⊙ x_t
with input-dependent Δ, B, C (selectivity). One sequential scan over
time computes it. With ``layers.OPT["mamba_recompute"]``, no state and
``s >= 64`` (the reference's time-chunked form, §Perf H2) the scan runs
in 16-step chunks, each under ``torch.utils.checkpoint`` when autograd
records: the backward keeps h once a chunk and recomputes the chunk's
steps — the same recurrence, the same values. On a ``DeviceMesh`` the
block runs per (batch, channel) shard (``layers.shard_local``): batch
over the data axes, the inner channels over ``model``, as the
reference pins h. Decode keeps O(1) state: (conv window, h).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from . import layers as L
from .layers import Leaves, const, mm, model_device, normal

CHUNK = 16          # the reference's recompute chunk


@dataclasses.dataclass(frozen=True)
class MambaDims:
    d_inner: int
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int = 0          # ModelConfig.mamba_dims: ceil(d_model / 16)


def _dt_bias(t, gen):
    """softplus⁻¹ of U(1e-3, 1e-1)."""
    return t.copy_(torch.log(torch.expm1(t.uniform_(1e-3, 1e-1,
                                                    generator=gen))))


def _a_log(t, gen):
    ds = t.shape[1]
    return t.copy_(torch.arange(1, ds + 1, dtype=torch.float32,
                                device=t.device).log().expand_as(t))


class Mamba(Leaves):
    def __init__(self, d_model, dims: MambaDims, dtype, device):
        super().__init__(device)
        di, ds, dc, dr = dims.d_inner, dims.d_state, dims.d_conv, dims.dt_rank
        self.leaf("in_proj", (d_model, 2 * di), dtype, normal())
        self.leaf("conv_w", (dc, di), dtype, normal(dc ** -0.5))
        self.leaf("conv_b", (di,), dtype, const(0.0))
        self.leaf("x_proj", (di, dr + 2 * ds), dtype, normal())
        self.leaf("dt_proj", (dr, di), dtype, normal())
        self.leaf("dt_bias", (di,), torch.float32, _dt_bias)
        self.leaf("A_log", (di, ds), torch.float32, _a_log)
        self.leaf("D", (di,), torch.float32, const(1.0))
        self.leaf("out_proj", (di, d_model), dtype, normal())


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv. x: (B, S, di); w: (dc, di).

    state: (B, dc-1, di) trailing context (decode) or None (zero
    left-pad). Returns (y, new_state).
    """
    dc = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], dc - 1, x.shape[2]))
    t = torch.promote_types(state.dtype, x.dtype)
    xp = torch.cat([state.to(t), x.to(t)], dim=1)
    new_state = xp[:, -(dc - 1):, :].clone()  # a view would hold all of xp
    s = x.shape[1]
    y = sum(xp[:, j:j + s, :] * w[j] for j in range(dc))
    return y + b, new_state


def mamba_block(p: Mamba, x, dims: MambaDims, *, state=None):
    """x: (B, S, d_model) → (y, new_state).

    state: None (returns None) or dict(conv=(B,dc-1,di), h=(B,di,ds))
    for stepwise decode.

    On a ``DeviceMesh`` each model rank runs its own inner channels (when
    they divide the axis): its columns of ``in_proj`` for x and z (the
    weight gathered, the rank's channels taken from both halves), the
    conv, and ``x_proj`` row-parallel, whose partial sums are all-reduced;
    then ``dt_proj`` column-parallel, the scan, and ``out_proj``
    row-parallel, all-reduced to the stream's layout."""
    di, ds, dr = dims.d_inner, dims.d_state, dims.dt_rank
    s = x.shape[1]
    split = di % L._model_axis() == 0
    cx = "model" if split else None
    xs = L.stream_spec(x)
    chs, hs = xs[:1] + [None, cx], xs[:1] + [cx, None]
    lo = L.shard_start(di, x, p.in_proj) if split else 0

    def front(x, w, conv_w, conv_b, x_proj, conv_state=None):
        n = conv_w.shape[1]
        if n == di:
            xz, z = mm(x, w).chunk(2, dim=-1)
        else:
            xz, z = mm(x, w[:, lo:lo + n]), mm(x, w[:, di + lo:di + lo + n])
        xz, new_conv = _causal_conv(xz, conv_w, conv_b, conv_state)
        xz = F.silu(xz)
        return xz, z, mm(xz, x_proj), new_conv
    args = (x, L.fsdp_use(p.in_proj, None, None), p.conv_w, p.conv_b,
            p.x_proj)
    axes = (xs, (None, None), (None, cx), (cx,), (cx, None))
    if state is not None:
        args, axes = args + (state["conv"],), axes + (chs,)
    xz, z, proj, new_conv = L.shard_local(
        front, args, axes, (chs, chs, L.summed(xs, split), chs))
    proj = L.to_stream(proj)

    chunked = L.OPT["mamba_recompute"] and state is None and s >= 64
    if chunked:
        assert s % CHUNK == 0, (s, CHUNK)
    dtype = x.dtype

    def back(xz, z, proj, dt_proj, dt_bias, a_log, d_skip, out_proj,
             h=None):
        dt_r, bmat, cmat = proj.split([dr, ds, ds], dim=-1)
        dt = F.softplus(mm(dt_r, dt_proj) + dt_bias).float()  # (B,S,di)
        a = -torch.exp(a_log)                                  # (di,ds)
        if h is None:
            h = xz.new_zeros((xz.shape[0], xz.shape[2], ds),
                             dtype=torch.float32)
        xf, bf, cf = xz.float(), bmat.float(), cmat.float()
        ys, h = _scan(dt, xf, bf, cf, a, h, chunked)
        y = (ys + xf * d_skip).to(dtype)
        y = y * F.silu(z)
        return mm(y, out_proj), h
    args = (xz, z, proj, L.fsdp_use(p.dt_proj, None, "model"), p.dt_bias,
            p.A_log, p.D, L.fsdp_use(p.out_proj, "model", None))
    axes = (chs, chs, xs, (None, cx), (cx,), (cx, None), (cx,), (cx, None))
    if state is not None:
        args, axes = args + (state["h"],), axes + (hs,)
    out, h = L.shard_local(back, args, axes, (L.summed(xs, split), hs))
    new_state = None if state is None else {"conv": new_conv, "h": h}
    return L.to_stream(out), new_state


def _steps(dt, xf, bf, cf, a, h):
    # unbind, not an index a step: an index's backward writes a zero
    # tensor of the whole sequence for every step
    ys = []
    for dt_t, x_t, b_t, c_t in zip(*(t.unbind(1) for t in (dt, xf, bf,
                                                           cf))):
        da_t = torch.exp(dt_t[..., None] * a)                 # (B,di,ds)
        dbx_t = (dt_t * x_t)[..., None] * b_t[:, None, :]
        h = da_t * h + dbx_t
        ys.append((h @ c_t[:, :, None])[..., 0])
    return torch.stack(ys, dim=1), h                          # (B,S,di)


def _scan(dt, xf, bf, cf, a, h, chunked):
    """The recurrence over time from ``h``: (ys (B,S,di), last h); with
    ``chunked``, 16-step chunks, each recomputed in the backward (the
    first ``layers.SCAN_STEPS`` steps only, when set)."""
    n = dt.shape[1]
    run, (dt, xf, bf, cf) = L.scan_prefix(n, dt, xf, bf, cf)
    if not chunked:
        ys, h = _steps(dt, xf, bf, cf, a, h)
        return L.zero_filled(ys, n), h
    ys = []
    for i in range(0, run, CHUNK):
        blk = (dt[:, i:i + CHUNK], xf[:, i:i + CHUNK], bf[:, i:i + CHUNK],
               cf[:, i:i + CHUNK], a, h)
        y, h = checkpoint(_steps, *blk, use_reentrant=False) \
            if torch.is_grad_enabled() else _steps(*blk)
        ys.append(y)
    return L.zero_filled(torch.cat(ys, dim=1), n), h


def init_mamba_state(batch, dims: MambaDims, dtype=torch.bfloat16,
                     device="cuda"):
    dev = model_device(device)
    return {"conv": torch.zeros((batch, dims.d_conv - 1, dims.d_inner),
                                dtype=dtype, device=dev),
            "h": torch.zeros((batch, dims.d_inner, dims.d_state),
                             dtype=torch.float32, device=dev)}
