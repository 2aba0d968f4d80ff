"""RWKV-6 "Finch" block: attention-free time mixing with data-dependent
per-channel decay (arXiv:2404.05892; port of ``repro/models/rwkv6.py``).

Per head (head size P): state S ∈ R^{P×P};
    S_t = diag(w_t) · S_{t-1} + k_t^T v_t
    o_t = r_t · (S_{t-1} + diag(u) k_t^T v_t)
with w_t = exp(−exp(w0 + LoRA_w(x̃_t))) data-dependent. Token-shift
interpolation coefficients are also data-dependent via small LoRAs.

One sequential scan over time carries S (B, H, P, P) in float32. With
``layers.OPT["mamba_recompute"]``, no state, ``s % 16 == 0`` and
``s >= 64`` (the reference's chunked form) it runs in 16-step chunks,
each under ``torch.utils.checkpoint`` when autograd records: one S a
chunk is kept for the backward, the same values forward. On a
``DeviceMesh`` the scan runs per (batch, head) shard
(``layers.shard_local``): heads over ``model``, as the reference pins S.
Decode is O(1): one state update per token. Channel mixing is the RWKV
squared-ReLU FFN.
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
class RWKVDims:
    n_heads: int
    head_size: int
    d_ff: int
    lora_r: int = 64


class RWKVTmix(Leaves):
    def __init__(self, d_model, dims: RWKVDims, dtype, device):
        super().__init__(device)
        hp, d, r = dims.n_heads * dims.head_size, d_model, dims.lora_r
        f32 = torch.float32
        # token-shift mix coefficients (static part) for r,k,v,w,g
        self.leaf("mu", (5, d), f32, const(0.5))
        self.leaf("mu_lora_a", (d, r), dtype, normal(0.01))
        self.leaf("mu_lora_b", (r, 5 * d), dtype, normal(0.01))
        for name in ("wr", "wk", "wv", "wg"):
            self.leaf(name, (d, hp), dtype, normal())
        self.leaf("w0", (hp,), f32, const(-6.0))
        self.leaf("w_lora_a", (d, r), dtype, normal(0.01))
        self.leaf("w_lora_b", (r, hp), dtype, normal(0.01))
        self.leaf("u", (dims.n_heads, dims.head_size), f32, normal(0.5))
        self.leaf("gn_w", (hp,), f32, const(1.0))
        self.leaf("gn_b", (hp,), f32, const(0.0))
        self.leaf("wo", (hp, d), dtype, normal())


class RWKVCmix(Leaves):
    def __init__(self, d_model, dims: RWKVDims, dtype, device):
        super().__init__(device)
        self.leaf("mu_k", (d_model,), torch.float32, const(0.5))
        self.leaf("wk", (d_model, dims.d_ff), dtype, normal())
        self.leaf("wv", (dims.d_ff, d_model), dtype, normal())


def _shifted(x, shift):
    """[shift; x[:, :-1]] with jnp's promotion; shift None is zeros."""
    b, _, d = x.shape
    if shift is None:
        shift = x.new_zeros((b, d))
    t = torch.promote_types(shift.dtype, x.dtype)
    return torch.cat([shift[:, None, :].to(t), x[:, :-1].to(t)], dim=1)


def rwkv_tmix(p: RWKVTmix, x, dims: RWKVDims, *, state=None):
    """x: (B, S, d) → (y, new_state); state: dict(shift=(B,d), S=(B,H,P,P)).

    On a ``DeviceMesh``: the token-shift LoRAs are column-parallel and
    gathered; then each model rank runs its own heads (when they divide
    the axis) from the r/k/v/g/decay projections (column-parallel) through
    the scan and the group norm to ``wo`` (row-parallel), whose partial
    sums are all-reduced to the stream's layout. The reference hints none
    of these weights: at a batch the data axes do not divide
    (``layers.weights_stay``) no weight is gathered over ``data``, and
    each product contracts the rank's own 2-D shard
    (``layers.own_shard_mm``), its partial sums all-reduced."""
    b, s, d = x.shape
    h, hs = dims.n_heads, dims.head_size
    x_prev = _shifted(x, None if state is None else L.to_stream(
        state["shift"]))
    new_shift = x[:, -1].clone()  # a view would hold all of x
    stay = L.weights_stay(x)

    def lora_a(t, w):
        if stay:
            return L.to_stream(L.own_shard_mm(t, w, ("data", None)))
        return L.col_gathered(t, w)

    # data-dependent token-shift interpolation (Finch LoRA)
    dx = (x_prev - x).float()
    lora = L.col_gathered(torch.tanh(lora_a(x, p.mu_lora_a)), p.mu_lora_b)
    mix = p.mu[None, None].float() + L.split_last(lora, 5, d).float()
    xf = x.float()
    xr, xk, xv, xw, xg = [(xf + mix[:, :, i] * dx).to(x.dtype)
                          for i in range(5)]
    ww = torch.tanh(lora_a(xw, p.w_lora_a))
    chunked = L.OPT["mamba_recompute"] and state is None \
        and s % CHUNK == 0 and s >= 64

    split = h % L._model_axis() == 0
    hx = "model" if split else None
    xs = L.stream_spec(x)
    st = xs[:1] + [hx, None, None]
    ins = (xr, xk, xv, xg)
    if stay:        # the products on each rank's own shards, then whole
        ins = tuple(L.own_shard_mm(t, w, ("data", hx))
                    for t, w in zip(ins, (p.wr, p.wk, p.wv, p.wg)))
        cols = ()
        wo = p.wo
        wo_axes = L.local_spec(wo, (hx, "data"))
        in_axes = (xs[:-1] + [hx],) * 4
        out_spec = xs[:-1] + wo_axes[1:]
    else:
        cols = tuple(L.fsdp_use(w, None, "model")
                     for w in (p.wr, p.wk, p.wv, p.wg))
        wo = L.fsdp_use(p.wo, "model", None)
        wo_axes = (hx, None)
        in_axes = (xs,) * 4 + ((None, hx),) * 4
        out_spec = xs
    wlb = L.fsdp_use(p.w_lora_b, None, "model")
    args = (*ins, *cols, ww, wlb, p.w0, p.u, p.gn_w, p.gn_b, wo)
    axes = in_axes + (xs, (None, hx), (hx,), (hx, None), (hx,), (hx,),
                      wo_axes)
    if state is not None:
        args, axes = args + (state["S"],), axes + (st,)

    def heads(*a):
        if stay:
            (rr, kk, vv, gg), a = a[:4], a[4:]
        else:
            (xr, xk, xv, xg, wr, wk, wv, wg), a = a[:8], a[8:]
            rr, kk, vv, gg = mm(xr, wr), mm(xk, wk), mm(xv, wv), mm(xg, wg)
        ww, wlb, w0, u, gn_w, gn_b, wo, *S = a
        n = u.shape[0]

        def split_heads(t):
            return t.reshape(*t.shape[:-1], n, hs)
        rr, kk, vv = (split_heads(t).float() for t in (rr, kk, vv))
        gg = F.silu(gg)
        w = split_heads(torch.exp(-torch.exp(w0.float()
                                             + mm(ww, wlb).float())))
        S = S[0] if S else ww.new_zeros((ww.shape[0], n, hs, hs),
                                        dtype=torch.float32)
        ys, S = _scan(rr, kk, vv, w, u, S, chunked)
        ys = ys.reshape(ys.shape[0], ys.shape[1], -1)
        ys = L.group_norm_local(ys.to(x.dtype), gn_w, gn_b, hs)
        return mm(ys * gg, wo), S
    out, S = L.shard_local(heads, args, axes,
                           (L.summed(out_spec, split), st))
    new_state = None if state is None else {"shift": new_shift, "S": S}
    return L.to_stream(out), new_state


def _steps(rr, kk, vv, w, u, S):
    uu = u[None, :, :, None]                                   # (1,H,P,1)
    ys = []
    # unbind, not an index a step: an index's backward writes a zero
    # tensor of the whole sequence for every step
    for r_t, k_t, v_t, w_t in zip(*(t.unbind(1) for t in (rr, kk, vv, w))):
        kv = k_t[:, :, :, None] * v_t[:, :, None, :]           # (B,H,P,P)
        ys.append((r_t[:, :, None, :] @ (S + uu * kv))[..., 0, :])
        S = w_t[:, :, :, None] * S + kv
    return torch.stack(ys, dim=1), S                           # (B,S,H,P)


def _scan(rr, kk, vv, w, u, S, chunked):
    """The recurrence over time from ``S``: (outputs, last S); with
    ``chunked``, 16-step chunks, each recomputed in the backward (the
    first ``layers.SCAN_STEPS`` steps only, when set)."""
    n = rr.shape[1]
    run, (rr, kk, vv, w) = L.scan_prefix(n, rr, kk, vv, w)
    if not chunked:
        ys, S = _steps(rr, kk, vv, w, u, S)
        return L.zero_filled(ys, n), S
    ys = []
    for i in range(0, run, CHUNK):
        blk = tuple(t[:, i:i + CHUNK] for t in (rr, kk, vv, w)) + (u, S)
        y, S = checkpoint(_steps, *blk, use_reentrant=False) \
            if torch.is_grad_enabled() else _steps(*blk)
        ys.append(y)
    return L.zero_filled(torch.cat(ys, dim=1), n), S


def rwkv_cmix(p: RWKVCmix, x, *, state=None):
    """Squared-ReLU channel mix with token shift; ``wk`` column-parallel
    and ``wv`` row-parallel over ``model`` (``layers.tp_ffn``). At a
    batch the data axes do not divide (``layers.weights_stay``) both
    products contract each rank's own 2-D shard instead, as ``rwkv_tmix``
    does."""
    x_prev = _shifted(x, None if state is None else L.to_stream(state))
    new_shift = x[:, -1].clone()  # a view would hold all of x
    xk = x + p.mu_k.to(x.dtype) * (x_prev - x)
    if L.weights_stay(x):
        k = L.own_shard_mm(xk, p.wk, ("data", "model"))
        out = L.to_stream(L.own_shard_mm(k, p.wv, ("data", "model"),
                                         pre=_squared_relu))
    elif L.is_dtensor(x) and not torch.is_grad_enabled() \
            and _local_tokens(x) < x.shape[-1]:
        # a serving step of few tokens a rank (decode): ``wv`` is stored
        # with its columns over ``model`` (the rule of every ``wv``), so
        # it is used so, gathered over ``data`` only, and the hidden
        # activations are gathered over ``model`` instead of its rows
        # (d_ff x d/TP elements a rank moved to lay it out
        # row-parallel). A training step keeps the row-parallel form: its
        # backward would reduce the hidden activations' gradients too.
        xs = L.stream_spec(xk)
        wk = L.fsdp_use(p.wk, None, "model")
        ws = L.local_spec(wk, (None, "model"))
        k = L.shard_local(lambda xk, wk: _squared_relu(mm(xk, wk)),
                          (xk, wk), (xs, ws), xs[:-1] + ws[1:])
        out = L.col_gathered(k, p.wv)
    else:
        def body(xk, wk, wv):
            return mm(_squared_relu(mm(xk, wk)), wv)
        out = L.tp_ffn(body, xk, (p.wk,), p.wv)
    return out, (None if state is None else new_shift)


def _local_tokens(x) -> int:
    """The tokens of ``x`` (B, S, d) that one rank holds in the stream's
    layout."""
    from .sharding import mesh_axis_size
    return x.shape[0] * x.shape[1] // max(
        mesh_axis_size(x.device_mesh, L.stream_spec(x)[0]), 1)


def _squared_relu(t):
    return torch.square(F.relu(t))


def init_rwkv_state(batch, d_model, dims: RWKVDims, dtype=torch.bfloat16,
                    device="cuda"):
    dev = model_device(device)
    return {
        "tmix": {"shift": torch.zeros((batch, d_model), dtype=dtype,
                                      device=dev),
                 "S": torch.zeros((batch, dims.n_heads, dims.head_size,
                                   dims.head_size), dtype=torch.float32,
                                  device=dev)},
        "cmix_shift": torch.zeros((batch, d_model), dtype=dtype, device=dev),
    }
