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
    sums are all-reduced to the stream's layout."""
    b, s, d = x.shape
    h, hs = dims.n_heads, dims.head_size
    x_prev = _shifted(x, None if state is None else L.to_stream(
        state["shift"]))
    new_shift = x[:, -1]

    # data-dependent token-shift interpolation (Finch LoRA)
    dx = (x_prev - x).float()
    lora = L.col_gathered(torch.tanh(L.col_gathered(x, p.mu_lora_a)),
                          p.mu_lora_b)
    mix = p.mu[None, None].float() + L.split_last(lora, 5, d).float()
    xf = x.float()
    xr, xk, xv, xw, xg = [(xf + mix[:, :, i] * dx).to(x.dtype)
                          for i in range(5)]
    ww = torch.tanh(L.col_gathered(xw, p.w_lora_a))
    chunked = L.OPT["mamba_recompute"] and state is None \
        and s % CHUNK == 0 and s >= 64

    split = h % L._model_axis() == 0
    hx = "model" if split else None
    xs = L.stream_spec(x)
    st = xs[:1] + [hx, None, None]
    cols = [L.fsdp_use(w, None, "model")
            for w in (p.wr, p.wk, p.wv, p.wg, p.w_lora_b)]
    wo = L.fsdp_use(p.wo, "model", None)
    args = (xr, xk, xv, xg, ww, *cols, p.w0, p.u, p.gn_w, p.gn_b, wo)
    axes = (xs,) * 5 + ((None, hx),) * 5 + ((hx,), (hx, None), (hx,),
                                             (hx,), (hx, None))
    if state is not None:
        args, axes = args + (state["S"],), axes + (st,)

    def heads(xr, xk, xv, xg, ww, wr, wk, wv, wg, wlb, w0, u, gn_w, gn_b,
              wo, S=None):
        n = u.shape[0]

        def split_heads(t):
            return t.reshape(*t.shape[:-1], n, hs)
        rr = split_heads(mm(xr, wr)).float()
        kk = split_heads(mm(xk, wk)).float()
        vv = split_heads(mm(xv, wv)).float()
        gg = F.silu(mm(xg, wg))
        w = split_heads(torch.exp(-torch.exp(w0.float()
                                             + mm(ww, wlb).float())))
        if S is None:
            S = xr.new_zeros((xr.shape[0], n, hs, hs), dtype=torch.float32)
        ys, S = _scan(rr, kk, vv, w, u, S, chunked)
        ys = ys.reshape(ys.shape[0], ys.shape[1], -1)
        ys = L.group_norm_local(ys.to(xr.dtype), gn_w, gn_b, hs)
        return mm(ys * gg, wo), S
    out, S = L.shard_local(heads, args, axes, (L.summed(xs, split), st))
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
    and ``wv`` row-parallel over ``model`` (``layers.tp_ffn``)."""
    x_prev = _shifted(x, None if state is None else L.to_stream(state))
    new_shift = x[:, -1]
    xk = x + p.mu_k.to(x.dtype) * (x_prev - x)

    def body(xk, wk, wv):
        return mm(torch.square(F.relu(mm(xk, wk))), wv)
    return L.tp_ffn(body, xk, (p.wk,), p.wv), \
        (None if state is None else new_shift)


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
