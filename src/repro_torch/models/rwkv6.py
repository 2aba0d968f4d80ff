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
from .layers import Leaves, const, group_norm_heads, mm, model_device, normal

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
    """x: (B, S, d) → (y, new_state); state: dict(shift=(B,d), S=(B,H,P,P))."""
    b, s, d = x.shape
    h, hs = dims.n_heads, dims.head_size
    x_prev = _shifted(x, None if state is None else state["shift"])
    new_shift = x[:, -1]

    # data-dependent token-shift interpolation (Finch LoRA)
    dx = (x_prev - x).float()
    lora = mm(torch.tanh(mm(x, p.mu_lora_a)), p.mu_lora_b)
    mix = p.mu[None, None].float() + L.split_last(lora, 5, d).float()
    xf = x.float()
    xr, xk, xv, xw, xg = [(xf + mix[:, :, i] * dx).to(x.dtype)
                          for i in range(5)]

    rr = L.split_last(mm(xr, p.wr), h, hs).float()
    kk = L.split_last(mm(xk, p.wk), h, hs).float()
    vv = L.split_last(mm(xv, p.wv), h, hs).float()
    gg = F.silu(mm(xg, p.wg))
    w = L.split_last(torch.exp(-torch.exp(
        p.w0.float() + mm(torch.tanh(mm(xw, p.w_lora_a)), p.w_lora_b).float()
    )), h, hs)
    S = x.new_zeros((b, h, hs, hs), dtype=torch.float32) if state is None \
        else state["S"]
    chunked = L.OPT["mamba_recompute"] and state is None \
        and s % CHUNK == 0 and s >= 64
    seq = L.local_spec(rr, (("pod", "data"), None, "model", None))
    st = [seq[0], seq[2], None, None]
    def scan(rr, kk, vv, w, u, S):      # heads merged per shard
        ys, S = _scan(rr, kk, vv, w, u, S, chunked)
        return ys.reshape(ys.shape[0], ys.shape[1], -1), S
    ys, S = L.shard_local(
        scan, (rr, kk, vv, w, p.u, S),
        (seq, seq, seq, seq, (seq[2], None), st), ((seq[0], None, seq[2]),
                                                   st))
    ys = group_norm_heads(ys.to(x.dtype), p.gn_w, p.gn_b, h)
    out = mm(ys * gg, p.wo)
    new_state = None if state is None else {"shift": new_shift, "S": S}
    return out, new_state


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
    """Squared-ReLU channel mix with token shift."""
    x_prev = _shifted(x, state)
    new_shift = x[:, -1]
    xk = x + p.mu_k.to(x.dtype) * (x_prev - x)
    kk = torch.square(F.relu(mm(xk, p.wk)))
    return mm(kk, p.wv), (None if state is None else new_shift)


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
