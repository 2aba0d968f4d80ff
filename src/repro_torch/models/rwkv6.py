"""RWKV-6 "Finch" block: attention-free time mixing with data-dependent
per-channel decay (arXiv:2404.05892; port of ``repro/models/rwkv6.py``).

Per head (head size P): state S ∈ R^{P×P};
    S_t = diag(w_t) · S_{t-1} + k_t^T v_t
    o_t = r_t · (S_{t-1} + diag(u) k_t^T v_t)
with w_t = exp(−exp(w0 + LoRA_w(x̃_t))) data-dependent. Token-shift
interpolation coefficients are also data-dependent via small LoRAs.

One sequential scan over time carries S (B, H, P, P) in float32; the
reference's 16-step chunked form (no state, ``s >= 64``) is a
rematerialisation for the TPU's backward with the same forward. Decode
is O(1): one state update per token. Channel mixing is the RWKV
squared-ReLU FFN.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .layers import Leaves, const, group_norm_heads, mm, model_device, normal


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
    mix = p.mu[None, None].float() + lora.reshape(b, s, 5, d).float()
    xf = x.float()
    xr, xk, xv, xw, xg = [(xf + mix[:, :, i] * dx).to(x.dtype)
                          for i in range(5)]

    rr = mm(xr, p.wr).reshape(b, s, h, hs).float()
    kk = mm(xk, p.wk).reshape(b, s, h, hs).float()
    vv = mm(xv, p.wv).reshape(b, s, h, hs).float()
    gg = F.silu(mm(xg, p.wg))
    w = torch.exp(-torch.exp(
        p.w0.float() + mm(torch.tanh(mm(xw, p.w_lora_a)), p.w_lora_b).float()
    )).reshape(b, s, h, hs)
    uu = p.u[None, :, :, None]                                 # (1,H,P,1)

    S = x.new_zeros((b, h, hs, hs), dtype=torch.float32) if state is None \
        else state["S"]
    ys = []
    for t in range(s):
        kv = kk[:, t, :, :, None] * vv[:, t, :, None, :]       # (B,H,P,P)
        ys.append((rr[:, t, :, None, :] @ (S + uu * kv))[..., 0, :])
        S = w[:, t, :, :, None] * S + kv
    ys = torch.stack(ys, dim=1).reshape(b, s, h * hs)
    ys = group_norm_heads(ys.to(x.dtype), p.gn_w, p.gn_b, h)
    out = mm(ys * gg, p.wo)
    new_state = None if state is None else {"shift": new_shift, "S": S}
    return out, new_state


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
