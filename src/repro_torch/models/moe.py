"""Mixture-of-Experts FFN with sort-based (gather/scatter) token dispatch
(port of ``repro/models/moe.py``'s single-device path).

  1. top-k gates per token → N·k (token, expert, gate) assignments;
  2. stable-sort assignments by expert; each expert's assignments form a
     contiguous run; position-in-run = index − run start (searchsorted);
  3. keep positions < capacity C, giving each kept assignment a unique
     slot in an (E·C, d) buffer (+1 overflow row for drops);
  4. gather tokens → batched expert FFN over (E, C, d);
  5. scatter-add expert outputs × gates back to tokens (``index_add_``).

Router: softmax gating with top-k renormalization + the Switch auxiliary
load-balancing loss. ``moe_ffn`` always takes the local path, as the
reference does with no mesh bound; its expert-parallel form
(``moe_ffn_sharded``) comes with the shard meshes.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from .layers import (Leaves, gelu, mm, model_device, normal,
                     reset_parameters)


@dataclasses.dataclass(frozen=True)
class MoEDims:
    n_experts: int
    top_k: int
    d_expert: int           # per-expert FFN hidden size
    n_shared: int = 0       # always-on shared experts (deepseek)
    capacity_factor: float = 1.25
    mlp_kind: str = "swiglu"


class MoE(Leaves):
    def __init__(self, d_model, dims: MoEDims, dtype, device):
        super().__init__(device)
        e, h = dims.n_experts, dims.d_expert
        self.leaf("router", (d_model, e), torch.float32, normal(0.02))
        self.leaf("wi", (e, d_model, h), dtype, normal())
        self.leaf("wo", (e, h, d_model), dtype, normal())
        if dims.mlp_kind in ("swiglu", "geglu"):
            self.leaf("wg", (e, d_model, h), dtype, normal())
        if dims.n_shared:
            hs = dims.n_shared * h
            self.leaf("shared_wi", (d_model, hs), dtype, normal())
            self.leaf("shared_wg", (d_model, hs), dtype, normal())
            self.leaf("shared_wo", (hs, d_model), dtype, normal())


def init_moe(d_model, dims: MoEDims, dtype, device="cuda", gen=None) -> MoE:
    m = MoE(d_model, dims, dtype, model_device(device))
    if gen is not None:
        reset_parameters(m, gen)
    return m


def capacity(n_tokens: int, dims: MoEDims) -> int:
    c = int(n_tokens * dims.top_k * dims.capacity_factor / dims.n_experts)
    return max(8, ((c + 7) // 8) * 8)


def moe_ffn(p: MoE, x, dims: MoEDims) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) → (out (B, S, d), aux_loss scalar)."""
    return _moe_ffn_local(p, x, dims)


def _moe_ffn_local(p: MoE, x, dims: MoEDims):
    b, s, d = x.shape
    n = b * s
    e, k = dims.n_experts, dims.top_k
    c = capacity(n, dims)
    dev = x.device
    xt = x.reshape(n, d)

    probs = torch.softmax(xt.float() @ p.router, dim=-1)         # (N, E)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)             # (N, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    me = probs.mean(0)
    ce = torch.zeros(e, dtype=torch.float32, device=dev).index_add_(
        0, gate_idx.reshape(-1),
        torch.ones(n * k, dtype=torch.float32, device=dev)) / (n * k)
    aux = e * (me * ce).sum()

    e_flat = gate_idx.reshape(-1)
    t_flat = torch.arange(n, device=dev).repeat_interleave(k)
    g_flat = gate_vals.reshape(-1)
    e_sorted, order = torch.sort(e_flat, stable=True)
    t_sorted = t_flat[order]
    g_sorted = g_flat[order]
    run_start = torch.searchsorted(e_sorted, torch.arange(e, device=dev),
                                   right=False)
    pos = torch.arange(n * k, device=dev) - run_start[e_sorted]
    keep = pos < c
    slot = torch.where(keep, e_sorted * c + pos, e * c)           # overflow

    buf = torch.zeros((e * c + 1, d), dtype=x.dtype, device=dev)
    buf[slot] = xt[t_sorted]
    h_in = buf[:e * c].reshape(e, c, d)

    if hasattr(p, "wg"):
        act = F.silu if dims.mlp_kind == "swiglu" else gelu
        hmid = act(mm(h_in, p.wg)) * mm(h_in, p.wi)
    else:
        hmid = gelu(mm(h_in, p.wi))
    h_out = mm(hmid, p.wo)

    flat_out = torch.cat([h_out.reshape(e * c, d),
                          h_out.new_zeros((1, d))], dim=0)
    contrib = flat_out[slot] * g_sorted[:, None].to(h_out.dtype)
    contrib = torch.where(keep[:, None], contrib, 0).to(x.dtype)
    out = torch.zeros((n, d), dtype=x.dtype, device=dev).index_add_(
        0, t_sorted, contrib)

    if dims.n_shared:
        shared = mm(F.silu(mm(xt, p.shared_wg)) * mm(xt, p.shared_wi),
                    p.shared_wo)
        out = out + shared
    return out.reshape(b, s, d), aux

