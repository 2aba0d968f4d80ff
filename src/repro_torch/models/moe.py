"""Mixture-of-Experts FFN with sort-based (gather/scatter) token dispatch
(port of ``repro/models/moe.py``).

  1. top-k gates per token → N·k (token, expert, gate) assignments;
  2. stable-sort assignments by expert; each expert's assignments form a
     contiguous run; position-in-run = index − run start (searchsorted);
  3. keep positions < capacity C, giving each kept assignment a unique
     slot in an (E·C, d) buffer (+1 overflow row for drops);
  4. gather tokens → batched expert FFN over (E, C, d);
  5. scatter-add expert outputs × gates back to tokens (``index_add_``).

Router: softmax gating with top-k renormalization + the Switch auxiliary
load-balancing loss.

``moe_ffn`` dispatches as the reference does: a bound mesh
(``layers.activation_mesh_scope``) whose ``model`` axis is larger than 1
and divides E takes :func:`moe_ffn_sharded`, expert parallelism with
local dispatch; anything else the single-device path. On a
``DeviceMesh`` the single-device path runs gathered (DTensor has no
sharding rule for ``topk``, ``sort``, ``searchsorted``, the slot writes
or ``index_add_``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.mesh import axis_sizes
from . import layers as L
from .layers import (Leaves, gelu, mm, model_device, normal,
                     reset_parameters)

_EXPERT_LEAVES = ("router", "wi", "wg", "wo")


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
    """x: (B, S, d) → (out (B, S, d), aux_loss scalar).

    A bound mesh with a ``model`` axis dividing E (and larger than 1)
    takes :func:`moe_ffn_sharded`; otherwise the single-device path."""
    mesh = L._ACT_MESH
    sizes = axis_sizes(mesh) if mesh is not None else {}
    if "model" in sizes and dims.n_experts % sizes["model"] == 0 \
            and sizes["model"] > 1:
        return moe_ffn_sharded(p, x, dims, mesh)
    return _moe_ffn_local(p, x, dims)


def _weights(p: MoE):
    return tuple(getattr(p, n) if hasattr(p, n) else None
                 for n in _EXPERT_LEAVES)


def _moe_ffn_local(p: MoE, x, dims: MoEDims):
    b, s, d = x.shape
    router, wi, wg, wo = _weights(p)
    args = (x, router, wi, wo) + ((wg,) if wg is not None else ())

    def local(x, router, wi, wo, wg=None):
        n = b * s
        out, aux = _expert_shard(x.reshape(n, d), router, wi, wg, wo,
                                 dims, 0, dims.n_experts,
                                 capacity(n, dims))
        return out.reshape(b, s, d), aux

    out, aux = L.gathered(local, *args)
    if dims.n_shared:
        out = out + _shared(p, x)
    return out, aux


def _shared(p: MoE, x):
    """The shared experts: a dense gated MLP over every token (rows kept
    batch-sharded, the weights used as ``layers.mlp`` uses its own)."""
    b, s, d = x.shape
    dp = ("pod", "data")
    xt = L.shard_hint(x.reshape(b * s, d), dp, None)
    h = F.silu(mm(xt, L.fsdp_use(p.shared_wg, None, "model"))) * \
        mm(xt, L.fsdp_use(p.shared_wi, None, "model"))
    out = mm(h, L.fsdp_use(p.shared_wo, "model", None))
    return L.shard_hint(out, dp, None).reshape(b, s, d)


def _expert_shard(xt, router, wi, wg, wo, dims: MoEDims, e_base: int,
                  e_loc: int, c: int):
    """One shard's part of the MoE FFN over its tokens ``xt`` (N, d):
    routing over all E experts and the Switch aux loss of these tokens,
    then the sort-based dispatch of the assignments to experts
    ``[e_base, e_base + e_loc)`` (whose weights ``wi``/``wg``/``wo``
    are given, full width) at capacity ``c`` each, their FFN, and the
    gated combine. Returns (this shard's part of the output (N, d), aux).
    The single-device path is the one shard holding all E experts."""
    n, d = xt.shape
    e, k = dims.n_experts, dims.top_k
    dev = xt.device

    probs = torch.softmax(xt.float() @ router, dim=-1)           # (N, E)
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
    if e_loc != e:          # only this shard's experts
        keep &= (e_sorted >= e_base) & (e_sorted < e_base + e_loc)
    slot = torch.where(keep, (e_sorted - e_base) * c + pos, e_loc * c)

    buf = torch.zeros((e_loc * c + 1, d), dtype=xt.dtype, device=dev)
    buf[slot] = xt[t_sorted]
    h_in = buf[:e_loc * c].reshape(e_loc, c, d)

    if wg is not None:
        act = F.silu if dims.mlp_kind == "swiglu" else gelu
        hmid = act(mm(h_in, wg)) * mm(h_in, wi)
    else:
        hmid = gelu(mm(h_in, wi))
    h_out = mm(hmid, wo)

    flat_out = torch.cat([h_out.reshape(e_loc * c, d),
                          h_out.new_zeros((1, d))], dim=0)
    contrib = flat_out[slot] * g_sorted[:, None].to(h_out.dtype)
    contrib = torch.where(keep[:, None], contrib, 0).to(xt.dtype)
    out = torch.zeros((n, d), dtype=xt.dtype, device=dev).index_add_(
        0, t_sorted, contrib)
    return out, aux


def expert_loads(p: MoE, x, dims: MoEDims, n_shards: int = 1):
    """The largest number of assignments any expert gets from one of
    ``n_shards`` equal batch shards of ``x`` (B, S, d): capacity must be
    at least this for no token to drop."""
    worst = 0
    for xs in x.chunk(n_shards, dim=0):
        xt = xs.reshape(-1, xs.shape[-1])
        idx = torch.topk(torch.softmax(xt.float() @ p.router, dim=-1),
                         dims.top_k, dim=-1)[1]
        worst = max(worst, int(torch.bincount(
            idx.reshape(-1), minlength=dims.n_experts).max()))
    return worst


# ------------------------------------------------------------------ #
# explicit expert-parallel dispatch
# ------------------------------------------------------------------ #
def moe_ffn_sharded(p: MoE, x, dims: MoEDims, mesh
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism with *local* dispatch.

    Activations are sharded over the ``data`` axes and replicated over
    ``model``; expert weights are sharded over ``model`` (E_loc = E/TP
    experts a model rank). So every (data i, model j) shard already holds
    the tokens of data shard i and the weights of expert group j:
    dispatch moves no token. Each shard routes its tokens, sort-selects
    those routed to its experts, runs their FFN (after the FSDP
    all-gather of the expert weights over ``data``), and the per-token
    combine is a sum over ``model``; the aux loss is averaged over the
    data axes. The shard's body is :func:`_expert_shard`, at the
    capacity of its own tokens.

    ``mesh`` is a ``core.mesh.NamedMesh`` (the shards looped in this
    process on views, reduced in shard order; autograd differentiates
    the loop) or a ``DeviceMesh`` (each rank its own shard; the gather
    and the combine are DTensor redistributions, which run NCCL's (or
    gloo's) all-gather and all-reduce, and the gradients are declared
    partial where a rank sees part of the tokens)."""
    if L._is_device_mesh(mesh):
        out, aux = _sharded_ranks(p, x, dims, mesh)
    else:
        out, aux = _sharded_in_process(p, x, dims, mesh)
    if dims.n_shared:
        out = out + _shared(p, x)
    return out, aux


def _layout(x, dims: MoEDims, mesh):
    sizes = axis_sizes(mesh)
    tp = sizes["model"]
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    dp_size = int(np.prod([sizes[a] for a in dp])) if dp else 1
    batch_ok = bool(dp) and x.shape[0] % max(dp_size, 1) == 0
    fsdp = "data" in sizes and x.shape[-1] % sizes["data"] == 0
    return tp, dims.n_experts // tp, dp, batch_ok, fsdp


def _sharded_in_process(p: MoE, x, dims: MoEDims, mesh):
    b, s, d = x.shape
    tp, e_loc, dp, batch_ok, fsdp = _layout(x, dims, mesh)
    router, wi, wg, wo = _weights(p)
    bspec = (dp if batch_ok else None, None, None)
    names = mesh.axis_names
    di = names.index("data") if "data" in names else None
    outs, auxs = {}, {}
    for coord in mesh.coords():
        x_loc = mesh.local(x, bspec, coord)
        bl = x_loc.shape[0]

        def gather(w, dim):
            # ZeRO-3: this expert group's weights, all-gathered over data
            if w is None or not fsdp:
                return None if w is None else \
                    mesh.local(w, ("model", None, None), coord)
            spec = ("model",) + tuple("data" if i == dim else None
                                      for i in (1, 2))
            return torch.cat(
                [mesh.local(w, spec, coord[:di] + (i,) + coord[di + 1:])
                 for i in range(mesh.shape["data"])], dim)
        j, _ = mesh.index(coord, "model")
        out, aux = _expert_shard(
            x_loc.reshape(bl * s, d), router, gather(wi, 1), gather(wg, 1),
            gather(wo, 2), dims, j * e_loc, e_loc, capacity(bl * s, dims))
        outs[coord], auxs[coord] = out.reshape(bl, s, d), aux
    outs = mesh.reduce(outs, "model", "sum")          # combine owners
    if dp:
        auxs = mesh.reduce(auxs, dp, "mean")
    first = mesh.coords()[0]
    if not batch_ok:
        return outs[first], auxs[first]
    pieces = {}
    for coord in mesh.coords():
        pieces.setdefault(mesh.index(coord, dp)[0], outs[coord])
    return torch.cat([pieces[i] for i in sorted(pieces)], 0), auxs[first]


def _sharded_ranks(p: MoE, x, dims: MoEDims, mesh):
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)
    b, s, d = x.shape
    tp, e_loc, dp, batch_ok, fsdp = _layout(x, dims, mesh)
    names = mesh.mesh_dim_names
    # the gradient of what a rank computes from its own tokens is a
    # partial sum over the data axes (the tokens' shards), over
    # ``model`` too for what every model rank uses (its experts' part)
    part = Partial() if batch_ok else Replicate()
    x_pl = [Shard(0) if a in dp and batch_ok else Replicate()
            for a in names]
    x_grad = [Shard(0) if a in dp and batch_ok else Partial()
              if a == "model" else Replicate() for a in names]
    w_pl = [Shard(0) if a == "model" else Replicate() for a in names]
    w_grad = [Shard(0) if a == "model" else part if a in dp
              else Replicate() for a in names]
    r_grad = [Partial() if a == "model" else part if a in dp
              else Replicate() for a in names]

    def local(t, pl, grad):
        if t is None:
            return None
        if not L.is_dtensor(t):
            t = distribute_tensor(t, mesh, [Replicate()] * len(names))
        return t.redistribute(mesh, pl).to_local(grad_placements=grad)

    router, wi, wg, wo = _weights(p)
    x_loc = local(x, x_pl, x_grad)
    bl = x_loc.shape[0]
    j = mesh.get_local_rank("model")
    out, aux = _expert_shard(
        x_loc.reshape(bl * s, d),
        local(router, [Replicate()] * len(names), r_grad),
        local(wi, w_pl, w_grad), local(wg, w_pl, w_grad),
        local(wo, w_pl, w_grad), dims, j * e_loc, e_loc,
        capacity(bl * s, dims))
    rep = [Replicate()] * len(names)
    out = DTensor.from_local(
        out.reshape(bl, s, d), mesh,
        [Partial() if a == "model" else x_pl[i]
         for i, a in enumerate(names)], run_check=False)
    out = out.redistribute(mesh, x_pl)                 # combine owners
    # every model rank of a data shard holds the same aux: the mean over
    # the data shards is the sum over model and data of aux / (TP · DP)
    # (a partial sum: DTensor's backward of a partial mean is unscaled)
    dp_size = int(np.prod([mesh.size(names.index(a)) for a in dp])) \
        if batch_ok else 1
    aux = DTensor.from_local(
        aux / (tp * dp_size), mesh,
        [Partial() if a == "model" or a in dp and batch_ok else Replicate()
         for a in names], run_check=False).redistribute(mesh, rep)
    return out, aux


