"""Shared neural layers: norms, RoPE, GQA attention (full / chunked /
decode-with-cache), gated MLPs (port of ``repro/models/layers.py``).

Parameters live in ``nn.Module`` containers (:class:`Leaves`) named as
the reference's dict paths, in its ``(d_in, d_out)`` layout, applied as
``x @ w``. The computations are functions over those containers, as the
reference's are over dicts, and keep each of its casts: norms compute
in float32 and cast back before the weight, attention logits and the
softmax are float32, masks use ``-1e30``.

Attention stays plain PyTorch that mirrors the reference's jnp:
``_gqa_scores_full`` (no cache), ``_gqa_decode`` (a cache, ≤ 8 new
tokens) and ``chunked_attention`` (the online-softmax loop over KV
blocks, never more than one ``(q_chunk, kv_chunk)`` logits block). The
reference's GSPMD hints (``shard_hint``, ``fsdp_use``, the activation
mesh) are identity on one device and are left out.

Mixed dtypes promote as jnp promotes them (a bfloat16 model over a
float32 cache computes its attention in float32): :func:`mm` casts both
operands of a product to their common type.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.data.rawfile import resolve_device

NEG = -1e30        # the reference's mask value (not -inf)

# ------------------------------------------------------------------ #
# parameter containers and initializers
# ------------------------------------------------------------------ #
Fill = Callable[[torch.Tensor, torch.Generator], torch.Tensor]


def normal(scale: Optional[float] = None) -> Fill:
    """``dense_init``: a standard normal draw × ``scale`` (default
    ``fan_in ** -0.5`` with ``fan_in = shape[0]`` for 2-D and wider,
    as the reference counts it)."""
    def fill(t, gen):
        fan_in = t.shape[0] if t.dim() >= 2 else 1
        s = scale if scale is not None else fan_in ** -0.5
        return t.normal_(generator=gen).mul_(s)
    return fill


def const(value: float) -> Fill:
    return lambda t, gen: t.fill_(value)


class Leaves(nn.Module):
    """A module whose own parameters are declared with the way to draw
    them; :func:`reset_parameters` fills a whole tree from one
    generator, in float32, then casts to each parameter's dtype."""

    def __init__(self, device):
        super().__init__()
        self._device = device
        self._fills: Dict[str, Fill] = {}

    def leaf(self, name: str, shape, dtype: torch.dtype, fill: Fill):
        self.register_parameter(name, nn.Parameter(
            torch.empty(tuple(shape), dtype=dtype, device=self._device)))
        self._fills[name] = fill


@torch.no_grad()
def reset_parameters(root: nn.Module, gen: torch.Generator) -> None:
    for mod in root.modules():
        if not isinstance(mod, Leaves):
            continue
        for name, fill in mod._fills.items():
            p = getattr(mod, name)
            if p.dtype == torch.float32:
                fill(p.data, gen)
            else:
                p.copy_(fill(torch.empty(p.shape, dtype=torch.float32,
                                         device=p.device), gen))


def model_device(device) -> torch.device:
    """The device of an entry point: ``"meta"`` builds shapes only;
    CUDA without a card raises (pass ``device="cpu"``)."""
    if str(device) == "meta":
        return torch.device("meta")
    return resolve_device(device)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with jnp's promotion of mixed float dtypes."""
    t = torch.promote_types(a.dtype, b.dtype)
    return a.to(t) @ b.to(t)


# ------------------------------------------------------------------ #
# norms
# ------------------------------------------------------------------ #
class Norm(Leaves):
    def __init__(self, d: int, kind: str, device):
        super().__init__(device)
        self.kind = kind
        self.leaf("w", (d,), torch.float32, const(1.0))
        if kind != "rmsnorm":
            self.leaf("b", (d,), torch.float32, const(0.0))


def apply_norm(p: Norm, x):
    if p.kind == "rmsnorm":
        return rms_norm(x, p.w)
    return layer_norm(x, p.w, p.b)


def _var(xf):
    mu = xf.mean(-1, keepdim=True)
    return mu, (xf - mu).square().mean(-1, keepdim=True)


def rms_norm(x, w, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def layer_norm(x, w, b, eps=1e-5):
    xf = x.float()
    mu, var = _var(xf)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w + b).to(x.dtype)


def group_norm_heads(x, w, b, n_heads, eps=1e-5):
    """GroupNorm over per-head channels (RWKV output norm). x: (..., d)."""
    shp = x.shape
    xf = x.float().reshape(*shp[:-1], n_heads, shp[-1] // n_heads)
    mu, var = _var(xf)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf.reshape(shp) * w + b).to(x.dtype)


# ------------------------------------------------------------------ #
# RoPE
# ------------------------------------------------------------------ #
def rope_frequencies(head_dim, theta=10000.0):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x, positions, theta=10000.0):
    """x: (B, H, S, D); positions: (B, S) or (S,)."""
    d = x.shape[-1]
    freqs = torch.as_tensor(rope_frequencies(d, theta), dtype=torch.float32,
                            device=x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[:, None, :, None].float() * freqs        # B,1,S,D/2
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


# ------------------------------------------------------------------ #
# attention
# ------------------------------------------------------------------ #
@dataclasses.dataclass(frozen=True)
class AttnDims:
    n_heads: int
    n_kv_heads: int
    head_dim: int


class Attention(Leaves):
    def __init__(self, d_model: int, dims: AttnDims, dtype, device):
        super().__init__(device)
        h, hk, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim
        self.leaf("wq", (d_model, h * hd), dtype, normal())
        self.leaf("wk", (d_model, hk * hd), dtype, normal())
        self.leaf("wv", (d_model, hk * hd), dtype, normal())
        self.leaf("wo", (h * hd, d_model), dtype, normal())


def embed_lookup(table, ids):
    """The rows of ``table`` at ``ids`` (the reference's one-hot matmul
    gives the same rows)."""
    return F.embedding(ids, table)


def _scores(q, k, g):
    """(B, Hk, g·S, D) · (B, Hk, T, D)ᵀ as float32 (B, Hk, g, S, T):
    the query heads of a KV head are folded into the rows, so K is not
    repeated."""
    b, hk, t, d = k.shape
    s = q.shape[2]
    lg = mm(q.reshape(b, hk, g * s, d), k.transpose(-1, -2))
    return lg.float().reshape(b, hk, g, s, t)


def _weighted(p, v, g):
    """(B, Hk, g, S, T) probabilities · (B, Hk, T, D) → (B, Hk, g, S, D)."""
    b, hk, _, s, t = p.shape
    out = mm(p.to(v.dtype).reshape(b, hk, g * s, t), v)
    return out.reshape(b, hk, g, s, -1)


def _gqa_scores_full(q, k, v, causal, q_off=0):
    """Full-matrix GQA attention (small S only). q: (B,H,S,D), kv: (B,Hk,T,D)."""
    b, h, s, d = q.shape
    hk, t = k.shape[1], k.shape[2]
    g = h // hk
    logits = _scores(q, k, g) * d ** -0.5
    if causal:
        qpos = torch.arange(s, device=q.device) + q_off
        kpos = torch.arange(t, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        logits = torch.where(mask, logits, NEG)
    p = torch.softmax(logits, dim=-1)
    return _weighted(p, v, g).reshape(b, h, s, d)


def chunked_attention(q, k, v, *, causal=True, q_off=0, kv_len=None,
                      q_chunk=512, kv_chunk=1024):
    """Online-softmax (flash) attention over KV chunks; GQA-aware.

    q: (B, H, S, D); k, v: (B, Hkv, T, D). ``kv_len``: the valid length
    of the KV sequence (decode with a preallocated cache). Never
    materializes more than (B, Hkv, g, q_chunk, kv_chunk) logits.
    """
    b, h, s, d = q.shape
    hk, t = k.shape[1], k.shape[2]
    g = h // hk
    scale = d ** -0.5
    q = F.pad(q, (0, 0, 0, (-s) % q_chunk))
    t_pad = (-t) % kv_chunk
    if t_pad:
        k = F.pad(k, (0, 0, 0, t_pad))
        v = F.pad(v, (0, 0, 0, t_pad))
    sq, tk = q.shape[2], k.shape[2]
    valid_t = t if kv_len is None else kv_len
    dev = q.device
    ar_q = torch.arange(q_chunk, device=dev)
    ar_k = torch.arange(kv_chunk, device=dev)
    outs = []
    for qi in range(sq // q_chunk):
        qblk = q[:, :, qi * q_chunk:(qi + 1) * q_chunk]
        qpos = qi * q_chunk + ar_q + q_off
        acc = torch.zeros((b, hk, g, q_chunk, d), dtype=torch.float32,
                          device=dev)
        m = torch.full((b, hk, g, q_chunk), -math.inf, dtype=torch.float32,
                       device=dev)
        l_ = torch.zeros((b, hk, g, q_chunk), dtype=torch.float32,
                         device=dev)
        for ki in range(tk // kv_chunk):
            sl = slice(ki * kv_chunk, (ki + 1) * kv_chunk)
            kpos = ki * kv_chunk + ar_k
            lg = _scores(qblk, k[:, :, sl], g) * scale
            msk = kpos[None, :] < valid_t
            if causal:
                msk = msk & (kpos[None, :] <= qpos[:, None])
            lg = torch.where(msk, lg, NEG)
            m_new = torch.maximum(m, lg.amax(-1))
            p = torch.exp(lg - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l_ = l_ * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + _weighted(p, v[:, :, sl], g).float()
            m = m_new
        outs.append((acc / torch.clamp(l_[..., None], min=1e-30)).to(q.dtype))
    out = torch.cat(outs, dim=3).reshape(b, h, sq, d)
    return out[:, :, :s]


def _gqa_decode(q, k, v, pos, s):
    """Masked full-cache attention for small decode blocks (s ≤ 8).

    q: (B, H, s, D); k/v: (B, Hkv, T, D). Valid keys: index ≤ pos+i.
    """
    b, h, _, d = q.shape
    hk, t = k.shape[1], k.shape[2]
    g = h // hk
    logits = _scores(q, k, g) * d ** -0.5
    kpos = torch.arange(t, device=q.device)
    qpos = pos + torch.arange(s, device=q.device)
    logits = torch.where(kpos[None, :] <= qpos[:, None], logits, NEG)
    p = torch.softmax(logits, dim=-1)
    return _weighted(p, v, g).reshape(b, h, s, d)


def attention(p: Attention, x, dims: AttnDims, *, positions, causal=True,
              cache=None, cache_pos=None, rope_theta=10000.0, use_rope=True,
              kv_override=None, chunked=None, q_chunk=512, kv_chunk=1024):
    """GQA multi-head attention with optional KV cache (prefill/decode).

    cache: None | dict(k=(B,Hk,T,D), v=...). With a cache, x is the block
    of new tokens at absolute position ``cache_pos`` (a Python int); k/v
    are written into the cache IN PLACE and attention runs causally over
    the valid prefix. A block that would run past the cache's end
    raises (the reference's ``dynamic_update_slice`` clamps it instead,
    ROADMAP C.11). Returns (out, new_cache), new_cache holding the
    cache's own tensors. kv_override: (k, v) for cross-attention.
    """
    b, s, _ = x.shape
    h, hk, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim
    q = mm(x, p.wq).reshape(b, s, h, hd).transpose(1, 2)
    if kv_override is None:
        k = mm(x, p.wk).reshape(b, s, hk, hd).transpose(1, 2)
        v = mm(x, p.wv).reshape(b, s, hk, hd).transpose(1, 2)
        if use_rope:
            q = apply_rope(q, positions, rope_theta)
            k = apply_rope(k, positions, rope_theta)
    else:
        k, v = kv_override

    new_cache = None
    if cache is not None:
        pos = int(cache_pos)
        ck, cv = cache["k"], cache["v"]
        if pos < 0 or pos + s > ck.shape[2]:
            raise ValueError(f"KV cache overflow: {s} token(s) at position "
                             f"{pos} in a cache of {ck.shape[2]}")
        ck[:, :, pos:pos + s] = k
        cv[:, :, pos:pos + s] = v
        new_cache = {"k": ck, "v": cv}
        if s <= 8:
            out = _gqa_decode(q, ck, cv, pos, s)
        else:
            out = chunked_attention(q, ck, cv, causal=causal, q_off=pos,
                                    kv_len=pos + s,
                                    q_chunk=min(max(8, s), q_chunk),
                                    kv_chunk=kv_chunk)
    else:
        t = k.shape[2]
        use_chunked = chunked if chunked is not None else (s * t > 1 << 22)
        if use_chunked:
            out = chunked_attention(q, k, v, causal=causal,
                                    q_chunk=q_chunk, kv_chunk=kv_chunk)
        else:
            out = _gqa_scores_full(q, k, v, causal)
    out = out.transpose(1, 2).reshape(b, s, h * hd)
    return mm(out, p.wo), new_cache


def init_cache(batch, dims: AttnDims, max_len, dtype=torch.bfloat16,
               device="cuda"):
    dev = model_device(device)
    shape = (batch, dims.n_kv_heads, max_len, dims.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


# ------------------------------------------------------------------ #
# MLPs
# ------------------------------------------------------------------ #
def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class MLP(Leaves):
    def __init__(self, d_model, d_ff, kind, dtype, device):
        super().__init__(device)
        self.kind = kind
        self.leaf("wi", (d_model, d_ff), dtype, normal())
        if kind in ("swiglu", "geglu"):
            self.leaf("wg", (d_model, d_ff), dtype, normal())
        self.leaf("wo", (d_ff, d_model), dtype, normal())


def init_mlp(d_model, d_ff, kind, dtype, device="cuda", gen=None) -> MLP:
    """An :class:`MLP` on ``device``, drawn from ``gen`` when given."""
    m = MLP(d_model, d_ff, kind, dtype, model_device(device))
    if gen is not None:
        reset_parameters(m, gen)
    return m


def mlp(p: MLP, x, kind):
    if kind in ("swiglu", "geglu"):
        act = F.silu if kind == "swiglu" else gelu
        return mm(act(mm(x, p.wg)) * mm(x, p.wi), p.wo)
    return mm(gelu(mm(x, p.wi)), p.wo)
