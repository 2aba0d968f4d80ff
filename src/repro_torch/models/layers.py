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
blocks, never more than one ``(q_chunk, kv_chunk)`` logits block).

Sharding hints. The reference's model code stays mesh-agnostic: the
launcher binds a mesh with :func:`activation_mesh_scope` and a few use
sites pin a layout with :func:`shard_hint` (batch over the data axes,
one channel-like dim over ``model``) or :func:`fsdp_use` (gather a
ZeRO-sharded weight over ``data`` for its product). Here each hint is
the identity on a plain tensor or with no mesh bound — the in-process
``NamedMesh`` holds every shard of a plain tensor, so a layout is
nothing to pin — and on a DTensor it redistributes to the hinted
placements on its ``DeviceMesh``, dropping axes absent from the mesh or
not dividing the dim, as the reference does; it never raises. Binding a
``DeviceMesh`` also lets plain tensors (masks, RoPE tables) meet
DTensors as replicated operands. Where DTensor has no sharding rule for
an op on the model's path, the op runs under :func:`gathered`: its
operands redistributed to ``Replicate`` (what GSPMD does there), its
results replicated DTensors.

``OPT`` holds the reference's four toggles with its defaults:
``fsdp_use_hint`` (the hint above), ``mamba_recompute`` (the scans'
16-step chunks under ``torch.utils.checkpoint``, ``mamba.py`` and
``rwkv6.py``), ``remat_dots`` (remat saves the products' outputs,
``model.py``) and ``attn_repeat_k`` (full attention repeats K/V to all
heads when the heads divide the ``model`` axis and the KV heads do not).

Mixed dtypes promote as jnp promotes them (a bfloat16 model over a
float32 cache computes its attention in float32): :func:`mm` casts both
operands of a product to their common type.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.mesh import axis_sizes
from repro_torch.data.rawfile import resolve_device

NEG = -1e30        # the reference's mask value (not -inf)

# ------------------------------------------------------------------ #
# activation sharding hints
# ------------------------------------------------------------------ #
_ACT_MESH = None


def _is_device_mesh(mesh) -> bool:
    return getattr(mesh, "mesh_dim_names", None) is not None


def is_dtensor(x) -> bool:
    if type(x) in (torch.Tensor, nn.Parameter) and \
            type(getattr(x, "data", x)) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


@contextlib.contextmanager
def activation_mesh_scope(mesh):
    """Bind ``mesh`` (any of ``core.mesh``'s forms, or a ``DeviceMesh``)
    for the hints and ``moe_ffn``'s dispatch while the block runs."""
    global _ACT_MESH
    prev = _ACT_MESH
    _ACT_MESH = mesh
    try:
        if _is_device_mesh(mesh):
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield
        else:
            yield
    finally:
        _ACT_MESH = prev


# §Perf hillclimb toggles of the reference (its production defaults).
OPT = {"fsdp_use_hint": True, "mamba_recompute": True,
       "remat_dots": False, "attn_repeat_k": False}


# The dry run's trip count (``launch.dryrun``): with an int, a time scan
# (``mamba.py``, ``rwkv6.py``) runs only its first ``SCAN_STEPS`` steps and
# leaves the rest of its outputs zero. A step costs the same at every
# step, so the dry run runs two counts and extrapolates to the whole
# sequence, as the reference's HLO analysis multiplies a loop body by its
# trip count. None (the default) runs every step.
SCAN_STEPS = None


def scan_prefix(n: int, *seqs):
    """The first ``SCAN_STEPS`` steps (dim 1) of each of ``seqs`` (all of
    them with no count set): ``(steps run, the views)``."""
    run = n if SCAN_STEPS is None else min(n, SCAN_STEPS)
    if run == n:
        return n, seqs
    return run, tuple(t[:, :run] for t in seqs)


def zero_filled(ys, n: int):
    """``ys`` (steps on dim 1) with zero steps after it up to ``n``."""
    if ys.shape[1] == n:
        return ys
    pad = ys.new_zeros((ys.shape[0], n - ys.shape[1], *ys.shape[2:]))
    return torch.cat([ys, pad], dim=1)


def fsdp_use(w, *tp_axes):
    """Use-site hint for a ZeRO/FSDP-sharded weight: gather over data,
    keep only the TP sharding for this use (``tp_axes``, e.g.
    ``fsdp_use(wi, None, "model")``)."""
    if _ACT_MESH is None or not OPT["fsdp_use_hint"]:
        return w
    axes = tp_axes if len(tp_axes) == w.dim() \
        else (None,) * (w.dim() - len(tp_axes)) + tuple(tp_axes)
    return shard_hint(w, *axes)


def shard_hint(x, *axes):
    """Pin ``x``'s layout; axis entries are mesh-axis names, tuples of
    them, or None. Drops axes absent from the mesh or not dividing the
    dim (the hint degrades to replication, never errors). The identity
    with no mesh bound or on a plain tensor."""
    if _ACT_MESH is None or not is_dtensor(x):
        return x
    from .sharding import placements
    mesh = x.device_mesh
    want = placements(_spec(mesh, x.shape, axes), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def _spec(mesh, shape, axes):
    """``axes`` without the axes absent from ``mesh`` or not dividing
    their dim (``shard_hint``'s rule)."""
    sizes = axis_sizes(mesh)
    spec = []
    for dim, ax in zip(shape, axes):
        names = ax if isinstance(ax, tuple) else (ax,) if ax else ()
        names = tuple(a for a in names if a in sizes)
        if not names:
            spec.append(None)
            continue
        size = int(np.prod([sizes[a] for a in names]))
        keep = names if len(names) > 1 else names[0]
        spec.append(keep if size and dim % size == 0 else None)
    return spec + [None] * (len(shape) - len(spec))


def _hint_model_dim(x, priority):
    """shard_hint: batch (dim 0) over dp + 'model' on the first divisible
    dim in ``priority`` (batch-only hint if none divides)."""
    mesh = _ACT_MESH
    if mesh is None or "model" not in axis_sizes(mesh):
        return x
    tp = axis_sizes(mesh)["model"]
    axes = [None] * x.dim()
    axes[0] = ("pod", "data")
    for i in priority:
        if x.shape[i] % tp == 0 and x.shape[i] >= tp:
            axes[i] = "model"
            break
    return shard_hint(x, *axes)


def _model_axis() -> int:
    """The bound mesh's ``model`` size (1 with none bound)."""
    return axis_sizes(_ACT_MESH).get("model", 1) \
        if _ACT_MESH is not None else 1


def shard_local(fn, args, in_axes, out_axes):
    """``shard_map``'s counterpart on a ``DeviceMesh``: with a DTensor
    among ``args``, each tensor arg redistributed to its ``in_axes``
    (one entry a dim: None, an axis name or a tuple; sanitized as
    ``shard_hint`` sanitizes) and taken local, ``fn`` run on the local
    shards, and each tensor it returns made a DTensor with its
    ``out_axes`` entry (taken as given: the caller derives it from the
    inputs' sanitized specs, :func:`local_spec`; None replicates every
    output). Autograd flows through both conversions; as in
    ``shard_map``'s transpose, an operand replicated over a mesh axis that
    another operand is sharded over gets a gradient that is partial
    there (summed over that axis). A plain call on plain tensors."""
    mesh = next((a.device_mesh for a in args if is_dtensor(a)), None)
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, distribute_tensor

    from .sharding import placements

    pls = [placements(_spec(mesh, a.shape, ax), mesh)
           if isinstance(a, torch.Tensor) else None
           for a, ax in zip(args, in_axes)]
    split = [any(pl is not None and pl[d].is_shard() for pl in pls)
             for d in range(mesh.ndim)]

    def local(a, pl):
        if pl is None:
            return a
        if not is_dtensor(a):
            a = distribute_tensor(a, mesh, pl, src_data_rank=None)
        grad = [Partial() if split[d] and p.is_replicate() else p
                for d, p in enumerate(pl)]
        return a.redistribute(mesh, pl).to_local(grad_placements=grad)

    out = fn(*(local(a, pl) for a, pl in zip(args, pls)))
    single = not isinstance(out, tuple)
    outs = (out,) if single else out
    axes = ((),) * len(outs) if out_axes is None \
        else (out_axes,) if single else out_axes
    wrapped = tuple(
        DTensor.from_local(o, mesh, placements(ax, mesh), run_check=False)
        if isinstance(o, torch.Tensor) else o for o, ax in zip(outs, axes))
    return wrapped[0] if single else wrapped


def local_spec(x, axes):
    """The sanitized spec ``shard_local`` gives ``x`` for ``axes`` under
    the bound mesh (all None with none bound)."""
    if _ACT_MESH is None:
        return [None] * x.dim()
    return _spec(_ACT_MESH, x.shape, axes)


def gathered(fn, *args):
    """``fn(*args)`` where DTensor has no sharding rule for its ops: with
    a DTensor among ``args``, each tensor redistributed to ``Replicate``
    and taken local, and each tensor ``fn`` returns a replicated DTensor
    (``shard_local`` with every axis None). A plain call on plain
    tensors."""
    return shard_local(fn, args, [()] * len(args), None)


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


def _mean_last(t):
    """The mean over the last dim, kept. On a DTensor it is the sum over
    ``n``: a sum over a sharded dim is ``Partial("sum")``, the placement
    the backward's gradients come in, where ``mean`` would make a
    ``Partial("avg")`` that no ``Partial("sum")`` gradient may be
    redistributed to (ROADMAP C.15c)."""
    if is_dtensor(t):
        return t.sum(-1, keepdim=True) / t.shape[-1]
    return t.mean(-1, keepdim=True)


def _var(xf):
    mu = _mean_last(xf)
    return mu, _mean_last((xf - mu).square())


def rms_norm(x, w, eps=1e-6):
    xf = x.float()
    var = _mean_last(xf.square())
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def layer_norm(x, w, b, eps=1e-5):
    xf = x.float()
    mu, var = _var(xf)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w + b).to(x.dtype)


def group_norm_heads(x, w, b, n_heads, eps=1e-5):
    """GroupNorm over per-head channels (RWKV output norm). x: (..., d).
    On a DeviceMesh it runs per shard, whole heads over ``model`` when
    they divide it, else gathered (a head split or merged across
    shards has no DTensor view, ROADMAP C.17)."""
    hs = x.shape[-1] // n_heads
    ax = "model" if n_heads % _model_axis() == 0 else None
    spec = local_spec(x, (("pod", "data"),) + (None,) * (x.dim() - 2)
                      + (ax,))

    def norm(x, w, b):
        shp = x.shape
        xf = x.float().reshape(*shp[:-1], shp[-1] // hs, hs)
        mu, var = _var(xf)
        xf = (xf - mu) * torch.rsqrt(var + eps)
        return (xf.reshape(shp) * w + b).to(x.dtype)
    return shard_local(norm, (x, w, b), (spec, spec[-1:], spec[-1:]), spec)


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
    gives the same rows), batch-sharded."""
    return shard_hint(F.embedding(ids, table), ("pod", "data"), None, None)


def _scores(q, k, g):
    """(B, Hk, g·S, D) · (B, Hk, T, D)ᵀ as float32 (B, Hk, g, S, T):
    the query heads of a KV head are folded into the rows, so K is not
    repeated."""
    b, hk, t, d = k.shape
    s = q.shape[2]
    q, k = _hint_model_dim(q, (1,)), _hint_model_dim(k, (1,))
    if hk % _model_axis():      # a DTensor's heads cannot fold here
        q = shard_hint(q, ("pod", "data"), None, None, None)
    lg = mm(q.reshape(b, hk, g * s, d), k.transpose(-1, -2))
    return lg.float().reshape(b, hk, g, s, t)


def _weighted(p, v, g):
    """(B, Hk, g, S, T) probabilities · (B, Hk, T, D) → (B, Hk, g, S, D)."""
    b, hk, _, s, t = p.shape
    p, v = _hint_model_dim(p, (1,)), _hint_model_dim(v, (1,))
    out = mm(p.to(v.dtype).reshape(b, hk, g * s, t), v)
    return out.reshape(b, hk, g, s, -1)


def _causal(logits, s, t, q_off, device):
    qpos = torch.arange(s, device=device) + q_off
    kpos = torch.arange(t, device=device)
    return torch.where(kpos[None, :] <= qpos[:, None], logits, NEG)


def _gqa_scores_full(q, k, v, causal, q_off=0):
    """Full-matrix GQA attention (small S only). q: (B,H,S,D), kv: (B,Hk,T,D).

    Sharding of the score tensor, as the reference's: with
    ``OPT["attn_repeat_k"]``, heads dividing the ``model`` axis and KV
    heads not, K/V are repeated to all H heads and the (B,H,S,T) scores
    shard on H; otherwise the grouped (B,Hk,G,S,T) scores shard Hk, G or
    S over ``model``, the first that divides."""
    b, h, s, d = q.shape
    hk, t = k.shape[1], k.shape[2]
    g = h // hk
    tp = _model_axis()
    if OPT["attn_repeat_k"] and tp > 1 and h % tp == 0 and hk % tp != 0:
        kr = k.repeat_interleave(g, dim=1)
        vr = v.repeat_interleave(g, dim=1)
        dp = ("pod", "data")
        q = shard_hint(q, dp, "model", None, None)
        kr = shard_hint(kr, dp, "model", None, None)
        vr = shard_hint(vr, dp, "model", None, None)
        logits = mm(q, kr.transpose(-1, -2)).float() * d ** -0.5
        logits = shard_hint(logits, dp, "model", None, None)
        if causal:
            logits = _causal(logits, s, t, q_off, q.device)
        p = torch.softmax(logits, dim=-1)
        return mm(p.to(vr.dtype), vr)
    logits = _hint_model_dim(_scores(q, k, g) * d ** -0.5, (1, 2, 3))
    if causal:
        logits = _causal(logits, s, t, q_off, q.device)
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
    if hk % max(_model_axis(), 1) != 0:
        # the cache is head-dim-sharded when Hkv < TP: match q to it
        dp = ("pod", "data")
        q = shard_hint(q.reshape(b, hk, g, s, d), dp, None, None, None,
                       "model").reshape(b, h, s, d)
        k = shard_hint(k, dp, None, None, "model")
        v = shard_hint(v, dp, None, None, "model")
    logits = _scores(q, k, g) * d ** -0.5
    kpos = torch.arange(t, device=q.device)
    qpos = pos + torch.arange(s, device=q.device)
    logits = torch.where(kpos[None, :] <= qpos[:, None], logits, NEG)
    p = torch.softmax(logits, dim=-1)
    return _weighted(p, v, g).reshape(b, h, s, d)


def split_last(t, n, m):
    """(…, n·m) → (…, n, m). A DTensor whose ``n`` does not divide the
    ``model`` axis is first gathered over it (a column-sharded product
    would split a group otherwise)."""
    if n % _model_axis():
        t = shard_hint(t, ("pod", "data"), *([None] * (t.dim() - 1)))
    return t.reshape(*t.shape[:-1], n, m)


def _heads(t, n, hd):
    """(B, S, n·hd) → (B, n, S, hd)."""
    return split_last(t, n, hd).transpose(1, 2)


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
    q = _heads(mm(x, fsdp_use(p.wq, None, "model")), h, hd)
    if kv_override is None:
        k = _heads(mm(x, fsdp_use(p.wk, None, "model")), hk, hd)
        v = _heads(mm(x, fsdp_use(p.wv, None, "model")), hk, hd)
        if use_rope:
            q = apply_rope(q, positions, rope_theta)
            k = apply_rope(k, positions, rope_theta)
    else:
        k, v = kv_override

    # per (batch, head) shard on a DeviceMesh: heads over `model` when
    # both head counts divide it, else gathered; the heads are merged
    # per shard too, so the merge's backward never unflattens a
    # model-sharded dim that the heads do not divide (ROADMAP C.17)
    tp = _model_axis()
    spec = local_spec(q, (("pod", "data"),
                          "model" if h % tp == hk % tp == 0 else None))
    new_cache = None
    if cache is not None:
        pos = int(cache_pos)
        ck, cv = cache["k"], cache["v"]
        if pos < 0 or pos + s > ck.shape[2]:
            raise ValueError(f"KV cache overflow: {s} token(s) at position "
                             f"{pos} in a cache of {ck.shape[2]}")
        _write_cache(ck, cv, k, v, pos)
        new_cache = {"k": ck, "v": cv}
        k, v = ck, cv
        if s <= 8:
            def core(q, k, v):
                return _gqa_decode(q, k, v, pos, s)
        else:
            def core(q, k, v):
                return chunked_attention(q, k, v, causal=causal, q_off=pos,
                                         kv_len=pos + s,
                                         q_chunk=min(max(8, s), q_chunk),
                                         kv_chunk=kv_chunk)
    else:
        t = k.shape[2]
        use_chunked = chunked if chunked is not None else (s * t > 1 << 22)
        if use_chunked:
            def core(q, k, v):
                return chunked_attention(q, k, v, causal=causal,
                                         q_chunk=q_chunk, kv_chunk=kv_chunk)
        else:
            def core(q, k, v):
                return _gqa_scores_full(q, k, v, causal)

    def merged(q, k, v):
        o = core(q, k, v)
        return o.transpose(1, 2).reshape(o.shape[0], o.shape[2], -1)
    out = shard_local(merged, (q, k, v), (spec,) * 3,
                      (spec[0], None, spec[1]))
    return mm(out, fsdp_use(p.wo, "model", None)), new_cache


def _write_cache(ck, cv, k, v, pos):
    """``k``, ``v`` into the caches at ``pos``, in place. On a
    ``DeviceMesh`` each shard writes its own block of its own local
    cache (the sequence axis is never sharded), so the cache DTensors
    keep their placements and hold the new tokens."""
    from .sharding import spec_of
    cspec = spec_of(ck)

    def write(ck, cv, k, v):
        ck[:, :, pos:pos + k.shape[2]] = k
        cv[:, :, pos:pos + v.shape[2]] = v
    shard_local(write, (ck, cv, k, v), (cspec,) * 4, None)


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
    wi = fsdp_use(p.wi, None, "model")
    wo = fsdp_use(p.wo, "model", None)
    if kind in ("swiglu", "geglu"):
        act = F.silu if kind == "swiglu" else gelu
        return mm(act(mm(x, fsdp_use(p.wg, None, "model"))) * mm(x, wi), wo)
    return mm(gelu(mm(x, wi)), wo)
