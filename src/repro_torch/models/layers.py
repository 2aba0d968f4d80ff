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
DTensors as replicated operands.

The layout. GSPMD lays the reference's whole step out from those few
hints; DTensor chooses op by op, and left alone it repeats on every
``model`` rank work that the reference splits (ROADMAP C.18). So on a
``DeviceMesh`` each sublayer lays its work out explicitly and runs it
per shard (:func:`shard_local`, shard_map's counterpart): the residual
stream stays batch-sharded and replicated over ``model`` between
sublayers, the embedding is vocab-parallel (:func:`embed_lookup`), the
MLPs column- then row-parallel (:func:`tp_ffn`), attention over whole
heads or over the query positions (:func:`attention`), and each
row-parallel output is a partial sum (:class:`Summed`) all-reduced back
to the stream (:func:`to_stream`). Where DTensor has no sharding rule
for an op (the MoE's dispatch), the op runs under :func:`gathered`.

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


class Summed(tuple):
    """An ``out_axes`` entry of :func:`shard_local` for an output that is
    a partial sum over ``over`` (``model`` by default: each rank there
    holds its own part, ``Partial("sum")``), laid out by the spec over the
    other axes."""

    def __new__(cls, spec, over="model"):
        out = super().__new__(cls, spec)
        out.over = (over,) if isinstance(over, str) else tuple(over)
        return out


def summed(spec, split: bool):
    """``spec`` as a :class:`Summed` entry when ``split`` (the product
    behind it contracts a dim sharded over a ``model`` axis of more than
    one rank), else as it is."""
    return Summed(spec) if split and _model_axis() > 1 else spec


def shard_local(fn, args, in_axes, out_axes):
    """``shard_map``'s counterpart on a ``DeviceMesh``: with a DTensor
    among ``args``, each tensor arg redistributed to its ``in_axes``
    (one entry a dim: None, an axis name or a tuple; sanitized as
    ``shard_hint`` sanitizes) and taken local, ``fn`` run on the local
    shards, and each tensor it returns made a DTensor with its
    ``out_axes`` entry (taken as given: the caller derives it from the
    inputs' sanitized specs, :func:`local_spec`; a :class:`Summed` entry
    is also partial over ``model``; None replicates every output).
    Autograd flows through both conversions; as in ``shard_map``'s
    transpose, an operand replicated over a mesh axis that another
    operand is sharded over gets a gradient that is partial there
    (summed over that axis). A plain call on plain tensors."""
    mesh = next((a.device_mesh for a in args if is_dtensor(a)), None)
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, distribute_tensor

    from .sharding import placements

    def out_placements(ax):
        pl = placements(ax, mesh)
        if isinstance(ax, Summed):
            pl = tuple(Partial() if n in ax.over else p
                       for n, p in zip(mesh.mesh_dim_names, pl))
        return pl

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
        DTensor.from_local(o, mesh, out_placements(ax), run_check=False)
        if isinstance(o, torch.Tensor) else o for o, ax in zip(outs, axes))
    return wrapped[0] if single else wrapped


def local_spec(x, axes):
    """The sanitized spec ``shard_local`` gives ``x`` for ``axes`` under
    the bound mesh (all None with none bound)."""
    if _ACT_MESH is None:
        return [None] * x.dim()
    return _spec(_ACT_MESH, x.shape, axes)


# ------------------------------------------------------------------ #
# the explicit tensor-parallel layout
# ------------------------------------------------------------------ #
# Between sublayers the residual stream is batch-sharded over the data
# axes and replicated over ``model`` (the reference pins it so after the
# embedding). Each sublayer runs its products on each rank's own shard
# (``shard_local``): a column-parallel product on its own columns, a
# row-parallel one on its own rows, whose partial sums (``Summed``) are
# all-reduced back to the stream's layout; nothing is left for DTensor
# to lay out op by op.
DP = ("pod", "data")


def stream_spec(x):
    """The residual stream's sanitized spec for ``x``: batch over the
    data axes, every other dim whole."""
    return local_spec(x, (DP,))


def to_stream(x):
    """``x`` in the stream's layout: a partial sum over ``model``
    all-reduced, a dim sharded over it gathered (the identity on a plain
    tensor)."""
    return shard_hint(x, DP)


def shard_start(n: int, *tensors, axis: str = "model") -> int:
    """Where this rank's chunk starts of a dim of ``n`` split evenly over
    ``axis`` of the ``DeviceMesh`` of the first DTensor of ``tensors``
    (0 with none)."""
    mesh = next((t.device_mesh for t in tensors if is_dtensor(t)), None)
    if mesh is None:
        return 0
    size = mesh.size(mesh.mesh_dim_names.index(axis))
    return mesh.get_local_rank(axis) * (n // size)


def col_gathered(x, w):
    """``x @ w`` replicated over ``model``: each model rank makes its own
    columns of the product (``w`` column-parallel), then they are
    gathered. A plain product on plain tensors."""
    w = fsdp_use(w, None, "model")
    xs, ws = stream_spec(x), local_spec(w, (None, "model"))
    out = shard_local(mm, (x, w), (xs, ws), xs[:-1] + ws[-1:])
    return to_stream(out)


def row_parallel(t, w):
    """``t @ w`` for ``t`` in the stream's layout: each model rank
    contracts its own columns of ``t`` with its own rows of ``w``
    (row-parallel), and the partial sums are all-reduced to the stream's
    layout."""
    w = fsdp_use(w, "model", None)
    ws = local_spec(w, ("model", None))
    ts = stream_spec(t)
    out = shard_local(mm, (t, w), (ts[:-1] + ws[:1], ws),
                      summed(ts, ws[0] is not None))
    return to_stream(out)


def tp_ffn(body, x, cols, row):
    """``body(x, *cols, row)`` on each model rank, Megatron's layout:
    ``x`` in the stream's layout, each of ``cols`` column-parallel and
    ``row`` row-parallel over ``model``, so that every rank makes its own
    hidden columns of each product, forward and backward; the output's
    partial sums are all-reduced to the stream's layout."""
    xs = stream_spec(x)
    cols = [fsdp_use(w, None, "model") for w in cols]
    row = fsdp_use(row, "model", None)
    rs = local_spec(row, ("model", None))
    out = shard_local(
        body, (x, *cols, row),
        (xs, *(local_spec(w, (None, "model")) for w in cols), rs),
        summed(xs, rs[0] is not None))
    return to_stream(out)


def weights_stay(x) -> bool:
    """Whether the products of a sublayer that the reference leaves
    unhinted contract each rank's own 2-D weight shard
    (:func:`own_shard_mm`): ``x`` a DTensor whose batch the data axes do
    not divide (a batch of one), on a mesh of more than one data rank.
    There a weight gathered over ``data`` would be used by one token."""
    return is_dtensor(x) and axis_sizes(x.device_mesh).get("data", 1) > 1 \
        and stream_spec(x)[0] is None


def own_shard_mm(t, w, w_axes, pre=None):
    """``t @ w`` with the weight left where it lies: each rank contracts
    its own 2-D shard of ``w`` (rows over ``w_axes[0]``, columns over
    ``w_axes[1]``, sanitized as ``shard_hint`` sanitizes) with the same
    slice of ``t``'s last dim (``pre``, elementwise, applied to that slice
    first). The output keeps the columns' sharding and is a partial sum
    over the rows' axis (:class:`Summed`); the reference's compiled step
    lays a product of a replicated token and an FSDP-sharded weight out
    so (:func:`weights_stay`)."""
    ws = local_spec(w, w_axes)
    ts = stream_spec(t)[:-1] + ws[:1]
    out = ts[:-1] + ws[1:]

    def prod(t, w):
        return mm(t if pre is None else pre(t), w)
    return shard_local(prod, (t, w), (ts, ws),
                       Summed(out, ws[0]) if ws[0] else out)


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
    spec = local_spec(x, (DP,) + (None,) * (x.dim() - 2) + (ax,))
    return shard_local(lambda x, w, b: group_norm_local(x, w, b, hs, eps),
                       (x, w, b), (spec, spec[-1:], spec[-1:]), spec)


def group_norm_local(x, w, b, head_size, eps=1e-5):
    """:func:`group_norm_heads` on a plain tensor of whole heads of
    ``head_size`` channels each."""
    shp = x.shape
    xf = x.float().reshape(*shp[:-1], shp[-1] // head_size, head_size)
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
    picks the same rows), in the stream's layout. ``F.embedding`` on
    plain tensors. On a ``DeviceMesh`` with the table sharded over
    ``model`` by vocabulary, the lookup is vocab-parallel: each model rank
    looks up the ids in its own range of rows and gives zeros for the
    rest, a partial sum all-reduced to the stream's layout, where every
    row comes from one rank bit for bit; the backward is each rank's
    scatter into its own rows."""
    if not is_dtensor(table) and not is_dtensor(ids):
        return F.embedding(ids, table)
    ts, ids_spec = local_spec(table, ("model", None)), local_spec(ids, (DP,))
    lo = shard_start(table.shape[0], table, ids) if ts[0] else 0

    def lookup(ids, table):
        if ts[0] is None:
            return F.embedding(ids, table)
        local = ids - lo
        hit = (local >= 0) & (local < table.shape[0])
        rows = F.embedding(torch.where(hit, local, 0), table)
        return torch.where(hit[..., None], rows, 0)
    out = shard_local(lookup, (ids, table), (ids_spec, ts),
                      summed(ids_spec + [None], ts[0] is not None))
    return to_stream(out)


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


def _causal(logits, qpos, t):
    """``logits`` (…, S, T) with key ``j`` masked for the query at
    position ``qpos[i]`` where ``j > qpos[i]``."""
    kpos = torch.arange(t, device=logits.device)
    return torch.where(kpos[None, :] <= qpos[:, None], logits, NEG)


def _positions(qpos, s, q_off, device):
    return torch.arange(s, device=device) + q_off if qpos is None else qpos


def _repeat_k(h, hk):
    """``OPT["attn_repeat_k"]``'s case: the heads divide the bound
    ``model`` axis (larger than 1) and the KV heads do not."""
    tp = _model_axis()
    return OPT["attn_repeat_k"] and tp > 1 and h % tp == 0 and hk % tp != 0


def _gqa_scores_full(q, k, v, causal, q_off=0, qpos=None, repeat=None):
    """Full-matrix GQA attention (small S only). q: (B,H,S,D), kv: (B,Hk,T,D).
    ``qpos``: the queries' positions (default ``q_off + arange(S)``), which
    the causal mask reads.

    With ``repeat`` (default :func:`_repeat_k` of these heads), K/V are
    repeated to all H heads and the (B,H,S,T) scores computed per head
    (the reference's ``OPT["attn_repeat_k"]`` path); otherwise the
    grouped (B,Hk,G,S,T) scores. The caller lays the work out over
    ``model`` (:func:`attention`)."""
    b, h, s, d = q.shape
    hk, t = k.shape[1], k.shape[2]
    g = h // hk
    qpos = _positions(qpos, s, q_off, q.device)
    if repeat is None:
        repeat = _repeat_k(h, hk)
    if repeat:
        kr = k.repeat_interleave(g, dim=1)
        vr = v.repeat_interleave(g, dim=1)
        logits = mm(q, kr.transpose(-1, -2)).float() * d ** -0.5
        if causal:
            logits = _causal(logits, qpos, t)
        p = torch.softmax(logits, dim=-1)
        return mm(p.to(vr.dtype), vr)
    logits = _scores(q, k, g) * d ** -0.5
    if causal:
        logits = _causal(logits, qpos, t)
    p = torch.softmax(logits, dim=-1)
    return _weighted(p, v, g).reshape(b, h, s, d)


def chunked_attention(q, k, v, *, causal=True, q_off=0, kv_len=None,
                      q_chunk=512, kv_chunk=1024, qpos=None):
    """Online-softmax (flash) attention over KV chunks; GQA-aware.

    q: (B, H, S, D); k, v: (B, Hkv, T, D). ``kv_len``: the valid length
    of the KV sequence (decode with a preallocated cache). ``qpos``: the
    queries' positions (default ``q_off + arange(S)``), which the causal
    mask reads. Never materializes more than (B, Hkv, g, q_chunk,
    kv_chunk) logits.
    """
    b, h, s, d = q.shape
    hk, t = k.shape[1], k.shape[2]
    g = h // hk
    scale = d ** -0.5
    dev = q.device
    qpos = _positions(qpos, s, q_off, dev)
    s_pad = (-s) % q_chunk
    q = F.pad(q, (0, 0, 0, s_pad))
    if s_pad:           # the padded rows' positions (their rows are cut)
        qpos = torch.cat([qpos, qpos[-1] + 1 + torch.arange(s_pad,
                                                            device=dev)])
    t_pad = (-t) % kv_chunk
    if t_pad:
        k = F.pad(k, (0, 0, 0, t_pad))
        v = F.pad(v, (0, 0, 0, t_pad))
    sq, tk = q.shape[2], k.shape[2]
    valid_t = t if kv_len is None else kv_len
    ar_k = torch.arange(kv_chunk, device=dev)
    outs = []
    for qi in range(sq // q_chunk):
        qblk = q[:, :, qi * q_chunk:(qi + 1) * q_chunk]
        qp = qpos[qi * q_chunk:(qi + 1) * q_chunk]
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
                msk = msk & (kpos[None, :] <= qp[:, None])
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


def _gqa_decode(q, k, v, qpos):
    """Masked full-cache attention for small decode blocks (s ≤ 8).

    q: (B, H, s, D); k/v: (B, Hkv, T, D). Valid keys: index ≤ qpos[i]
    (the queries' positions, ``pos + arange(s)``).
    """
    b, h, s, d = q.shape
    g = h // k.shape[1]
    p = _decode_probs(_scores(q, k, g), qpos, d)
    return _weighted(p, v, g).reshape(b, h, s, d)


def _decode_probs(logits, qpos, d):
    """The decode pass's softmax of (B, Hk, g, s, T) ``logits`` (before
    the ``d ** -0.5`` scale), keys past each query masked."""
    return torch.softmax(_causal(logits * d ** -0.5, qpos, logits.shape[-1]),
                         dim=-1)


def split_last(t, n, m):
    """(…, n·m) → (…, n, m). A DTensor whose ``n`` does not divide the
    ``model`` axis is first gathered over it (a column-sharded product
    would split a group otherwise)."""
    if n % _model_axis():
        t = shard_hint(t, ("pod", "data"), *([None] * (t.dim() - 1)))
    return t.reshape(*t.shape[:-1], n, m)


def _heads(t, hd):
    """(B, S, n·hd) → (B, n, S, hd) on a plain tensor (or a DTensor
    replicated over ``model``)."""
    return t.reshape(*t.shape[:-1], t.shape[-1] // hd, hd).transpose(1, 2)


def heads_of(t, hd, positions=None, rope=None):
    """(B, S, n·hd) → (B, n, S, hd), RoPE'd at ``positions`` when ``rope``
    is given; on a DTensor (batch over the data axes, replicated over
    ``model``) per shard, so that no DTensor view meets the transposed
    local gradient in the backward."""
    spec = stream_spec(t)

    def split(t, ps):
        h = _heads(t, hd)
        return h if rope is None else rope(h, ps)
    return shard_local(split, (t, positions), (spec, (None,)), spec + [None])


def _merged(o):
    """(B, n, S, hd) → (B, S, n·hd)."""
    return o.transpose(1, 2).reshape(o.shape[0], o.shape[2], -1)


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
    ``positions`` (S,): the new tokens' positions (RoPE and the causal
    mask).

    On a ``DeviceMesh`` the work splits over ``model`` as the reference's
    layout splits it (the score tensor over Hk, else over the query
    sequence S; the reference's grouped G is taken as S, which no
    configuration's heads meet on the meshes used), each layout run per
    shard (``shard_local``), so that no DTensor view splits or merges a
    head across shards (ROADMAP C.17):

    - ``heads`` (the KV heads divide the axis, or the cache is sharded on
      them): q/k/v column-parallel over whole heads, the scores and the
      cache on each rank's own heads, ``wo`` row-parallel;
    - ``hd`` (a decode block, s ≤ 8, on a cache sharded on its head dim,
      the reference's rule when Hkv < TP): q/k/v column-parallel and
      gathered, each rank scores its own head-dim slice against its own
      cache slice, the scores summed over ``model``, the weighted values
      gathered, ``wo`` row-parallel;
    - ``rows`` (otherwise): k/v column-parallel and gathered, and each
      rank runs the queries of its own positions (S sharded beside q, the
      causal mask built from them) through q, the scores and ``wo`` with
      the weights gathered; S not dividing the axis runs whole on every
      rank, as the reference's hint degrades to batch only.
    """
    b, s, _ = x.shape
    h, hk, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim
    pos = ck = cv = None
    if cache is not None:
        pos = int(cache_pos)
        ck, cv = cache["k"], cache["v"]
        if pos < 0 or pos + s > ck.shape[2]:
            raise ValueError(f"KV cache overflow: {s} token(s) at position "
                             f"{pos} in a cache of {ck.shape[2]}")
    t = s if kv_override is None else kv_override[0].shape[2]
    use_chunked = chunked if chunked is not None else (s * t > 1 << 22)
    repeat = _repeat_k(h, hk)

    def core(q, k, v, qpos, kv_len=None):
        if cache is not None and s <= 8:
            return _gqa_decode(q, k, v, qpos)
        if cache is not None:
            return chunked_attention(
                q, k, v, causal=causal, qpos=qpos, kv_len=kv_len,
                q_chunk=min(max(8, q.shape[2]), q_chunk), kv_chunk=kv_chunk)
        if use_chunked:
            return chunked_attention(q, k, v, causal=causal, qpos=qpos,
                                     q_chunk=q_chunk, kv_chunk=kv_chunk)
        return _gqa_scores_full(q, k, v, causal, qpos=qpos, repeat=repeat)

    rope = (lambda t, ps: apply_rope(t, ps, rope_theta)) \
        if use_rope and kv_override is None else None
    layout = _attn_layout(x, hk, cache)
    if layout == "heads":
        out = _attn_heads(p, x, hd, positions, rope, kv_override, cache,
                          pos, core)
    elif layout == "hd":
        out = _attn_hd(p, x, dims, positions, rope, ck, cv, pos)
    else:
        out = _attn_rows(p, x, hd, positions, rope, kv_override, cache,
                         pos, core)
    return out, (None if ck is None else {"k": ck, "v": cv})


def _model_dim(t):
    """The dim of ``t`` sharded over ``model`` (None: none)."""
    from .sharding import spec_of
    return next((i for i, ax in enumerate(spec_of(t))
                 if ax == "model" or isinstance(ax, tuple)
                 and "model" in ax), None)


def _attn_layout(x, hk, cache):
    """:func:`attention`'s layout: ``heads``, ``hd`` or ``rows``."""
    tp = _model_axis()
    if not is_dtensor(x) or tp == 1:
        return "heads"
    if cache is None:
        return "heads" if hk % tp == 0 else "rows"
    cdim = _model_dim(cache["k"])
    if cdim == 1:
        return "heads"
    return "hd" if cdim == 3 and x.shape[1] <= 8 else "rows"


def _attn_heads(p, x, hd, positions, rope, kv_override, cache, pos,
                core):
    """Each rank its own heads, from the projections to ``wo``."""
    xs = stream_spec(x)
    wq, wo = fsdp_use(p.wq, None, "model"), fsdp_use(p.wo, "model", None)
    cols = local_spec(wq, (None, "model"))
    rows = local_spec(wo, ("model", None))
    if kv_override is None:
        kv = (fsdp_use(p.wk, None, "model"), fsdp_use(p.wv, None, "model"))
        kv_axes = (local_spec(kv[0], (None, "model")),) * 2
    else:
        kv = kv_override
        kv_axes = (local_spec(kv[0], (DP, "model")),) * 2
    args = (x, wq, wo, positions, *kv)
    axes = (xs, cols, rows, (None,), *kv_axes)
    if cache is not None:
        from .sharding import spec_of
        args += (cache["k"], cache["v"])
        axes += (spec_of(cache["k"]),) * 2

    def body(x, wq, wo, qpos, k, v, ck=None, cv=None):
        q = _heads(mm(x, wq), hd)
        if kv_override is None:
            k, v = _heads(mm(x, k), hd), _heads(mm(x, v), hd)
            if rope is not None:
                q, k = rope(q, qpos), rope(k, qpos)
        kv_len = None
        if ck is not None:
            ck[:, :, pos:pos + k.shape[2]] = k
            cv[:, :, pos:pos + v.shape[2]] = v
            k, v, kv_len = ck, cv, pos + q.shape[2]
        return mm(_merged(core(q, k, v, qpos, kv_len)), wo)
    out = shard_local(body, args, axes, summed(xs, rows[0] is not None))
    return to_stream(out)


def _attn_hd(p, x, dims: AttnDims, positions, rope, ck, cv, pos):
    """A decode block on a cache sharded on its head dim: each rank
    scores its own head-dim slice, the scores are summed over ``model``
    (the reference's partial-sum contraction), and each rank weights its
    own slice of V."""
    h, hk, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim
    g = h // hk
    q, k = (heads_of(col_gathered(x, w), hd, positions, rope)
            for w in (p.wq, p.wk))
    v = heads_of(col_gathered(x, p.wv), hd)
    from .sharding import spec_of
    cspec = list(spec_of(ck))
    lo = shard_start(hd, ck)
    rep = stream_spec(q)

    def scores(q, k, v, qpos, ck, cv):
        n = ck.shape[3]
        ck[:, :, pos:pos + k.shape[2]] = k[..., lo:lo + n]
        cv[:, :, pos:pos + v.shape[2]] = v[..., lo:lo + n]
        return _scores(q[..., lo:lo + n], ck, g)
    lg = shard_local(scores, (q, k, v, positions, ck, cv),
                     (rep, rep, rep, (None,), cspec, cspec),
                     summed(cspec[:1] + [None] * 4, True))

    def weighted(lg, qpos, cv):
        o = _weighted(_decode_probs(lg, qpos, hd), cv, g)
        b, _, _, s, n = o.shape
        return o.reshape(b, h, s, n).transpose(1, 2)      # (B, s, H, n)
    o = shard_local(weighted, (to_stream(lg), positions, cv),
                    (cspec[:1] + [None] * 4, (None,), cspec),
                    cspec[:1] + [None, None, "model"])
    o = to_stream(o)
    return row_parallel(o.reshape(*o.shape[:2], h * hd), p.wo)


def _attn_rows(p, x, hd, positions, rope, kv_override, cache, pos, core):
    """Each rank the queries of its own positions: k/v column-parallel
    and gathered (and written into the cache), then q, the scores and
    ``wo`` on the rank's rows with the weights gathered over ``model``."""
    if kv_override is None:
        k = heads_of(col_gathered(x, p.wk), hd, positions, rope)
        v = heads_of(col_gathered(x, p.wv), hd)
    else:
        k, v = (to_stream(t) for t in kv_override)
    if cache is not None:
        # the keys are the cache's valid prefix: the block written into it,
        # after the cached tokens (gathered); the keys past it that the
        # whole cache would hold are masked there and add nothing
        ck, cv = cache["k"], cache["v"]
        _write_cache(ck, cv, k, v, pos)
        k, v = k.to(ck.dtype), v.to(cv.dtype)
        if pos:
            k = torch.cat([to_stream(ck[:, :, :pos]), k], 2)
            v = torch.cat([to_stream(cv[:, :, :pos]), v], 2)
    rs = local_spec(x, (DP, "model"))
    ks = stream_spec(k)
    wq, wo = fsdp_use(p.wq, None, None), fsdp_use(p.wo, None, None)

    def body(x, wq, wo, k, v, qpos):
        q = _heads(mm(x, wq), hd)
        if rope is not None:
            q = rope(q, qpos)
        return mm(_merged(core(q, k, v, qpos)), wo)
    out = shard_local(body, (x, wq, wo, k, v, positions),
                      (rs, (None, None), (None, None), ks, ks, rs[1:2]), rs)
    return to_stream(out)


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
    """The dense MLP, ``wi`` and ``wg`` column-parallel and ``wo``
    row-parallel over ``model`` (:func:`tp_ffn`)."""
    if kind in ("swiglu", "geglu"):
        act = F.silu if kind == "swiglu" else gelu
        return tp_ffn(lambda x, wi, wg, wo: mm(act(mm(x, wg)) * mm(x, wi), wo),
                      x, (p.wi, p.wg), p.wo)
    return tp_ffn(lambda x, wi, wo: mm(gelu(mm(x, wi)), wo), x, (p.wi,),
                  p.wo)
