"""Sharding rules: parameter / batch / serve-state partition specs (port
of ``repro/models/sharding.py``).

Scheme (single pod ``(data=16, model=16)``; multi-pod
``(pod=2, data=16, model=16)``):

- **TP** over ``model``: attention QKV/output columns-rows, MLP hidden,
  MoE experts (EP — expert dim over ``model``), vocab/lm-head, SSM and
  RWKV channel dims.
- **FSDP/ZeRO-3** over ``data``: every TP-sharded weight additionally
  shards its *other* matrix dimension over ``data``; optimizer state
  inherits parameter specs (ZeRO). The use-site hint
  (``layers.fsdp_use``) all-gathers a weight over ``data`` for its
  product; the step reduces each gradient to its parameter's placements
  (a reduce-scatter).
- **DP** over ``(pod, data)`` for the batch dimension of activations,
  inputs and serve state.

Every rule is divisibility-sanitized against the actual mesh: an axis
that does not divide the dimension is dropped (replicated) — e.g.
whisper's vocab 51865 on a 16-way model axis. The sanitizer is also what
makes one rule set serve every mesh (the ``(1, 1)`` CPU mesh up to the
512-chip production mesh).

A spec is a :class:`PartitionSpec`, one entry a tensor dimension: None,
an axis name, or a tuple of names sharding one dimension over several
axes in mesh order. The rules read a mesh's axis names and sizes only
(``core.mesh.axis_sizes``), so they serve the device-free
``AbstractMesh``, the in-process ``NamedMesh`` and a ``DeviceMesh``
alike. :func:`placements` turns a spec into a ``DeviceMesh``'s DTensor
placements.

The reference stacks repeated superblocks (and whisper's encoder layers)
on a leading axis; the port has one module each (``blocks.<i>.…``). A
port leaf's spec is the reference's spec of the stacked leaf without its
leading ``None``, and the divisibility check runs on the same (unstacked)
dimensions. The serve state's ``blocks`` and ``cross`` lists are
unstacked the same way.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.mesh import axis_names, axis_sizes
from .model import ModelConfig, abstract_params


class PartitionSpec(tuple):
    """``P("data", None)``: one entry a tensor dimension. A tuple of one
    name is that name, as jax normalises it."""

    def __new__(cls, *axes):
        return super().__new__(cls, (
            a[0] if isinstance(a, (tuple, list)) and len(a) == 1
            else tuple(a) if isinstance(a, list) else a for a in axes))

    def __repr__(self):
        return f"P{tuple(self)!r}"


P = PartitionSpec


def mesh_axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return int(np.prod([mesh_axis_size(mesh, a) for a in axis]))
    sizes = axis_sizes(mesh)
    return sizes[axis] if axis in sizes else 0


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def fsdp_axis(mesh) -> Optional[str]:
    return "data" if "data" in axis_names(mesh) else None


def _sanitize(spec_axes: Sequence[Any], shape, mesh) -> P:
    out = []
    for dim, ax in zip(shape, spec_axes):
        if ax is None:
            out.append(None)
            continue
        size = mesh_axis_size(mesh, ax)
        out.append(ax if size and dim % size == 0 else None)
    return P(*out)


# rule tables: leaf name → spec template builder.
# F = fsdp axis placeholder, M = "model".
_F, _M = "__fsdp__", "model"

_RULES_2D = {
    # (attention / dense mlp / embeddings)
    "wq": (_F, _M), "wk": (_F, _M), "wv": (_F, _M), "wg": (_F, _M),
    "wi": (_F, _M), "wr": (_F, _M),
    "wo": (_M, _F),
    # embeddings: vocab over model ONLY. FSDP ('data') on the d dim
    # collides with batch-over-'data' in the same dot and makes GSPMD
    # all-gather the activations (gigabytes); the tables are ~1% of
    # params, so ZeRO-sharding them buys nothing.
    "tok_embed": (_M, None),
    "lm_head": (None, _M),
    "dec_pos_embed": (None, _M),
    "patch_proj": (None, _M),
    "router": (None, None),
    "shared_wi": (_F, _M), "shared_wg": (_F, _M), "shared_wo": (_M, _F),
    # mamba
    "in_proj": (_F, _M), "conv_w": (None, _M), "x_proj": (_M, None),
    "dt_proj": (None, _M), "A_log": (_M, None), "out_proj": (_M, _F),
    # rwkv
    "mu_lora_a": (_F, None), "mu_lora_b": (None, _M),
    "w_lora_a": (_F, None), "w_lora_b": (None, _M),
    "u": (_M, None), "mu": (None, None),
}

_RULES_3D = {  # MoE expert-stacked weights (E, ., .)
    "wi": (_M, _F, None), "wg": (_M, _F, None), "wo": (_M, None, _F),
}

_RULES_1D = {
    "conv_b": (_M,), "dt_bias": (_M,), "D": (_M,),
    "w0": (_M,), "gn_w": (_M,), "gn_b": (_M,),
}


def leaf_spec(name: str, shape, mesh) -> P:
    """The spec of the port's parameter ``name`` (``blocks.0.s0.attn.wq``)
    of ``shape``."""
    names = name.split(".")
    leaf = names[-1]
    fa = fsdp_axis(mesh)
    rank = len(shape)
    tpl = None
    if rank == 3 and "moe" in names and leaf in _RULES_3D:
        tpl = _RULES_3D[leaf]
    elif rank == 2 and leaf in _RULES_2D:
        tpl = _RULES_2D[leaf]
    elif rank == 1 and leaf in _RULES_1D:
        tpl = _RULES_1D[leaf]
    if tpl is None:
        tpl = (None,) * rank
    tpl = tuple(fa if a == _F else a for a in tpl)
    return _sanitize(tpl, tuple(shape), mesh)


def param_specs(cfg: ModelConfig, mesh) -> Dict[str, P]:
    """``{parameter name: spec}`` for ``init_params(cfg)``'s parameters."""
    return {n: leaf_spec(n, p.shape, mesh)
            for n, p in abstract_params(cfg).named_parameters()}


# ------------------------------------------------------------------ #
# batch / state specs
# ------------------------------------------------------------------ #
def batch_specs(cfg: ModelConfig, mesh, batch_size: int):
    dp = dp_axes(mesh) or None
    bspec = dp if dp and batch_size % mesh_axis_size(mesh, dp) == 0 \
        else None
    d = {"tokens": P(bspec, None), "labels": P(bspec, None)}
    if cfg.family == "encdec":
        d["frames"] = P(bspec, None, None)
    if cfg.family == "vlm":
        d["patches"] = P(bspec, None, None)
    return d


def _first_shardable(dims, mesh, axis="model"):
    """Pick a channel-like dim to shard over ``model``: first or last —
    never a middle dim (for KV caches the middle dim is the sequence/
    time axis, which decode writes at a dynamic offset and must stay
    unsharded)."""
    size = mesh_axis_size(mesh, axis)
    candidates = [0, len(dims) - 1] if len(dims) >= 2 else [0]
    for i in dict.fromkeys(candidates):
        if size and dims[i] % size == 0 and dims[i] >= size:
            return i
    return None


def serve_state_specs(cfg: ModelConfig, mesh, state):
    """Specs for the serve-state tree returned by ``init_serve_state``
    (the same nesting; ``pos`` gets ``P()``)."""
    dp = dp_axes(mesh) or None

    def spec(names, leaf):
        if names[-1] == "pos":
            return P()
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return P()
        # batch leading dim over dp; one more dim over model if divisible
        rest = [None] * (len(shape) - 1)
        j = _first_shardable(shape[1:], mesh)
        if j is not None:
            rest[j] = "model"
        b = dp if dp and shape[0] % mesh_axis_size(mesh, dp) == 0 else None
        return P(b, *rest)

    def walk(node, names):
        if isinstance(node, dict):
            return {k: walk(v, names + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, names) for v in node]
        return spec(names, node if hasattr(node, "shape") else
                    np.asarray(node))

    return walk(state, ())


# ------------------------------------------------------------------ #
# DTensor placements on a DeviceMesh
# ------------------------------------------------------------------ #
def placements(spec, mesh) -> tuple:
    """A spec as placements on ``mesh``, one a mesh dimension in mesh
    order: ``Shard(i)`` where the spec names that axis at tensor dim
    ``i`` (alone or in a tuple), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for a in axis_names(mesh):
        dim = next((i for i, ax in enumerate(spec)
                    if ax == a or (isinstance(ax, tuple) and a in ax)),
                   None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


def spec_of(t) -> P:
    """The spec of a DTensor's placements (the inverse of
    :func:`placements`): each dim the axes sharding it, in mesh order;
    all None for a plain tensor."""
    axes = [[] for _ in range(t.dim())]
    mesh = getattr(t, "device_mesh", None)
    if mesh is not None and hasattr(t, "placements"):
        for name, pl in zip(axis_names(mesh), t.placements):
            if pl.is_shard():
                axes[pl.dim].append(name)
    return P(*(tuple(a) if a else None for a in axes))


def param_placements(model, mesh) -> Dict[str, tuple]:
    """``{parameter name: placements}`` of ``model``'s parameters on a
    ``DeviceMesh``."""
    return {n: placements(leaf_spec(n, p.shape, mesh), mesh)
            for n, p in model.named_parameters()}


def distribute(t: torch.Tensor, mesh, pl):
    """``t`` as a DTensor on ``mesh`` with placements ``pl``, each rank
    keeping its own chunk of its own full ``t`` (every rank holds the
    same values: no communication)."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, pl, src_data_rank=None)


@torch.no_grad()
def distribute_params(model, mesh, placements_by_name=None):
    """Replace each parameter of ``model`` (in place) by a DTensor
    parameter on ``mesh``, placed by ``param_placements`` unless
    ``placements_by_name`` is given; returns ``model``. Every rank must
    hold the same full values."""
    from torch import nn
    pl = placements_by_name or param_placements(model, mesh)
    for name, p in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        setattr(mod, leaf, nn.Parameter(distribute(p.detach(), mesh,
                                                   pl[name]),
                                        requires_grad=p.requires_grad))
    return model


def distribute_batch(cfg: ModelConfig, mesh, batch):
    """Each batch tensor as a DTensor on ``mesh`` placed by
    :func:`batch_specs` (every rank holding the whole batch)."""
    b = next(iter(batch.values())).shape[0]
    specs = batch_specs(cfg, mesh, b)
    return {k: distribute(v, mesh, placements(specs[k], mesh))
            for k, v in batch.items()}


def distribute_serve_state(mesh, state, cfg: ModelConfig = None):
    """Each tensor leaf of a serve state as a DTensor on ``mesh`` placed
    by :func:`serve_state_specs` (each rank its own chunk of its own
    full leaf); ``pos`` stays an int."""
    specs = serve_state_specs(cfg, mesh, state)

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, sp) for v, sp in zip(node, spec)]
        if not isinstance(node, torch.Tensor):
            return node
        return distribute(node, mesh, placements(spec, mesh))
    return walk(state, specs)


class NamedSharding:
    """A spec on a mesh (the counterpart of ``jax.sharding.NamedSharding``):
    :meth:`place` puts a whole tensor there — on a ``DeviceMesh`` as a
    DTensor of the spec's placements (each rank its own chunk), on an
    in-process ``NamedMesh`` on its device (it holds every shard)."""

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, P(*spec)

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def place(self, t: torch.Tensor) -> torch.Tensor:
        if getattr(self.mesh, "mesh_dim_names", None) is not None:
            return distribute(t.to(self.mesh.device_type), self.mesh,
                              self.placements)
        device = getattr(self.mesh, "device", None)
        if device is None:
            raise TypeError(f"{self.mesh!r} holds no device to place on")
        return t.to(device)
