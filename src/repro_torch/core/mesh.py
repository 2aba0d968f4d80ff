"""The shard mesh of the SPMD session engine: where each shard of the
object store lives, and the cross-shard reductions.

The counterpart of the reference's jax ``Mesh`` plus ``shard_map``'s
``psum``/``pmin``/``pmax`` (``repro/core/distributed.py``). The engine
writes each step as a per-shard local part followed by the mesh's
reduction; the mesh decides where the shards are:

- :class:`ShardMesh` — an in-process shard loop. The columns live once
  on one device; shard s is the contiguous view ``[s·m, (s+1)·m)`` of
  them (no copies), and the shards' local tables are reduced in shard
  order. The CPU tests and the one-card runs use it.
- :class:`ProcessGroupMesh` — one shard per ``torch.distributed`` rank
  (NCCL on GPUs, gloo on the CPU): each rank holds its own shard, and the
  reductions are ``all_reduce`` with ``SUM``/``MIN``/``MAX``. A failed
  collective raises; nothing carries on without it.

Both shard the same truncated store: ``n`` objects with ``n`` a multiple
of the shard count (the reference's ``(n // n_dev) * n_dev``).

The LM substrate's model sharding names its mesh axes (``data``,
``model``, and ``pod`` across pods) and comes in three forms, which
:func:`axis_sizes` reads alike:

- :class:`AbstractMesh` — names and sizes only, no device (the
  reference's ``jax.sharding.AbstractMesh``): the 256- and 512-chip
  production meshes, for specs and abstract step inputs.
- :class:`NamedMesh` — every ``(data, model)`` (or ``(pod, data,
  model)``) shard held by this process on one device, in the idiom of
  :class:`ShardMesh`: a shard is a view of the whole tensor
  (:meth:`NamedMesh.local`), and a reduction over one named axis folds
  the shards in shard order (:meth:`NamedMesh.reduce`). The
  counterpart of ``shard_map`` over a jax mesh, for one card.
- ``torch.distributed.device_mesh.DeviceMesh`` with the same axis
  names, holding DTensors: one shard a rank.
"""
from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..data.rawfile import resolve_device

OPS = ("sum", "min", "max")


def _fold(parts: Sequence[torch.Tensor], op: str) -> torch.Tensor:
    out = parts[0]
    for p in parts[1:]:
        if op == "sum":
            out = out + p
        elif op == "min":
            out = torch.minimum(out, p)
        else:
            out = torch.maximum(out, p)
    return out


class ShardMesh:
    """``n_shards`` shards of the object store, all held by this process
    on ``device`` (the default ``"cuda"`` raises without a card)."""

    def __init__(self, n_shards: int, device="cuda"):
        if int(n_shards) < 1:
            raise ValueError(
                f"distributed AQP needs a mesh with at least one shard to "
                f"shard the object store over (got {n_shards})")
        self.n_shards = int(n_shards)
        self.device = resolve_device(device)

    def __repr__(self):
        return (f"{type(self).__name__}(n_shards={self.n_shards}, "
                f"device={self.device})")

    def place(self, col, n: int) -> torch.Tensor:
        """The part of ``col[:n]`` this process holds, float32 on the
        mesh's device: all of it (a view when ``col`` is already there)."""
        return _on(col, 0, n, self.device)

    def shards(self, *cols: torch.Tensor) -> List[Tuple[torch.Tensor, ...]]:
        """The held shards, in shard order: for each, the contiguous views
        of ``cols`` (each column as :meth:`place` gave it)."""
        m = len(cols[0]) // self.n_shards
        return [tuple(c[s * m:(s + 1) * m] for c in cols)
                for s in range(self.n_shards)]

    def reduce(self, parts: Sequence[torch.Tensor], op: str) -> torch.Tensor:
        """``psum``/``pmin``/``pmax`` of the held shards' local tables
        (one per held shard, in shard order) across the whole mesh."""
        assert op in OPS, op
        return _fold(parts, op)

    def map_reduce(self, fn: Callable, cols: Sequence[torch.Tensor],
                   ops: Sequence[str]) -> Tuple[torch.Tensor, ...]:
        """Run ``fn`` on each held shard's views of ``cols`` and reduce
        its i-th output across the mesh with ``ops[i]``."""
        outs = [fn(*views) for views in self.shards(*cols)]
        return tuple(self.reduce([o[i] for o in outs], op)
                     for i, op in enumerate(ops))


class ProcessGroupMesh(ShardMesh):
    """One shard per rank of a ``torch.distributed`` process group (the
    default group unless ``group`` is given), on this rank's
    ``device``. The group must be initialized by the caller."""

    _OPS = {"sum": "SUM", "min": "MIN", "max": "MAX"}

    def __init__(self, device="cuda", group=None):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("ProcessGroupMesh needs an initialized "
                               "torch.distributed process group")
        self.group = group
        self.rank = dist.get_rank(group)
        super().__init__(dist.get_world_size(group), device)

    def place(self, col, n: int) -> torch.Tensor:
        m = n // self.n_shards
        return _on(col, self.rank * m, (self.rank + 1) * m, self.device)

    def shards(self, *cols: torch.Tensor) -> List[Tuple[torch.Tensor, ...]]:
        return [tuple(cols)]

    def reduce(self, parts: Sequence[torch.Tensor], op: str) -> torch.Tensor:
        import torch.distributed as dist
        assert op in OPS, op
        out = _fold(parts, op).clone()
        dist.all_reduce(out, op=getattr(dist.ReduceOp, self._OPS[op]),
                        group=self.group)
        return out


def _on(col, lo: int, hi: int, device) -> torch.Tensor:
    if isinstance(col, torch.Tensor):
        return col[lo:hi].to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(col[lo:hi], np.float32))).to(device)


# --------------------------------------------------------------------- #
# named meshes (the LM substrate's model sharding)
# --------------------------------------------------------------------- #
def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a mesh in mesh order: an
    :class:`AbstractMesh` or :class:`NamedMesh` (``.shape``), or a
    ``DeviceMesh`` (``mesh_dim_names`` and its sizes)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        # a DeviceMesh builds its ``mesh`` tensor anew on each read:
        # read it once a mesh
        sizes = getattr(mesh, "_axis_sizes", None)
        if sizes is None:
            sizes = dict(zip(names, (int(n) for n in mesh.mesh.shape)))
            mesh._axis_sizes = sizes
        return dict(sizes)
    return dict(mesh.shape)


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(axis_sizes(mesh))


class AbstractMesh:
    """A mesh of names and sizes, with no device behind it."""

    def __init__(self, shape: Sequence[int], names: Sequence[str]):
        if len(shape) != len(names):
            raise ValueError(f"{len(shape)} sizes for {len(names)} axes")
        self.axis_names = tuple(names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))

    def __repr__(self):
        return f"{type(self).__name__}({self.shape})"


class NamedMesh(AbstractMesh):
    """Every shard of a named mesh, held by this process on ``device``
    (the default ``"cuda"`` raises without a card). A coordinate is a
    tuple of indices, one an axis in mesh order."""

    def __init__(self, shape: Sequence[int], names: Sequence[str],
                 device="cuda"):
        super().__init__(shape, names)
        self.device = resolve_device(device)

    def coords(self) -> List[Tuple[int, ...]]:
        """Every coordinate, the last axis fastest."""
        return list(itertools.product(*(range(n)
                                        for n in self.shape.values())))

    def index(self, coord: Sequence[int], axes) -> Tuple[int, int]:
        """``(index, count)`` of ``coord`` along the named ``axes``
        (a name, a tuple of names in mesh order, or None) taken as one
        axis, the later axis fastest."""
        names = () if axes is None else (axes,) if isinstance(axes, str) \
            else tuple(axes)
        idx, count = 0, 1
        for a in names:
            n = self.shape[a]
            idx = idx * n + coord[self.axis_names.index(a)]
            count *= n
        return idx, count

    def local(self, t: torch.Tensor, spec, coord) -> torch.Tensor:
        """The shard of ``t`` at ``coord`` under ``spec`` (one entry a
        dimension: None, an axis name or a tuple of names): a view."""
        for dim, axes in enumerate(spec):
            i, n = self.index(coord, axes)
            if n > 1:
                m = t.shape[dim] // n
                t = t.narrow(dim, i * m, m)
        return t

    def reduce(self, parts: Dict[Tuple[int, ...], torch.Tensor], axes,
               op: str = "sum") -> Dict[Tuple[int, ...], torch.Tensor]:
        """``psum`` (``op="sum"``) or ``pmean`` (``"mean"``) over the named
        ``axes`` of one tensor a coordinate: each coordinate gets the fold,
        in shard order, of the coordinates that differ from it only on
        ``axes`` (one tensor a group, shared by its members)."""
        assert op in ("sum", "mean"), op
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        pos = [self.axis_names.index(a) for a in names]
        groups: Dict[Tuple[int, ...], List[Tuple[int, ...]]] = {}
        for c in sorted(parts):
            key = tuple(-1 if i in pos else v for i, v in enumerate(c))
            groups.setdefault(key, []).append(c)
        out = {}
        for members in groups.values():
            r = _fold([parts[c] for c in members], "sum")
            if op == "mean":
                r = r / len(members)
            out.update((c, r) for c in members)
        return out
