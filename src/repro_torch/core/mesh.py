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
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

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
