"""The roofline's per-device analysis of one step (the port's
counterpart of ``repro/launch/hlo_analysis.py``).

The reference parses the compiled, post-SPMD XLA HLO of a step and
re-attributes each op's cost by its loop's trip count. The port makes
no HLO: it runs the step once, on fake tensors when asked
(``FakeTensorMode``: shapes, no data), under :class:`StepCounter`, a
``TorchDispatchMode`` that sees every aten op on the local shards
(DTensor ops are let through to DTensor, as ``CommDebugMode`` does, so
that the counter sees the local ops and collectives they become). It
records the reference's fields:

1. **collective bytes** = Σ operand bytes of every functional and c10d
   collective, keyed by the reference's names (``all-gather``,
   ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
   ``collective-permute``), with their count;
2. **matmul FLOPs** per device, by ``torch.utils.flop_counter``'s
   formulas on the local shapes. The step's loops are unrolled in
   Python, so every trip is counted, and a recomputation under
   ``torch.utils.checkpoint`` is counted where the backward runs it, as
   the reference's trip-count-corrected HLO counts it;
3. **HBM traffic** = Σ result bytes of every aten op, each tensor counted
   once at its definition (the reference's rule), skipping views and the
   collectives' waits, which move no data. The port does not fuse, so
   every intermediate of an elementwise chain counts: the figure is an
   upper bound of the reference's, which counts a fusion's output once;
4. **trip counts** stay ``{}``: the port unrolls its loops.

:func:`analyze_step` also returns the peak of the bytes that the step's
own tensors held at once (the dry run's ``temp_bytes``).

:func:`shape_bytes` and its dtype table are the reference's, copied. The
reference's ``analyze_hlo`` is not ported: nothing in the port makes
HLO text for it to parse.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import re
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "s64": 8, "u64": 8,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1, "f8e3m4": 1, "f8e8m0fnu": 1,
    "f16": 2, "bf16": 2, "f32": 4, "f64": 8, "c64": 8, "c128": 16,
    "token": 0, "opaque": 0,
}

_SHAPE_RE = re.compile(r"(\w+)\[([0-9,]*)\]")

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# an op's name (its overload packet's, without the namespace) → the
# reference's collective name
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast_": "collective-permute", "send": "collective-permute",
    "recv_": "collective-permute", "isend": "collective-permute",
    "irecv": "collective-permute", "batch_p2p_ops": "collective-permute",
}
_NAMESPACES = ("_c10d_functional", "c10d")
_NO_TRAFFIC = {"wait_tensor", "detach", "_to_copy_noop", "lift_fresh",
               "alias"}


def shape_bytes(type_str: str) -> int:
    """Bytes of an HLO type string (handles tuples)."""
    total = 0
    for m in _SHAPE_RE.finditer(type_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


@dataclasses.dataclass
class Analysis:
    collective_bytes: float
    collective_by_type: Dict[str, float]
    collective_count: int
    matmul_flops: float
    hbm_traffic_bytes: float
    trip_counts: Dict[str, int]

    def to_dict(self):
        return dataclasses.asdict(self)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def concrete(v):
    """An int-like as a number: a symbolic size (a ``ShapeEnv``'s, where
    a size depends on the data) at its upper bound."""
    if isinstance(v, (torch.SymInt, torch.SymFloat)):
        up = v.node.shape_env.bound_sympy(v.node.expr).upper
        return float(up)
    return v


def tensor_bytes(t: torch.Tensor) -> int:
    return concrete(t.numel()) * t.element_size()


_ACTIVE = []        # the StepCounters entered, innermost last
# ShardingPropagator's method that runs an op on global fake shapes, by
# the name it has in one PyTorch version or another
_META_PROPAGATION = ("_propagate_tensor_meta_non_cached",
                     "_propagate_tensor_meta")


@contextlib.contextmanager
def planning():
    """Ops run within this context are DTensor's planning, not the
    step's work: the active :class:`StepCounter` does not count them."""
    counter = _ACTIVE[-1] if _ACTIVE else None
    if counter is not None:
        counter._propagating += 1
    try:
        yield
    finally:
        if counter is not None:
            counter._propagating -= 1


class StepCounter(TorchDispatchMode):
    """Counts the collectives (and keeps each one's kind and operand
    shapes, ``coll_shapes``), the matmul FLOPs and the result bytes of
    every aten op run under it, on the local shards, and tracks the
    bytes of the storages those ops made that are still alive: its
    ``peak_bytes``, the most they held at once. The storages of
    ``inputs`` (the step's arguments) are not the step's: an op that
    writes one in place (an optimizer's update, a KV cache's write) makes
    no new bytes. The storages freed are found every ``SWEEP`` new ones,
    and before any new peak is taken, so the peak counts no dead one."""

    SWEEP = 8

    def __init__(self, inputs=()):
        super().__init__()
        self._inputs = {st._cdata for st in _storages(inputs)}
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.flops = 0.0
        self.traffic = 0.0
        self.coll_by_type: Dict[str, float] = collections.defaultdict(float)
        self.coll_count = 0
        self.coll_shapes = []       # (kind, operand shape), in order
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, tuple] = {}
        self._added = 0
        self._propagating = 0

    def __enter__(self):
        # DTensor runs each op once on global fake shapes to learn its
        # output's metadata (``ShardingPropagator``'s tensor-meta
        # propagation, cached by shape); those runs are not the step's
        # work, so they run within ``planning`` while the counter is on.
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as prop
        name = next(n for n in _META_PROPAGATION if hasattr(prop, n))
        orig = getattr(prop, name)

        def planned(*args, **kwargs):
            with planning():
                return orig(*args, **kwargs)
        self._patched = (prop, name, orig)
        setattr(prop, name, planned)
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        setattr(*self._patched)
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor desugars it; see its ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._propagating:           # DTensor's global-shape shadow op
            return out
        packet = func._overloadpacket
        ns = func.namespace
        name = packet.__name__.split(".")[-1]
        if ns in _NAMESPACES and name in _COLLECTIVE_OPS:
            kind = _COLLECTIVE_OPS[name]
            nbytes = sum(tensor_bytes(t) for t in _tensors(args[:1]))
            self.coll_by_type[kind] += nbytes
            self.coll_count += 1
            self.coll_shapes += [(kind, tuple(concrete(d) for d in t.shape))
                                 for t in _tensors(args[:1])]
        if packet in self._flops:
            self.flops += float(concrete(self._flops[packet](
                *args, **kwargs, out_val=out)))
        if not getattr(func, "is_view", False) and name not in _NO_TRAFFIC:
            for t in _tensors(out):
                self.traffic += tensor_bytes(t)
                self._track(t)
        return out

    def _track(self, t: torch.Tensor):
        """Count ``t``'s storage as live until it is freed (a weak
        reference to the storage itself: a tensor that autograd saved
        lives on after its Python object), sweeping the freed ones every
        ``SWEEP`` new storages."""
        from torch.multiprocessing.reductions import StorageWeakRef
        try:
            st = t.untyped_storage()
        except (NotImplementedError, RuntimeError):
            return
        key = st._cdata
        if key in self._inputs:
            return
        entry = self._live.get(key)
        if entry is not None and not entry[0].expired():
            return
        if entry is not None:                  # an address used again
            self.live_bytes -= entry[1]
        self._added += 1
        if self._added % self.SWEEP == 0:
            self._sweep()
        nbytes = concrete(st.nbytes())
        self._live[key] = (StorageWeakRef(st), nbytes)
        self.live_bytes += nbytes
        if self.live_bytes > self.peak_bytes:
            self._sweep()
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _sweep(self):
        """Drop the storages freed since the last sweep."""
        for k in [k for k, (ref, _) in self._live.items() if ref.expired()]:
            self.live_bytes -= self._live.pop(k)[1]

    def analysis(self) -> Analysis:
        by_type = dict(self.coll_by_type)
        return Analysis(collective_bytes=float(sum(by_type.values())),
                        collective_by_type=by_type,
                        collective_count=self.coll_count,
                        matmul_flops=self.flops,
                        hbm_traffic_bytes=self.traffic,
                        trip_counts={})


def _storages(tree):
    """The storages of the tensors in ``tree`` (modules' parameters and
    buffers, a DTensor's local shard), as ``_track`` takes them."""
    from ..models.layers import is_dtensor
    if isinstance(tree, torch.nn.Module):
        tree = list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _storages(t)
    elif isinstance(tree, torch.Tensor):
        t = tree.to_local() if is_dtensor(tree) else tree
        try:
            yield t.untyped_storage()
        except (NotImplementedError, RuntimeError):
            return


def analyze_step(fn: Callable, *args, **kwargs) -> Tuple[Any, Analysis,
                                                          int]:
    """Run ``fn(*args, **kwargs)`` once under a :class:`StepCounter`:
    ``(its result, the Analysis, the peak bytes of the tensors the step
    made that were alive at once)``; the arguments' own storages are
    not the step's."""
    counter = StepCounter((args, kwargs))
    with counter:
        out = fn(*args, **kwargs)
    return out, counter.analysis(), counter.peak_bytes
