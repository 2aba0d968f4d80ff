"""Carrying a cracked index across from the reference package.

:func:`index_from_numpy` builds a port :class:`~repro_torch.core.index.
TileIndex` from plain numpy arrays taken off a reference ``TileIndex``
(the counterpart of carrying a model's weights across), so both packages
can continue from the same cracked index. :func:`index_to_numpy` takes
the same arrays off either package's index (reference or port),
including the session bin-grid memory: the LRU of heatmap registries, in
order, each mapping a tile id to its per-bin ``(cnt_b, sum_b, min_b,
max_b)``. :func:`forest_to_numpy` and :func:`forest_from_numpy` do the
same for a chunk forest (``ChunkIndexSet``), chunk by chunk, keyed by
chunk id. :func:`predictor_to_numpy` and :func:`predictor_from_numpy`
carry a session's viewport predictor (its MLP weights, trajectory and
rolling hit-rates), so a session started in the reference can go on in
the port. :func:`sharded_state_to_numpy` and
:func:`sharded_state_from_numpy` do the same for the SPMD session's
``ShardedTileState`` (the whole ``cell`` plane, in shard order).
"""
from __future__ import annotations

from collections import OrderedDict, deque
from typing import Dict, Optional

import numpy as np
import torch

from ..data.chunked import ChunkedDataset
from ..data.rawfile import RawDataset
from .distributed import ShardedTileState
from .index import ChunkIndexSet, IndexConfig, TileIndex
from .predict import PARAMS, TrajectoryStep, ViewportPredictor, _params_on

TABLE = ("bbox", "offset", "count", "active", "level", "parent")
OBJECTS = ("perm", "x_s", "y_s")
META = ("meta_sum", "meta_min", "meta_max", "meta_valid")


def index_to_numpy(index) -> Dict[str, object]:
    """The state :func:`index_from_numpy` reads: the tile table,
    ``n_tiles``, the perm-order object arrays, per-attribute metadata,
    ``global_minmax`` and the heatmap registries (``hm_regs``: a list of
    ``(key, {tile_id: (cnt_b, sum_b, min_b, max_b)})`` in LRU order) —
    all numpy (device tensors are copied to the host)."""
    out = {k: np.array(getattr(index, k)) for k in TABLE}
    out["n_tiles"] = int(index.n_tiles)
    for k in OBJECTS:
        a = getattr(index, k)
        out[k] = a.cpu().numpy() if isinstance(a, torch.Tensor) \
            else np.array(a)
    for k in META:
        out[k] = {a: np.array(v) for a, v in getattr(index, k).items()}
    out["global_minmax"] = dict(index.global_minmax)
    # least recently touched first; the last key is the current viewport
    out["hm_regs"] = [
        (key, {int(t): tuple(np.array(a) for a in rec)
               for t, rec in reg.items()})
        for key, reg in index._hm_regs.items()]
    return out


def index_from_numpy(dataset: RawDataset, config: Optional[IndexConfig],
                     arrays: Dict[str, object]) -> TileIndex:
    """A port ``TileIndex`` over ``dataset`` holding ``arrays`` (see
    :func:`index_to_numpy`), without an init pass: no I/O is accounted.
    The object arrays go to the dataset's device under "torch"/"cuda"."""
    ti = TileIndex.__new__(TileIndex)
    ti._setup(dataset, config)
    ti.domain = dataset.domain()
    cap = ti.cfg.capacity
    for k in TABLE:
        a = np.asarray(arrays[k])
        if len(a) != cap:
            raise ValueError(f"{k} has {len(a)} rows, capacity is {cap}")
        getattr(ti, k)[...] = a
    ti.n_tiles = int(arrays["n_tiles"])
    for k in OBJECTS:
        a = np.array(arrays[k])
        if len(a) != dataset.n:
            raise ValueError(f"{k} has {len(a)} entries, the dataset "
                             f"{dataset.n}")
        setattr(ti, k, a if ti._np else
                torch.from_numpy(a).to(dataset.device))
    for k in META:
        setattr(ti, k, {a: np.array(v) for a, v in arrays[k].items()})
    ti.global_minmax = {a: (float(lo), float(hi))
                        for a, (lo, hi) in arrays["global_minmax"].items()}
    ti._hm_regs = OrderedDict(
        (key, {int(t): tuple(np.array(a) for a in rec)
               for t, rec in reg.items()})
        for key, reg in arrays.get("hm_regs", ()))
    ti._hm_key = next(reversed(ti._hm_regs), None)
    return ti


def forest_to_numpy(forest) -> Dict[int, Dict[str, object]]:
    """:func:`index_to_numpy` of each built forest of a live chunk, keyed
    by chunk id in build order (a reference or a port
    ``ChunkIndexSet``)."""
    return {int(cid): index_to_numpy(ti)
            for cid, ti in forest._indexes.items()
            if forest.ds.is_live(cid)}


def forest_from_numpy(dataset: ChunkedDataset,
                      config: Optional[IndexConfig],
                      arrays: Dict[int, Dict[str, object]]) -> ChunkIndexSet:
    """A port ``ChunkIndexSet`` over ``dataset`` whose chunks ``arrays``
    names (see :func:`forest_to_numpy`) are built from those arrays, in
    their order, with no I/O accounted; the other chunks stay unbuilt
    and are built lazily as usual. Every forest shares the set's
    ``AdaptStats``."""
    forest = ChunkIndexSet(dataset, config)
    for cid, a in arrays.items():
        ti = index_from_numpy(dataset.chunk(int(cid)).data, forest.cfg, a)
        ti.adapt_stats = forest.adapt_stats
        forest._indexes[int(cid)] = ti
    return forest


HYPER = ("history", "hit_iou", "lr", "train_steps")


def predictor_to_numpy(p) -> Dict[str, object]:
    """The state :func:`predictor_from_numpy` reads off either package's
    ``ViewportPredictor``: the hyper-parameters, the MLP's ``w1, b1, w2,
    b2`` as float32 numpy arrays, the trajectory as ``(window, bins,
    dwell_s)`` tuples, both hit deques with their ``maxlen``, ``source``
    and ``n_trained``."""
    out = {k: getattr(p, k) for k in HYPER}
    out["params"] = {k: np.array(
        v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v,
        np.float32) for k, v in p._params.items()}
    out["trajectory"] = [(tuple(s.window), s.bins, s.dwell_s)
                         for s in p.trajectory]
    out["hits"] = {k: (list(h), h.maxlen) for k, h in p._hits.items()}
    out["source"] = p.source
    out["n_trained"] = int(p.n_trained)
    return out


def predictor_from_numpy(d: Dict[str, object],
                         device="cuda") -> ViewportPredictor:
    """A port ``ViewportPredictor`` holding ``d`` (see
    :func:`predictor_to_numpy`), its MLP on ``device``."""
    roll = d["hits"]["linear"][1]
    p = ViewportPredictor(**{k: d[k] for k in HYPER}, roll=roll,
                          device=device)
    if set(d["params"]) != set(PARAMS):
        raise ValueError(f"params {sorted(d['params'])}, want {PARAMS}")
    p._params = _params_on(d["params"], p.device)
    p.trajectory = [TrajectoryStep(tuple(w), None if b is None
                                   else (int(b[0]), int(b[1])), float(t))
                    for w, b, t in d["trajectory"]]
    p._hits = {k: deque(h, maxlen=m) for k, (h, m) in d["hits"].items()}
    p.source = d["source"]
    p.n_trained = int(d["n_trained"])
    return p


SHARDED = {"cell": torch.int32, "bbox": torch.float32, "active": torch.bool,
           "level": torch.int32, "count": torch.int64,
           "vmin": torch.float32, "vmax": torch.float32,
           "n_tiles": torch.int64}


def sharded_state_to_numpy(state) -> Dict[str, np.ndarray]:
    """The fields of either package's ``ShardedTileState`` as numpy
    arrays (device tensors and sharded jax arrays are gathered to the
    host), in the reference's dtypes' values: ``count`` is integral."""
    out = {}
    for k in SHARDED:
        v = getattr(state, k)
        out[k] = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                  else np.asarray(v))
    return out


def sharded_state_from_numpy(arrays: Dict[str, np.ndarray],
                             device="cuda") -> ShardedTileState:
    """A port ``ShardedTileState`` on ``device`` holding ``arrays`` (see
    :func:`sharded_state_to_numpy`), in the port's dtypes. A count that
    is not a whole number raises."""
    count = np.asarray(arrays["count"])
    if not np.array_equal(count, np.round(count)):
        raise ValueError("tile counts must be whole numbers")
    return ShardedTileState(**{
        k: torch.as_tensor(np.asarray(arrays[k])).to(device=device, dtype=dt)
        for k, dt in SHARDED.items()})
