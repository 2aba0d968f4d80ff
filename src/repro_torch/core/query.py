"""Query evaluation: exact and φ-constrained approximate answering.

Port of the scalar part of :mod:`repro.core.query`. One code path serves
both modes (the exact method is the φ=0 degenerate case that processes
every pending tile):

1. classify active tiles against Q (disjoint / partial / full);
2. fully-contained tiles with valid metadata contribute exactly — zero
   file I/O; fully-contained tiles without usable metadata are queued as
   pending, bounded by their sound min/max;
3. partially-contained tiles: in-window counts come from ONE vectorized
   pass over the axis index (on the device under "torch"/"cuda"); tiles
   with zero selected objects are skipped; the rest become pending;
4. if the bound exceeds φ, :class:`~repro_torch.core.refine.
   RefinementDriver` refines in batched rounds (one gathered read + one
   packed ``segment_window_agg`` kernel per round) until bound ≤ φ.

``sequential=True`` selects the per-tile reference path.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..data.rawfile import as_host
from .bounds import PendingTile, QueryAccumulator, QueryResult
from .refine import RefinementDriver, ScalarQueryAdapter
from ..kernels.ops import window_mask, window_mask_np


def _build_accumulator(index, window, agg: str, attr: str):
    """Steps 1–3: classification + pending-set construction (no file
    I/O). Pending tiles are keyed by global id ``base + local_tile_id``
    over ``index.parts(window)`` (a plain TileIndex is one part, base 0).
    """
    acc = QueryAccumulator(agg)
    full_set = set()
    n_full = n_partial = 0
    for base, ti in index.parts(window, attr, agg):
        ti.ensure_attr(attr)
        full_ids, partial_ids = ti.classify(window)
        for t in full_ids:
            c = int(ti.count[t])
            if c == 0:
                continue
            n_full += 1
            gid = base + int(t)
            full_set.add(gid)
            if ti.meta_valid[attr][t]:
                acc.fold_full(c, ti.meta_sum[attr][t],
                              ti.meta_min[attr][t], ti.meta_max[attr][t])
            else:
                # enrichment pending: bounded by sound (inherited) min/max
                acc.add_pending(PendingTile(
                    tile_id=gid, cnt_q=c,
                    vmin=float(ti.meta_min[attr][t]),
                    vmax=float(ti.meta_max[attr][t]), cost=c))

        # one vectorized axis-index pass per part for count(t∩Q)
        cnt_qs = ti.count_in_window_batch(partial_ids, window)
        for t, cnt_q in zip(partial_ids, cnt_qs):
            if cnt_q == 0:
                continue
            n_partial += 1
            acc.add_pending(PendingTile(
                tile_id=base + int(t), cnt_q=int(cnt_q),
                vmin=float(ti.meta_min[attr][t]),
                vmax=float(ti.meta_max[attr][t]),
                cost=int(ti.count[t])))
    return acc, full_set, n_full, n_partial


def evaluate(index, window, agg: str, attr: str,
             phi: float = 0.0, alpha: float = 1.0, *,
             batch_k: Optional[int] = None,
             sequential: bool = False) -> QueryResult:
    t_start = time.perf_counter()
    io_before = index.ds.stats.snapshot()
    adapt_before = index.adapt_stats.snapshot()
    index.ensure_attr(attr)

    acc, full_set, n_full, n_partial = _build_accumulator(
        index, window, agg, attr)

    driver = RefinementDriver(
        acc, ScalarQueryAdapter(index, window, attr, full_set), phi, alpha)
    processed = driver.run(batch_k=batch_k, sequential=sequential)

    value, lo, hi, bound = acc.interval()
    io_delta = index.ds.stats.delta(io_before)
    adapt_delta = index.adapt_stats.delta(adapt_before)
    return QueryResult(
        agg=agg, attr=attr, value=float(value), lo=float(lo), hi=float(hi),
        bound=float(bound), exact=not acc.pending,
        tiles_full=n_full, tiles_partial=n_partial,
        tiles_processed=processed, objects_read=io_delta.rows_read,
        read_calls=io_delta.read_calls,
        batch_rounds=adapt_delta.batch_rounds,
        speculative_rows=adapt_delta.speculative_rows,
        pruned_chunks=io_delta.pruned_calls,
        retired_during_query=driver.dropped > 0,
        eval_time_s=time.perf_counter() - t_start)


def evaluate_oracle(index, window, agg: str, attr: str) -> float:
    """Ground truth straight off the raw columns (unaccounted; tests and
    the chip smoke). Host data goes through the reference's numpy code;
    device data is reduced on the device, sums in float64."""
    ds = index.ds
    vals = ds.read_all_unaccounted(attr)
    if ds.device is None or index._np:
        m = window_mask_np(as_host(ds.x), as_host(ds.y), window)
        vals = as_host(vals)[m]
        if agg == "count":
            return float(m.sum())
        if len(vals) == 0:
            return {"sum": 0.0, "mean": 0.0, "min": np.inf,
                    "max": -np.inf}[agg]
        return {"sum": float(vals.sum(dtype=np.float64)),
                "mean": float(vals.mean(dtype=np.float64)),
                "min": float(vals.min()),
                "max": float(vals.max())}[agg]
    m = window_mask(ds.x, ds.y, window)
    sel = vals[m]
    n = int(sel.numel())
    if agg == "count":
        return float(n)
    if n == 0:
        return {"sum": 0.0, "mean": 0.0, "min": np.inf,
                "max": -np.inf}[agg]
    if agg in ("sum", "mean"):
        s = float(sel.sum(dtype=torch.float64))
        return s if agg == "sum" else s / n
    return float(sel.min() if agg == "min" else sel.max())
