"""Query evaluation: exact and φ-constrained approximate answering.

Port of :mod:`repro.core.query`. One code path serves both modes (the
exact method is the φ=0 degenerate case that processes every pending
tile), and both query types — a scalar aggregate (:func:`evaluate`) and
a ``bx × by`` heatmap (:func:`evaluate_heatmap`, per-bin counts from one
axis pass, per-bin contributions from one packed
``segment_window_bin_select`` per round):

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

``sequential=True`` selects the per-tile reference path; ``stage`` (an
:class:`~repro_torch.core.index.EpochStage`, batched path only) defers a
query's index mutation to the serving tick's publication.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..data.rawfile import as_host
from .bounds import (AccuracyPolicy, GroupedAccumulator, GroupedPendingTile,
                     HeatmapResult, PendingTile, QueryAccumulator,
                     QueryResult)
from .refine import HeatmapQueryAdapter, RefinementDriver, ScalarQueryAdapter
from ..kernels.ops import window_mask, window_mask_np
from ..kernels.ref import window_bin_ids_np
from ..kernels.segment_agg import agg4, window_bin_ids


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
             sequential: bool = False, stage=None) -> QueryResult:
    t_start = time.perf_counter()
    # a chunk forest drops retired forests and builds the overlapped
    # chunks' indexes BEFORE the per-query snapshot: lazy build cost is
    # index-construction I/O, accounted like legacy engine construction
    prepare = getattr(index, "prepare", None)
    if prepare is not None:
        prepare(window, attr)
    io_before = index.ds.stats.snapshot()
    adapt_before = index.adapt_stats.snapshot()
    index.ensure_attr(attr)

    acc, full_set, n_full, n_partial = _build_accumulator(
        index, window, agg, attr)

    driver = RefinementDriver(
        acc, ScalarQueryAdapter(index, window, attr, full_set), phi, alpha,
        stage=stage)
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


def _build_grouped_accumulator(index, window, agg: str,
                               attr: str, bins):
    """Heatmap steps 1–3: classification + per-bin pending construction.

    ONE gathered axis pass per part gives every non-disjoint tile's
    per-bin in-window counts (no file I/O). A fully-contained tile whose
    valid metadata covers exactly the objects of one bin (all its
    in-window count concentrated there) folds exactly into that bin; a
    tile registered in the part's session bin-grid memory (the host
    port of the SPMD GroupedCache — same window/bins/attr, processed by
    an earlier query, never split since) folds its exact per-bin
    contribution with zero file I/O; every other overlapping tile
    becomes pending with per-bin interval ``cnt_b · [vmin, vmax]``.
    Iterates ``index.parts(window)`` like :func:`_build_accumulator` —
    pending tiles are keyed by global id. ``agg`` is deliberately NOT
    passed to ``parts``: per-bin min/max value pruning with window-level
    occupancy is unsound (a bin may be populated only by the would-be
    pruned chunk), so heatmaps get bbox pruning only.
    """
    bx, by = bins
    acc = GroupedAccumulator(agg, bx * by)
    n_full = n_partial = 0
    for base, ti in index.parts(window, attr):
        ti.ensure_attr(attr)
        full_ids, partial_ids = ti.classify(window)
        full_set = set(int(i) for i in full_ids)
        cand = np.concatenate([full_ids, partial_ids]).astype(np.int64)
        cnt_bs = ti.bin_counts_in_window_batch(cand, window, bins)
        cache = ti.heatmap_cache(window, bins, attr)
        for row, t in enumerate(cand):
            c_b = cnt_bs[row]
            tot = int(c_b.sum())
            if tot == 0:
                continue
            t = int(t)
            is_full = t in full_set
            if is_full:
                n_full += 1
            else:
                n_partial += 1
            if cache is not None and t in cache:
                # session bin-grid memory hit: the tile's exact per-bin
                # in-window contribution, zero file I/O
                rec = cache[t]
                assert np.array_equal(rec[0], c_b), \
                    "stale bin-grid registry entry"
                acc.fold_full_vec(*rec)
                continue
            nz = np.flatnonzero(c_b)
            # metadata-exact path: full tile, valid sum, every owned
            # object selected AND landing in the same bin — the tile's
            # (count, sum, min, max) are that bin's exact contribution,
            # zero file I/O
            if (is_full and ti.meta_valid[attr][t] and len(nz) == 1
                    and tot == int(ti.count[t])):
                b = int(nz[0])
                acc.fold_full_bin(b, tot, ti.meta_sum[attr][t],
                                  ti.meta_min[attr][t],
                                  ti.meta_max[attr][t])
            else:
                acc.add_pending(GroupedPendingTile(
                    tile_id=base + t, cnt_b=c_b.copy(),
                    vmin=float(ti.meta_min[attr][t]),
                    vmax=float(ti.meta_max[attr][t]),
                    cost=int(ti.count[t])))
    return acc, n_full, n_partial


def evaluate_heatmap(index, window, agg: str, attr: str,
                     bins: Tuple[int, int] = (8, 8), phi: float = 0.0,
                     alpha: float = 1.0, *,
                     policy: Optional[AccuracyPolicy] = None,
                     batch_k: Optional[int] = None,
                     sequential: bool = False, stage=None) -> HeatmapResult:
    """φ-constrained heatmap (2-D group-by) over the window's bx×by grid.

    Same evaluation skeleton as :func:`evaluate` — literally the same
    :class:`~repro_torch.core.refine.RefinementDriver` loop — vectorized over
    bins via the :class:`~repro_torch.core.bounds.GroupedAccumulator` and the
    heatmap index adapter: classify, build per-bin pending intervals
    (zero file I/O), then refine until the query-level bound (max
    per-bin relative bound) meets φ, folding each processed tile's whole
    per-bin contribution from one packed ``segment_window_bin_agg`` pass
    per round. Under φ>0, sum/mean rounds are sized by the grouped
    ``min_folds_needed`` bound (zero speculative rows); splits snap to
    this query's bin grid when ``IndexConfig.bin_aligned_splits`` is on.
    ``sequential=True`` is the per-tile reference path the batched
    pipeline must match bit-for-bit on counts, to f64 tolerance on sums,
    and exactly on index evolution.

    ``policy`` allocates the constraint per bin
    (:class:`~repro_torch.core.bounds.AccuracyPolicy`: user weights ×
    salience → φ_b, plus an absolute-error floor ε_abs): refinement
    stops once every occupied bin's deviation fits its OWN budget
    ``max(φ_b·|value_b|, ε_abs)``, tile scoring normalizes CI widths by
    those budgets, and the result carries ``phi_b``/``bin_met``. A
    trivial policy (or φ = 0, the exact method) leaves behavior
    bit-for-bit unchanged.
    """
    t_start = time.perf_counter()
    prepare = getattr(index, "prepare", None)
    if prepare is not None:
        prepare(window, attr)
    io_before = index.ds.stats.snapshot()
    adapt_before = index.adapt_stats.snapshot()
    bx, by = int(bins[0]), int(bins[1])
    assert bx > 0 and by > 0
    assert np.isfinite(np.asarray(window, np.float64)).all(), \
        "heatmap windows must be finite rectangles"
    index.ensure_attr(attr)

    # (no full-tile set here: heatmap refinement splits every processed
    # tile — see HeatmapQueryAdapter)
    acc, n_full, n_partial = _build_grouped_accumulator(
        index, window, agg, attr, (bx, by))
    if policy is not None and phi > 0.0:
        acc.set_policy(policy, phi, (bx, by))

    driver = RefinementDriver(
        acc, HeatmapQueryAdapter(index, window, attr, (bx, by)), phi, alpha,
        stage=stage)
    processed = driver.run(batch_k=batch_k, sequential=sequential)

    values, lo, hi, bin_bound, bound = acc.interval()
    io_delta = index.ds.stats.delta(io_before)
    adapt_delta = index.adapt_stats.delta(adapt_before)
    policy_active = acc.phi_b is not None
    return HeatmapResult(
        agg=agg, attr=attr, bins=(bx, by),
        values=np.asarray(values, np.float64),
        lo=np.asarray(lo, np.float64), hi=np.asarray(hi, np.float64),
        bin_bound=np.asarray(bin_bound, np.float64), bound=float(bound),
        exact=not acc.pending, tiles_full=n_full, tiles_partial=n_partial,
        tiles_processed=processed, objects_read=io_delta.rows_read,
        read_calls=io_delta.read_calls,
        batch_rounds=adapt_delta.batch_rounds,
        speculative_rows=adapt_delta.speculative_rows,
        pruned_chunks=io_delta.pruned_calls,
        retired_during_query=driver.dropped > 0,
        eval_time_s=time.perf_counter() - t_start,
        phi_b=acc.phi_b.copy() if policy_active else None,
        eps_abs=acc.eps_abs,
        bin_met=acc.bin_satisfied(phi) if policy_active else None)


def evaluate_heatmap_oracle(index, window, agg: str, attr: str,
                            bins: Tuple[int, int]) -> np.ndarray:
    """Per-bin ground truth straight off the raw columns (unaccounted;
    tests and the chip smoke).

    Returns a float64 ``(bx*by,)`` vector; empty bins are 0 for
    count/sum/mean and ±inf for min/max (matching
    :class:`~repro_torch.core.bounds.HeatmapResult`). Host data goes
    through the reference's numpy code. Device data is one float64
    keyed reduction on the device — the binning of
    ``segment_agg.window_bin_ids``, bit for bit the host rule — because a
    per-bin loop over a dataset resident on the card would copy it to
    the host bin by bin.
    """
    bx, by = bins
    nbins = bx * by
    ds = index.ds
    vals = ds.read_all_unaccounted(attr)
    if ds.device is None or index.cfg.backend == "np":
        m, cid = window_bin_ids_np(as_host(ds.x), as_host(ds.y), window,
                                   bx, by)
        vals = as_host(vals)
        out = np.zeros(nbins, np.float64)
        if agg == "min":
            out[:] = np.inf
        elif agg == "max":
            out[:] = -np.inf
        for b in range(nbins):
            sel = vals[m & (cid == b)]
            if agg == "count":
                out[b] = float((m & (cid == b)).sum())
            elif sel.size:
                out[b] = {"sum": lambda v: v.sum(dtype=np.float64),
                          "mean": lambda v: v.mean(dtype=np.float64),
                          "min": lambda v: v.min(),
                          "max": lambda v: v.max()}[agg](sel)
        return out
    m, cid = window_bin_ids(ds.x, ds.y, window, bx, by)
    cnt, s, mn, mx = agg4(cid[m], vals[m], nbins).cpu().numpy().T
    if agg == "count":
        return cnt
    if agg == "sum":
        return s
    if agg == "mean":
        return np.where(cnt > 0, s / np.maximum(cnt, 1), 0.0)
    return mn if agg == "min" else mx


def evaluate_oracle(index, window, agg: str, attr: str) -> float:
    """Ground truth straight off the raw columns (unaccounted; tests and
    the chip smoke). Host data goes through the reference's numpy code;
    device data is reduced on the device, sums in float64. A chunked
    dataset's columns are its live chunks' (``ChunkedDataset``'s
    aggregate surface)."""
    ds = index.ds
    vals = ds.read_all_unaccounted(attr)
    if ds.device is None or index.cfg.backend == "np":
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
