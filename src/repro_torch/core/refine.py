"""The refinement driver: one batched classify→score→fold engine.

Port of :mod:`repro.core.refine` (the host driver and both adapters),
copied without change. The driver is parameterized by

- an **accumulator** implementing the refinement protocol
  (:class:`~repro_torch.core.bounds.QueryAccumulator` /
  :class:`~repro_torch.core.bounds.GroupedAccumulator`): ``agg``,
  ``pending``, ``fold_exact(tile_id, *contrib)``, ``query_bound()`` and
  ``min_folds_needed(remaining, phi)``;
- an **index adapter** (:class:`ScalarQueryAdapter` /
  :class:`HeatmapQueryAdapter`) supplying the score order, the per-tile
  reference read (``process_one``), the batched gathered read
  (``read_batch``) and the split policy (``split_flags``).

Round sizing under φ > 0: for sum/mean the accumulator's certain
``min_folds_needed`` sizes rounds that read zero speculative rows; for
min/max a geometric ramp (1, 2, 4, …, k) bounds the overshoot by the
last round. φ = 0 processes every pending tile in full-size rounds.
Refinement side effects apply to exactly the folded prefix of each round
(``TileIndex.apply_batch``), so the index evolves as under the
sequential per-tile reference path (``sequential=True``).

The round cap uses the reference's ``MAX_SEGMENTS``/``MAX_UNROLL``
(:mod:`repro_torch.kernels.segment_agg`): the CUDA kernels need no such
cap, but the round sizes — and so ``read_calls`` and the index
evolution — must stay the reference's. With a ``stage`` (the serving
layer's :class:`~repro_torch.core.index.EpochStage`), a round's side
effects are staged for publication between ticks instead of applied in
place. The SPMD ``EpochDriver`` comes with a later slice of the port.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from . import adapt
from ..kernels.segment_agg import MAX_SEGMENTS, MAX_UNROLL


def met(phi: float, bound: float) -> bool:
    """THE stopping predicate of every refinement backend: an
    approximate query (φ > 0) stops once its stopping quantity — the
    relative bound, or the φ-scaled worst budget ratio under a φ_b
    policy — fits the constraint. φ = 0 is the exact method and never
    stops early. Shared by the host :class:`RefinementDriver` (per-tile
    folds) and the SPMD :class:`EpochDriver` (per-epoch folds)."""
    return phi > 0.0 and bound <= phi


def round_residual(payload):
    """The fused select pass's residual-width row before the round's
    LAST fold, or None when the round carries no suffix widths (scalar
    rounds, dead runs).

    Heatmap read payloads carry the fused kernel's per-bin suffix
    widths (``suffix_w``, rows monotone non-increasing); a chunked
    composite round's widths live per run, and its last interim check
    is the one before the LAST run's last fold — so row ``[-2]`` of the
    last run's matrix is THE row
    :meth:`~repro_torch.core.bounds.GroupedAccumulator.round_certain`
    needs.
    """
    runs = payload.get("runs")
    if runs is not None:
        payload = runs[-1][1]
    sw = payload.get("suffix_w")
    if sw is None or len(sw) < 2:
        return None
    return sw[-2]


class ScalarQueryAdapter:
    """Index adapter for scalar window aggregates.

    Fully-contained pending tiles are enriched, never split — their
    metadata already answers any containing query exactly, so splitting
    them brings no future pruning benefit.
    """

    def __init__(self, index, window, attr: str,
                 full_ids: Sequence[int]):
        self.index = index
        self.window = window
        self.attr = attr
        self.full_set = set(int(i) for i in full_ids)

    def score_order(self, acc, alpha: float) -> List[int]:
        return adapt.score_tiles(acc.pending, acc.agg, alpha)

    def process_one(self, tile_id: int):
        # tile ids are GLOBAL: a chunked forest routes them to the
        # owning chunk's TileIndex (a plain TileIndex resolves to itself)
        ti, t = self.index.resolve(tile_id)
        return ti.process(t, self.window, self.attr,
                          split=tile_id not in self.full_set)

    def read_batch(self, tile_ids):
        return self.index.read_batch(tile_ids, self.window, self.attr)

    def split_flags(self, tile_ids) -> List[bool]:
        return [t not in self.full_set for t in tile_ids]

    def max_split_cells(self) -> int:
        # scalar refinement always splits on the even grid — bin-count-
        # matched grids are a heatmap-only policy
        gx, gy = self.index.cfg.split_grid
        return gx * gy


class HeatmapQueryAdapter:
    """Index adapter for heatmap (2-D group-by) queries.

    Unlike the scalar policy, heatmap refinement splits EVERY processed
    tile: a full tile spanning several bins must be re-read by every
    future heatmap until its descendants nest inside single bins and
    answer from metadata. Splits are bin-aligned when
    ``IndexConfig.bin_aligned_splits`` is set: the index snaps each
    tile's split lines to this query's bin grid so children nest after
    ONE split (see ``TileIndex.process_heatmap`` /
    ``read_batch_heatmap``).
    """

    def __init__(self, index, window, attr: str,
                 bins: Tuple[int, int]):
        self.index = index
        self.window = window
        self.attr = attr
        self.bins = (int(bins[0]), int(bins[1]))

    def score_order(self, acc, alpha: float) -> List[int]:
        # under an AccuracyPolicy the accumulator supplies per-bin
        # budget weights (1/τ_b) so the score ranks tiles by their worst
        # budget-normalized CI width; None ⇒ the uniform-φ order
        return adapt.score_tiles_grouped(acc.pending, acc.agg, alpha,
                                         bin_weight=acc.score_bin_weight())

    def process_one(self, tile_id: int):
        ti, t = self.index.resolve(tile_id)
        return ti.process_heatmap(t, self.window, self.attr,
                                  self.bins, split=True)

    def read_batch(self, tile_ids):
        return self.index.read_batch_heatmap(tile_ids, self.window,
                                             self.attr, self.bins)

    def split_flags(self, tile_ids) -> List[bool]:
        return [True] * len(tile_ids)

    def max_split_cells(self) -> int:
        return self.index.cfg.max_split_cells()


class RefinementDriver:
    """One score → round-size → read → fold → apply loop for every query
    type; see the module docstring for the contract."""

    def __init__(self, acc, adapter, phi: float, alpha: float = 1.0,
                 stage=None):
        # the index is the adapter's: reads, splits, and accounting must
        # hit the same object, so the driver never takes a separate one.
        # It may be a TileIndex or a ChunkIndexSet — both present cfg,
        # adapt_stats, read/apply_batch; the driver is chunk-agnostic
        # (a chunked round's gathered read fans out to one read per
        # same-chunk run under the hood, still ONE driver round).
        self.index = adapter.index
        self.acc = acc
        self.adapter = adapter
        self.phi = float(phi)
        self.alpha = float(alpha)
        # epoch publication seam (serving layer): when set, refinement
        # side effects are STAGED on this EpochStage instead of applied in
        # place — the index stays frozen until the scheduler publishes the
        # epoch between ticks. Read-only w.r.t. answers: a query's rounds
        # touch disjoint tiles, so deferring applies past its own reads
        # never changes its fold decisions.
        self.stage = stage
        # pending tiles dropped because their chunk retired mid-query
        # (the answer then covers only the still-live data)
        self.dropped = 0

    def _met(self, bound: float) -> bool:
        return met(self.phi, bound)

    def run(self, *, batch_k: Optional[int] = None,
            sequential: bool = False) -> int:
        """Refine until the bound meets φ (or pending is exhausted).

        Returns the number of tiles processed (folded). Mutates the
        accumulator and — through ``process_one`` / ``apply_batch`` —
        the index.
        """
        acc, phi = self.acc, self.phi
        bound = acc.query_bound()
        if not acc.pending or self._met(bound):
            return 0
        order = self.adapter.score_order(acc, self.alpha)
        if sequential:
            assert self.stage is None, \
                "epoch staging requires the batched path"
            return self._run_sequential(order, bound)
        return self._run_batched(order, bound, batch_k)

    def _run_sequential(self, order, bound) -> int:
        """Per-tile reference path: one read + one kernel per tile. The
        batched path must match it bit-for-bit on counts and index
        evolution, to f64 tolerance on sums."""
        acc = self.acc
        processed = 0
        for t in order:
            if self._met(bound):
                break
            contrib = self.adapter.process_one(t)
            if contrib is None:          # chunk retired mid-query
                acc.drop_pending(t)
                self.dropped += 1
            else:
                acc.fold_exact(t, *contrib)
                processed += 1
            bound = acc.query_bound()
        return processed

    def _run_batched(self, order, bound, batch_k: Optional[int]) -> int:
        acc, phi, index = self.acc, self.phi, self.index
        k = index.cfg.batch_k if batch_k is None else int(batch_k)
        # packed kernels unroll statically over segments (and cells in
        # the split kernel) — cap the round size at their limits, sized
        # by the LARGEST split grid this adapter's rounds may carry
        # (heatmap: bin-count-matched grids up to max_split_span per
        # axis; scalar: the even split_grid)
        k = max(1, min(k, MAX_SEGMENTS,
                       MAX_UNROLL // self.adapter.max_split_cells()))
        # Round sizing under φ>0: the stopping rule can fire mid-round
        # and rows read past it are speculative. For sum/mean the needed
        # fold count has a certain lower bound (min_folds_needed) —
        # rounds sized by it read no speculative rows at all; for
        # min/max a geometric ramp (1, 2, 4, …, k) bounds the overshoot
        # by the last round. φ=0 processes every pending tile anyway →
        # full-size rounds, zero waste.
        predictive = phi > 0.0 and acc.agg in ("sum", "mean")
        size = 1 if phi > 0.0 else k
        processed, pos, stop = 0, 0, False
        while pos < len(order) and not stop and not self._met(bound):
            if predictive:
                size = acc.min_folds_needed(order[pos:], phi)
            batch = order[pos:pos + min(size, k)]
            pos += len(batch)
            if not predictive:
                size = min(size * 2, k)
            contribs, payload = self.adapter.read_batch(batch)
            n_used = 0
            wholesale = all(c is not None for c in contribs)
            if wholesale and not predictive and len(batch) > 1:
                # the fused select pass's suffix widths extend the
                # certainty fast path beyond predictive sizing: if the
                # residual width entering the round's LAST fold already
                # exceeds some bin's budget, no interim stopping check
                # can pass (suffix rows are non-increasing) — covers
                # φ=0 and full-size rounds the sizing argument doesn't.
                # (Single-tile rounds have no interim check at all.)
                row = round_residual(payload)
                wholesale = row is not None and acc.round_certain(row, phi)
            if wholesale:
                # certainty fast path: the stopping rule provably cannot
                # fire before the round's last fold (min_folds_needed is
                # a CERTAIN lower bound; round_certain is its reverse) —
                # every interim _met/query_bound of the loop below is a
                # no-op. Fold the whole batch and re-derive the bound
                # once. (Any dropped tile falls back to the per-fold
                # loop: a drop removes width differently from a fold
                # and the certainty arguments no longer cover it.)
                for t, contrib in zip(batch, contribs):
                    acc.fold_exact(t, *contrib)
                n_used = len(batch)
                processed += len(batch)
                bound = acc.query_bound()
                contribs = ()            # consumed
            for t, contrib in zip(batch, contribs):
                if self._met(bound):
                    stop = True
                    break
                if contrib is None:      # chunk retired mid-query: drop
                    # the tile from the answer set. It still counts into
                    # the applied prefix — its (dead) payload applies as
                    # a no-op, keeping the prefix aligned for live runs
                    acc.drop_pending(t)
                    self.dropped += 1
                    n_used += 1
                    bound = acc.query_bound()
                    continue
                acc.fold_exact(t, *contrib)
                n_used += 1
                processed += 1
                bound = acc.query_bound()
            # rows of tiles read this round but never folded were
            # speculative — account them so predictive sizing's zero-
            # overshoot guarantee is observable per query
            bounds_ = payload["bounds"]
            index.adapt_stats.speculative_rows += int(
                bounds_[len(batch)] - bounds_[n_used])
            # refinement applies to exactly the folded prefix, so the
            # index evolves bit-for-bit as under sequential processing —
            # either in place, or staged for epoch publication when the
            # serving layer holds the index frozen for concurrent readers
            flags = self.adapter.split_flags(batch[:n_used])
            if self.stage is not None:
                self.stage.stage_apply(index, payload, n_used, flags)
            else:
                index.apply_batch(payload, n_used, flags)
        return processed
