"""Query / tile confidence intervals and the upper error bound (§3.1),
scalar half.

Port of the scalar part of :mod:`repro.core.bounds`, copied without
change (host numpy/Python float64 arithmetic, so the port's answers
equal the reference's bit for bit):

- *tile confidence interval* for a partially-contained tile t over
  attribute A:  sum: ``[count(t∩Q)·min_A(t), count(t∩Q)·max_A(t)]``;
  min/max: ``[min_A(t), max_A(t)]``.
- *query confidence interval*: exact contributions of fully-contained
  tiles + interval sum over partially-contained tiles. Generalized to
  ``mean`` (sum interval / exact total count) and ``min``/``max``.
- *approximate value*: exact parts + per-tile midpoint estimate.
- *upper error bound*: max distance from the approximate value to either
  interval end, normalized (relative) by |approximate value|.

The accumulator implements the refinement protocol consumed by
:class:`repro_torch.core.refine.RefinementDriver` — ``agg``,
``pending``, ``fold_exact``, ``query_bound`` and ``min_folds_needed``.
The heatmap half (``GroupedAccumulator``, ``AccuracyPolicy``) comes with
the heatmap slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

AGGS = ("sum", "mean", "min", "max", "count")
EPS = 1e-12


@dataclasses.dataclass
class PendingTile:
    tile_id: int
    cnt_q: int          # count(t ∩ Q) — exact, from axis index
    vmin: float         # sound lower bound on A within t
    vmax: float         # sound upper bound on A within t
    cost: int           # objects to read if processed = count(t)

    @property
    def width(self) -> float:
        return self.vmax - self.vmin

    def ci_sum(self):
        return self.cnt_q * self.vmin, self.cnt_q * self.vmax

    def mid(self) -> float:
        return 0.5 * (self.vmin + self.vmax)


@dataclasses.dataclass
class QueryResult:
    agg: str
    attr: str
    value: float
    lo: float
    hi: float
    bound: float           # relative upper error bound actually achieved
    exact: bool
    tiles_full: int = 0
    tiles_partial: int = 0
    tiles_processed: int = 0
    objects_read: int = 0
    read_calls: int = 0        # raw-file read invocations (gathered = 1/round)
    batch_rounds: int = 0      # batched refinement rounds (0 ⇒ sequential)
    speculative_rows: int = 0  # rows read past the stopping point
    pruned_chunks: int = 0     # chunks skipped on their bbox (chunked ds)
    retired_during_query: bool = False  # a chunk retired mid-query; its
    #                            tiles were dropped from the answer set
    eval_time_s: float = 0.0


class QueryAccumulator:
    """Progressive interval accumulator for one (window, agg, attr) query."""

    def __init__(self, agg: str):
        assert agg in AGGS, agg
        self.agg = agg
        # exact parts (full tiles + processed tiles)
        self.ex_cnt = 0
        self.ex_sum = 0.0
        self.ex_min = np.inf
        self.ex_max = -np.inf
        self.pending: Dict[int, PendingTile] = {}
        # cached pending aggregates
        self._p_cnt = 0
        self._p_lo = 0.0
        self._p_hi = 0.0

    # -------------------------- building ----------------------------- #
    def fold_full(self, cnt: int, s: float, vmin: float, vmax: float):
        self.ex_cnt += int(cnt)
        self.ex_sum += float(s)
        if cnt > 0:
            self.ex_min = min(self.ex_min, vmin)
            self.ex_max = max(self.ex_max, vmax)

    def add_pending(self, p: PendingTile):
        if p.cnt_q <= 0:
            return
        self.pending[p.tile_id] = p
        lo, hi = p.ci_sum()
        self._p_cnt += p.cnt_q
        self._p_lo += lo
        self._p_hi += hi

    def fold_exact(self, tile_id: int, cnt_q: int, s_q: float,
                   min_q: float, max_q: float):
        """Processing tile_id replaced its interval with exact values.

        ``cnt_q`` re-measured during processing must equal the pending
        count (both derive from the same axis index) — asserted.
        """
        p = self.pending.pop(tile_id)
        assert p.cnt_q == cnt_q, (p.cnt_q, cnt_q)
        lo, hi = p.ci_sum()
        self._p_cnt -= p.cnt_q
        self._p_lo -= lo
        self._p_hi -= hi
        self.fold_full(cnt_q, s_q, min_q, max_q)

    def drop_pending(self, tile_id: int) -> bool:
        """Remove a pending tile WITHOUT folding it (its chunk retired
        mid-query) — the answer now covers only the still-live data.
        Returns False when the tile was never pending (already folded)."""
        p = self.pending.pop(tile_id, None)
        if p is None:
            return False
        lo, hi = p.ci_sum()
        self._p_cnt -= p.cnt_q
        self._p_lo -= lo
        self._p_hi -= hi
        return True

    # -------------------------- reading ------------------------------ #
    def total_count(self) -> int:
        return self.ex_cnt + self._p_cnt

    def interval(self):
        """(value, lo, hi, relative upper error bound) for current state."""
        agg = self.agg
        if agg == "count":
            v = float(self.total_count())
            return v, v, v, 0.0

        if agg == "sum":
            lo = self.ex_sum + self._p_lo
            hi = self.ex_sum + self._p_hi
            mid = self.ex_sum + sum(p.cnt_q * p.mid()
                                    for p in self.pending.values())
            return mid, lo, hi, _rel_bound(mid, lo, hi)

        if agg == "mean":
            n = self.total_count()
            if n == 0:
                return 0.0, 0.0, 0.0, 0.0
            lo = (self.ex_sum + self._p_lo) / n
            hi = (self.ex_sum + self._p_hi) / n
            mid = (self.ex_sum + sum(p.cnt_q * p.mid()
                                     for p in self.pending.values())) / n
            return mid, lo, hi, _rel_bound(mid, lo, hi)

        if agg == "min":
            if self.total_count() == 0:
                return np.inf, np.inf, np.inf, 0.0
            lo = self.ex_min
            hi = self.ex_min
            for p in self.pending.values():
                lo = min(lo, p.vmin)
                hi = min(hi, p.vmax)
            # no exact part: hi comes only from pending maxima
            if self.ex_cnt == 0:
                hi = min(p.vmax for p in self.pending.values())
            mid = 0.5 * (lo + hi) if np.isfinite(lo) and np.isfinite(hi) \
                else lo
            return mid, lo, hi, _rel_bound(mid, lo, hi)

        # max (mirror of min)
        if self.total_count() == 0:
            return -np.inf, -np.inf, -np.inf, 0.0
        hi = self.ex_max
        lo = self.ex_max
        for p in self.pending.values():
            hi = max(hi, p.vmax)
            lo = max(lo, p.vmin)
        if self.ex_cnt == 0:
            lo = max(p.vmin for p in self.pending.values())
        mid = 0.5 * (lo + hi) if np.isfinite(lo) and np.isfinite(hi) else hi
        return mid, lo, hi, _rel_bound(mid, lo, hi)

    # ---------------------- refinement protocol ----------------------- #
    def query_bound(self) -> float:
        """Stopping quantity for the refinement driver: the current
        relative upper error bound."""
        return self.interval()[3]

    def min_folds_needed(self, remaining, phi: float) -> int:
        """Certain lower bound on how many more folds reach bound ≤ φ.

        For sum/mean the deviation after folding the first j tiles of
        ``remaining`` is deterministic — half the CI width of the
        still-pending tiles (folded tiles contribute exactly) — and the
        approximate value always stays inside the current [lo, hi]. Hence
        ``bound_j ≥ W_j / (2·max(|lo|, |hi|))`` whatever the raw file
        holds, and the sequential stopping rule cannot fire before that
        many folds: a batched round of this size reads ZERO speculative
        rows.
        """
        _, lo, hi, _ = self.interval()
        w = np.array([tile_ci_width(self.pending[t], self.agg)
                      for t in remaining], np.float64)
        if self.agg == "mean":
            w = w / max(self.total_count(), 1)
        v_max = max(abs(lo), abs(hi), EPS)
        suffix = w.sum() - np.cumsum(w)      # pending width after j folds
        hit = np.flatnonzero(suffix <= 2.0 * phi * v_max)
        j = int(hit[0]) + 1 if hit.size else len(remaining)
        return max(1, j)


def _rel_bound(value: float, lo: float, hi: float) -> float:
    """Paper: normalize the max deviation from the CI ends by the value."""
    dev = max(hi - value, value - lo)
    if dev <= 0:
        return 0.0
    return float(dev / max(abs(value), EPS))


def tile_ci_width(p: PendingTile, agg: str) -> float:
    """Width of the tile confidence interval w(t) used by the score."""
    if agg in ("sum", "mean"):
        lo, hi = p.ci_sum()
        return hi - lo
    return p.width  # min/max: value-range width
