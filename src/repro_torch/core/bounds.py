"""Query / tile confidence intervals and the upper error bound (§3.1).

Port of :mod:`repro.core.bounds`, copied without
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

The accumulators implement the refinement protocol consumed by
:class:`repro_torch.core.refine.RefinementDriver` — ``agg``,
``pending``, ``fold_exact``, ``query_bound`` and ``min_folds_needed``.

Heatmap half (port of ``repro/core/bounds.py:69-210, 402-797``, copied
without change): :class:`GroupedAccumulator` generalizes the machinery
to a ``bx × by`` grid of bins — a pending tile contributes
``cnt_b · [vmin, vmax]`` to every bin it touches (per-bin counts are
exact, from the axis index) and the query-level bound is the max
per-bin relative bound over occupied bins — and
:class:`AccuracyPolicy` turns the scalar φ into a per-bin vector φ_b
with an absolute-error floor ε_abs (budget algebra in
:func:`phi_budgets` / :func:`budget_ratios` / :func:`bin_budgets_met`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np

AGGS = ("sum", "mean", "min", "max", "count")
EPS = 1e-12


def phi_budgets(phi_b, denom, eps_abs, xp=np):
    """Per-bin deviation budgets ``τ_b = max(φ_b·denom_b, ε_abs)``.

    ``φ_b = ∞`` (don't-care bins) stays ∞ against any positive denom —
    the numpy path silences the spurious invalid-op warning that inf ×
    finite raises under errstate-strict test configs.
    """
    if xp is np:
        with np.errstate(invalid="ignore"):
            return np.maximum(np.asarray(phi_b) * denom, eps_abs)
    return xp.maximum(phi_b * denom, eps_abs)


def budget_ratios(dev, tau, xp=np):
    """Per-bin budget ratios ``dev_b/τ_b`` with ``τ_b = ∞`` → 0 (a
    don't-care bin never contributes to the worst ratio). ``τ_b`` is
    positive by construction (φ_b > 0 validated, denom ≥ EPS), so the
    division is taken raw — no clamp that would soften a tight budget."""
    if xp is np:
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(np.isinf(tau), 0.0, dev / tau)
    return xp.where(xp.isinf(tau), 0.0, dev / tau)


def bin_budgets_met(dev, values, phi_b, eps_abs, occ, xp=np,
                    rtol=1e-12):
    """Per-bin verdict: occupied bin b is satisfied when its deviation
    fits its own budget ``dev_b ≤ max(φ_b·|value_b|, ε_abs)``.
    Unoccupied / infinite-deviation / zero-deviation bins are True."""
    tau = phi_budgets(phi_b, xp.maximum(xp.abs(values), EPS), eps_abs,
                      xp=xp)
    fin = occ & xp.isfinite(dev) & (dev > 0)
    return ~fin | (dev <= tau * (1 + rtol))


@dataclasses.dataclass(frozen=True)
class AccuracyPolicy:
    """Per-bin accuracy allocation for heatmap queries.

    Composes the query's scalar constraint φ into a per-bin vector φ_b
    and an absolute-error floor:

    - ``weights`` — per-bin multipliers on φ (flat ``(bx·by,)`` or grid
      ``(by, bx)``; broadcastable scalar allowed). ``w_b > 1`` loosens a
      bin, ``w_b < 1`` tightens it, ``np.inf`` means "don't care" (the
      bin never blocks refinement and never attracts effort).
    - ``salience`` — rendered-pixel importance in ``(0, 1]``: the string
      ``"center"`` (a viewport-center-weighted falloff — the bins the
      eye fixates get the tight constraint, the periphery relaxes
      toward ``φ/salience_floor``), the string ``"learned"`` (resolved
      by the engines into the session's per-bin dwell histogram), or a caller-supplied per-bin mask of
      the same shapes as ``weights``. φ_b is divided by salience, so
      ``s_b = 1`` keeps φ and ``s_b → 0⁺`` loosens without bound.
    - ``eps_abs`` — absolute deviation floor: bin b's budget is
      ``max(φ_b·|value_b|, ε_abs)``, so a near-zero-valued bin stops
      once its CI half-width is within ε_abs instead of refining to
      exactness (the uniform-φ failure mode on skewed data).

    The policy only modulates an approximate query (φ > 0); φ = 0 stays
    the exact method regardless. All three components are optional —
    ``AccuracyPolicy()`` is the uniform policy and leaves behavior (and
    the refinement order) bit-for-bit unchanged.
    """
    weights: Optional[Union[float, np.ndarray]] = None
    eps_abs: float = 0.0
    salience: Optional[Union[str, np.ndarray]] = None
    salience_floor: float = 0.25

    def __post_init__(self):
        if self.eps_abs < 0:
            raise ValueError(f"eps_abs must be >= 0, got {self.eps_abs}")
        if not 0.0 < self.salience_floor <= 1.0:
            raise ValueError("salience_floor must be in (0, 1], got "
                             f"{self.salience_floor}")
        if isinstance(self.salience, str) and self.salience not in (
                "center", "learned"):
            raise ValueError("salience must be 'center', 'learned', or a "
                             f"per-bin array, got {self.salience!r}")

    def is_uniform(self) -> bool:
        """True when the policy cannot change any bin's budget relative
        to the plain scalar-φ path (weights/salience/floor all trivial)."""
        return (self.weights is None and self.salience is None
                and self.eps_abs == 0.0)

    @staticmethod
    def _flat(a, bins, name: str) -> np.ndarray:
        """Accepts a scalar, a flat ``(bx·by,)`` vector, or a ``(by, bx)``
        grid; returns the flat per-bin vector."""
        bx, by = bins
        a = np.asarray(a, np.float64)
        if a.shape == ():
            return np.full(bx * by, float(a))
        if a.shape in ((bx * by,), (by, bx)):
            return a.reshape(-1).copy()
        raise ValueError(f"{name} shape {a.shape} does not match "
                         f"bins {bins}")

    def salience_map(self, bins: Tuple[int, int]) -> np.ndarray:
        """Per-bin salience ``s_b ∈ (0, 1]`` (flat, bin id = by_row·bx +
        bx_col). ``None`` ⇒ all ones; ``"center"`` ⇒ linear falloff with
        distance from the viewport center, clamped at salience_floor."""
        bx, by = bins
        if self.salience is None:
            return np.ones(bx * by)
        if isinstance(self.salience, str) and self.salience == "learned":
            # "learned" is a marker the front-ends materialize from the
            # session's dwell histogram BEFORE evaluation (see
            # repro_torch.core.predict.resolve_learned_salience); reaching
            # the accumulator unresolved means the query bypassed them
            raise ValueError(
                "salience='learned' must be resolved to a per-bin map "
                "before evaluation — route the query through AQPEngine/"
                "ServingEngine, or call "
                "repro_torch.core.predict.resolve_learned_salience yourself")
        if isinstance(self.salience, str):  # "center" (validated above)
            cx = (np.arange(bx) + 0.5) / bx - 0.5
            cy = (np.arange(by) + 0.5) / by - 0.5
            d = np.hypot(*np.meshgrid(cx, cy))       # (by, bx)
            d = d / max(float(d.max()), EPS)         # 0 center … 1 corner
            s = self.salience_floor + (1.0 - self.salience_floor) * (1 - d)
            return s.reshape(-1)
        s = self._flat(self.salience, bins, "salience")
        if not ((s > 0) & (s <= 1)).all():
            raise ValueError("salience values must lie in (0, 1]")
        return s

    def phi_b(self, phi: float, bins: Tuple[int, int]) -> np.ndarray:
        """The composed per-bin constraint vector
        ``φ_b = φ · weights_b / salience_b`` (flat ``(bx·by,)``)."""
        bx, by = bins
        out = np.full(bx * by, float(phi))
        if self.weights is not None:
            w = self._flat(self.weights, bins, "weights")
            if not (w > 0).all():
                raise ValueError("weights must be > 0 (use np.inf for "
                                 "don't-care bins)")
            out *= w
        out /= self.salience_map(bins)
        return out


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


@dataclasses.dataclass
class GroupedPendingTile:
    """A pending tile's per-bin interval contribution to a heatmap query.

    ``cnt_b[b] = count(t ∩ Q ∩ bin_b)`` is exact (axis index, zero file
    I/O); the value bounds ``[vmin, vmax]`` are the tile's sound metadata
    interval, shared by every bin the tile touches.
    """
    tile_id: int
    cnt_b: np.ndarray    # int64 (nbins,) — exact per-bin in-window counts
    vmin: float          # sound lower bound on A within t
    vmax: float          # sound upper bound on A within t
    cost: int            # objects to read if processed = count(t)

    @property
    def width(self) -> float:
        return self.vmax - self.vmin


@dataclasses.dataclass
class HeatmapResult:
    """Per-bin approximate values + deterministic per-bin intervals.

    Flat per-bin arrays of length ``bx*by``; bin id = by_row*bx + bx_col
    (the kernels' row-major-y layout). ``bound`` is the query-level
    relative upper error bound = max over occupied bins of ``bin_bound``.
    Empty bins carry value 0 (count/sum/mean) or ±inf (min/max) with
    bin_bound 0.
    """
    agg: str
    attr: str
    bins: Tuple[int, int]      # (bx, by)
    values: np.ndarray         # float64 (bx*by,)
    lo: np.ndarray
    hi: np.ndarray
    bin_bound: np.ndarray      # per-bin relative upper error bound
    bound: float               # max per-bin bound actually achieved
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
    # per-bin allocation (AccuracyPolicy queries; None ⇒ uniform φ).
    # NOTE: under a non-trivial policy the query-level ``bound`` (max
    # RELATIVE per-bin bound) may legitimately exceed φ — ``bin_met`` is
    # the per-bin verdict against each bin's own budget
    # ``max(φ_b·|value_b|, ε_abs)``.
    phi_b: Optional[np.ndarray] = None
    eps_abs: float = 0.0
    bin_met: Optional[np.ndarray] = None

    def grid(self, a: Optional[np.ndarray] = None) -> np.ndarray:
        """Reshape a per-bin vector (default: values) to (by, bx)."""
        a = self.values if a is None else a
        bx, by = self.bins
        return np.asarray(a).reshape(by, bx)


class GroupedAccumulator:
    """Vectorized per-bin interval accumulator for one heatmap query.

    The scalar :class:`QueryAccumulator` machinery generalized from one
    (exact, pending) partition to ``nbins`` of them: exact parts and the
    cached pending sums are (nbins,) arrays, a fold moves one tile's
    whole per-bin vector from interval- to exact-contribution, and
    ``interval()`` returns per-bin values/CI plus the query-level bound
    (max per-bin relative bound over occupied bins). Fold order and the
    cached-sum arithmetic mirror the scalar accumulator exactly, so the
    batched and sequential heatmap paths stay bit-for-bit comparable.

    With an :class:`AccuracyPolicy` attached (:meth:`set_policy`), the
    uniform per-bin-max stopping rule generalizes to the per-bin vector
    φ_b: bin b's deviation budget is ``τ_b = max(φ_b·|value_b|, ε_abs)``
    and the driver's stopping quantity (:meth:`query_bound`) becomes the
    φ-scaled worst budget ratio ``φ · max_b dev_b/τ_b`` — ≤ φ exactly
    when EVERY occupied bin fits its own budget, and identical to the
    plain max-relative-bound when the policy is uniform.
    """

    def __init__(self, agg: str, nbins: int):
        assert agg in AGGS, agg
        self.agg = agg
        self.nbins = nbins
        # per-bin constraint allocation (None ⇒ the uniform scalar-φ
        # stopping rule, bit-for-bit the pre-policy behavior)
        self._phi_b: Optional[np.ndarray] = None
        self._eps_abs = 0.0
        self._phi_ref = 0.0
        # exact parts (single-bin full tiles + processed tiles), per bin
        self.ex_cnt = np.zeros(nbins, np.int64)
        self.ex_sum = np.zeros(nbins, np.float64)
        self.ex_min = np.full(nbins, np.inf)
        self.ex_max = np.full(nbins, -np.inf)
        self.pending: Dict[int, GroupedPendingTile] = {}
        # cached pending aggregates (sum/mean path), per bin
        self._p_cnt = np.zeros(nbins, np.int64)
        self._p_lo = np.zeros(nbins, np.float64)
        self._p_hi = np.zeros(nbins, np.float64)
        self._p_mid = np.zeros(nbins, np.float64)

    # -------------------------- building ----------------------------- #
    def fold_full_bin(self, b: int, cnt: int, s: float, vmin: float,
                      vmax: float):
        """A full tile nested inside one bin contributes its metadata
        exactly to that bin — zero file I/O."""
        self.ex_cnt[b] += int(cnt)
        self.ex_sum[b] += float(s)
        if cnt > 0:
            self.ex_min[b] = min(self.ex_min[b], vmin)
            self.ex_max[b] = max(self.ex_max[b], vmax)

    def fold_full_vec(self, cnt_b, sum_b, min_b, max_b):
        """Exact per-bin contribution of a whole tile across MANY bins —
        the session bin-grid memory's fold (a registry hit replays the
        tile's processed contribution with zero file I/O)."""
        cnt_b = np.asarray(cnt_b, np.int64)
        self.ex_cnt += cnt_b
        self.ex_sum += np.asarray(sum_b, np.float64)
        nz = cnt_b > 0
        self.ex_min[nz] = np.minimum(self.ex_min[nz], np.asarray(
            min_b, np.float64)[nz])
        self.ex_max[nz] = np.maximum(self.ex_max[nz], np.asarray(
            max_b, np.float64)[nz])

    def add_pending(self, p: GroupedPendingTile):
        if p.cnt_b.sum() <= 0:
            return
        self.pending[p.tile_id] = p
        cb = p.cnt_b.astype(np.float64)
        self._p_cnt += p.cnt_b
        self._p_lo += cb * p.vmin
        self._p_hi += cb * p.vmax
        self._p_mid += cb * (0.5 * (p.vmin + p.vmax))

    def fold_exact(self, tile_id: int, cnt_b, sum_b, min_b, max_b):
        """Processing tile_id replaced its per-bin intervals with exact
        values. ``cnt_b`` re-measured during processing must equal the
        pending counts (both derive from the same axis-index binning
        rule) — asserted."""
        p = self.pending.pop(tile_id)
        cnt_b = np.asarray(cnt_b, np.int64)
        assert np.array_equal(p.cnt_b, cnt_b), tile_id
        cb = p.cnt_b.astype(np.float64)
        self._p_cnt -= p.cnt_b
        self._p_lo -= cb * p.vmin
        self._p_hi -= cb * p.vmax
        self._p_mid -= cb * (0.5 * (p.vmin + p.vmax))
        self.ex_cnt += cnt_b
        self.ex_sum += np.asarray(sum_b, np.float64)
        nz = cnt_b > 0
        self.ex_min = np.where(nz, np.minimum(self.ex_min, min_b),
                               self.ex_min)
        self.ex_max = np.where(nz, np.maximum(self.ex_max, max_b),
                               self.ex_max)

    def drop_pending(self, tile_id: int) -> bool:
        """Remove a pending tile WITHOUT folding it (its chunk retired
        mid-query) — the answer now covers only the still-live data.
        Returns False when the tile was never pending (already folded)."""
        p = self.pending.pop(tile_id, None)
        if p is None:
            return False
        cb = p.cnt_b.astype(np.float64)
        self._p_cnt -= p.cnt_b
        self._p_lo -= cb * p.vmin
        self._p_hi -= cb * p.vmax
        self._p_mid -= cb * (0.5 * (p.vmin + p.vmax))
        return True

    # -------------------------- reading ------------------------------ #
    def interval(self):
        """(values, lo, hi, bin_bound, bound): per-bin state + the
        query-level relative upper error bound."""
        agg = self.agg
        n = self.ex_cnt + self._p_cnt
        occ = n > 0
        if agg == "count":
            v = n.astype(np.float64)
            return (v, v.copy(), v.copy(), np.zeros(self.nbins), 0.0)

        if agg in ("sum", "mean"):
            lo = self.ex_sum + self._p_lo
            hi = self.ex_sum + self._p_hi
            mid = self.ex_sum + self._p_mid
            if agg == "mean":
                d = np.maximum(n, 1).astype(np.float64)  # n=0 bins are 0/1
                lo, hi, mid = lo / d, hi / d, mid / d
            bb = _rel_bound_vec(mid, lo, hi, occ)
            return mid, lo, hi, bb, float(bb.max(initial=0.0))

        # min / max: recompute over the pending set (no O(1) cache; the
        # per-call cost is O(#pending · nbins), vectorized)
        if self.pending:
            ps = list(self.pending.values())
            touch = np.stack([p.cnt_b > 0 for p in ps])
            vmins = np.array([p.vmin for p in ps])[:, None]
            vmaxs = np.array([p.vmax for p in ps])[:, None]
        if agg == "min":
            if self.pending:
                p_lo = np.where(touch, vmins, np.inf).min(axis=0)
                p_hi = np.where(touch, vmaxs, np.inf).min(axis=0)
            else:
                p_lo = p_hi = np.full(self.nbins, np.inf)
            lo = np.minimum(self.ex_min, p_lo)
            hi = np.minimum(self.ex_min, p_hi)
            mid = np.where(np.isfinite(lo) & np.isfinite(hi),
                           0.5 * (lo + hi), lo)
        else:  # max (mirror of min)
            if self.pending:
                p_hi = np.where(touch, vmaxs, -np.inf).max(axis=0)
                p_lo = np.where(touch, vmins, -np.inf).max(axis=0)
            else:
                p_lo = p_hi = np.full(self.nbins, -np.inf)
            hi = np.maximum(self.ex_max, p_hi)
            lo = np.maximum(self.ex_max, p_lo)
            mid = np.where(np.isfinite(lo) & np.isfinite(hi),
                           0.5 * (lo + hi), hi)
        bb = _rel_bound_vec(mid, lo, hi, occ)
        return mid, lo, hi, bb, float(bb.max(initial=0.0))

    # ---------------------- refinement protocol ----------------------- #
    def set_policy(self, policy: "AccuracyPolicy", phi: float,
                   bins: Tuple[int, int]):
        """Attach a per-bin constraint allocation for this query.

        Resolves the policy against (φ, bins) once; a trivial/uniform
        policy is dropped so the plain path stays bit-for-bit unchanged
        (including the tile score order).
        """
        if policy is None or policy.is_uniform():
            return
        phi_b = policy.phi_b(phi, bins)
        assert phi_b.shape == (self.nbins,), (phi_b.shape, self.nbins)
        self._phi_b = phi_b
        self._eps_abs = float(policy.eps_abs)
        self._phi_ref = float(phi)

    @property
    def phi_b(self) -> Optional[np.ndarray]:
        """The attached per-bin constraint vector (None ⇒ uniform φ)."""
        return self._phi_b

    @property
    def eps_abs(self) -> float:
        return self._eps_abs

    def _budgets(self, denom: np.ndarray) -> np.ndarray:
        """Per-bin deviation budgets ``τ_b = max(φ_b·denom_b, ε_abs)``
        (requires an attached policy; delegates to the shared pure-array
        helper :func:`phi_budgets`)."""
        return phi_budgets(self._phi_b, denom, self._eps_abs)

    def query_bound(self) -> float:
        """Stopping quantity for the refinement driver.

        Uniform policy: the query-level bound = max per-bin relative
        bound over occupied bins. With a φ_b allocation attached: the
        φ-scaled worst budget ratio ``φ · max_b dev_b/τ_b`` over
        occupied bins, so the driver's unchanged ``bound ≤ φ`` test
        fires exactly when every bin fits its own budget.
        """
        if self._phi_b is None:
            return self.interval()[4]
        values, lo, hi, _, _ = self.interval()
        occ = (self.ex_cnt + self._p_cnt) > 0
        with np.errstate(invalid="ignore"):
            dev = np.maximum(hi - values, values - lo)
        tau = self._budgets(np.maximum(np.abs(values), EPS))
        m = occ & np.isfinite(dev) & (dev > 0)
        if not m.any():
            return 0.0
        ratio = budget_ratios(dev[m], tau[m])
        return float(self._phi_ref * ratio.max(initial=0.0))

    def bin_satisfied(self, phi: float):
        """Per-bin verdict against each bin's own budget: occupied bin b
        is satisfied when ``dev_b ≤ max(φ_b·|value_b|, ε_abs)`` (uniform
        policy ⇒ φ_b = φ, ε_abs = 0). Unoccupied bins are True."""
        values, lo, hi, _, _ = self.interval()
        occ = (self.ex_cnt + self._p_cnt) > 0
        with np.errstate(invalid="ignore"):
            dev = np.maximum(hi - values, values - lo)
        phi_b = (np.full(self.nbins, float(phi)) if self._phi_b is None
                 else self._phi_b)
        return bin_budgets_met(dev, values, phi_b, self._eps_abs, occ)

    def score_bin_weight(self) -> Optional[np.ndarray]:
        """Per-bin urgency weights for the grouped tile score, or
        ``None`` under the uniform policy (preserving the plain score
        order bit-for-bit). With a φ_b allocation the weight is the
        inverse deviation budget ``1/τ_b`` evaluated at the current
        interval — a tile's score becomes its worst *budget-normalized*
        per-bin CI width, so refinement effort flows to the bins whose
        constraints are tight (don't-care bins, φ_b = ∞, weigh 0)."""
        if self._phi_b is None:
            return None
        _, lo, hi, _, _ = self.interval()
        v_max = np.maximum(np.maximum(np.abs(lo), np.abs(hi)), EPS)
        tau = self._budgets(v_max)
        with np.errstate(divide="ignore"):
            return np.where(np.isinf(tau), 0.0, 1.0 / np.maximum(tau, EPS))

    def min_folds_needed(self, remaining, phi: float) -> int:
        """Certain lower bound on the folds needed for the per-bin-max
        stopping rule to reach bound ≤ φ (grouped analog of the scalar
        :meth:`QueryAccumulator.min_folds_needed`).

        For sum/mean, bin b's deviation after folding the first j tiles
        of ``remaining`` is exactly half its remaining pending width
        ``W_jb`` (per-bin counts are exact, so folding tile t removes its
        ``cnt_b·(vmax−vmin)`` contribution deterministically), and every
        bin's approximate value stays inside its current ``[lo_b, hi_b]``
        (a fold replaces an interval with an exact value inside it, so
        intervals only shrink). Hence

            bound_jb ≥ W_jb / (2·max(|lo_b|, |hi_b|, EPS))

        whatever the raw file holds, and the per-bin-max rule cannot fire
        before the smallest j at which EVERY bin's certain bound is ≤ φ.
        One cumsum over the (tiles × bins) pending-width matrix gives all
        suffixes at once; a round sized by the result reads zero
        speculative rows (it replaces the heatmap geometric ramp).

        Under a φ_b allocation the per-bin threshold generalizes to the
        deviation budget: ``W_jb/2 ≤ max(φ_b·v_max_b, ε_abs)``. The
        budget actually applied at fold j uses ``|value_jb| ≤ v_max_b``
        (values stay inside their shrinking intervals), so this
        threshold still only over-estimates the budget — the bound stays
        certain and φ_b-sized rounds still read zero speculative rows.
        """
        _, lo, hi, _, _ = self.interval()
        w = np.stack([self.pending[t].cnt_b.astype(np.float64)
                      * self.pending[t].width
                      for t in remaining])             # (T, nbins)
        if self.agg == "mean":
            w = w / np.maximum(self.ex_cnt + self._p_cnt, 1)
        v_max = np.maximum(np.maximum(np.abs(lo), np.abs(hi)), EPS)
        if self._phi_b is None:
            thr = 2.0 * phi * v_max
        else:
            thr = 2.0 * self._budgets(v_max)
        suffix = w.sum(axis=0) - np.cumsum(w, axis=0)  # widths after j folds
        ok = (suffix <= thr).all(axis=1)
        hit = np.flatnonzero(ok)
        j = int(hit[0]) + 1 if hit.size else len(remaining)
        return max(1, j)

    def round_certain(self, last_residual, phi: float) -> bool:
        """True when the per-fold stopping checks of the CURRENT round
        provably cannot fire before its last fold — the whole round may
        then be folded wholesale (same final state, no per-fold interval
        recomputation).

        ``last_residual`` is the fused kernel's suffix-width row before
        the round's last fold (``suffix_w[-2]`` of the round's payload):
        the per-bin CI width the round still carries entering its
        weakest interim check. The certainty argument is
        :meth:`min_folds_needed`'s, run in reverse: after j folds bin
        b's deviation is at least ``suffix_jb / 2`` and its budget at
        most ``max(φ_b·v_max_b, ε_abs)`` evaluated at the round-entry
        interval (intervals only shrink), so if some bin's LAST residual
        exceeds ``2·φ·v_max_b`` (uniform) / ``2·τ_b`` (policy) then so
        does every earlier residual (suffix rows are non-increasing) and
        no interim ``bound ≤ φ`` check can pass. φ = 0 degenerates to
        ``residual > 0`` on a finite-interval bin (the exact method only
        stops early on a bound of exactly 0). min/max rounds return
        False — their deviations don't reduce to pending widths.
        """
        if self.agg not in ("sum", "mean"):
            return False
        w = np.asarray(last_residual, np.float64)
        if self.agg == "mean":
            w = w / np.maximum(self.ex_cnt + self._p_cnt, 1)
        _, lo, hi, _, _ = self.interval()
        v_max = np.maximum(np.maximum(np.abs(lo), np.abs(hi)), EPS)
        if self._phi_b is None:
            thr = 2.0 * float(phi) * v_max
        else:
            thr = 2.0 * self._budgets(v_max)
        return bool(((w > thr) & np.isfinite(v_max)).any())


def _rel_bound_vec(value, lo, hi, occ):
    """Vectorized :func:`_rel_bound` over bins; unoccupied bins are 0."""
    with np.errstate(invalid="ignore"):
        dev = np.maximum(hi - value, value - lo)
    out = np.zeros(len(value))
    m = occ & np.isfinite(dev) & (dev > 0)
    out[m] = dev[m] / np.maximum(np.abs(value[m]), EPS)
    return out


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
