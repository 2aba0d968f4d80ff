"""Tile scoring and the greedy selection policy (§3.1 "Processing
Partially Contained Tiles").

Port of :mod:`repro.core.adapt` (``score_tiles`` and
``score_tiles_grouped``), copied without change.
Score of a pending tile t:

    s(t) = α · ŵ(t) + (1 − α) / ĉount(t ∩ Q)

where ŵ is the tile-confidence-interval width and ĉount the in-window
object count, both normalized to [0, 1] over the query's pending set.
The refinement driver processes tiles in descending score order and
stops as soon as the bound meets φ; heatmaps rank by the worst per-bin
CI width (:func:`score_tiles_grouped`).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .bounds import GroupedPendingTile, PendingTile, tile_ci_width

EPS = 1e-12


def _score_order(ids: List[int], w: np.ndarray, c: np.ndarray,
                 alpha: float) -> List[int]:
    w_hat = w / max(w.max(), EPS)
    c_hat = c / max(c.max(), EPS)
    s = alpha * w_hat + (1.0 - alpha) / np.maximum(c_hat, EPS)
    order = np.argsort(-s, kind="stable")
    return [ids[i] for i in order]


def score_tiles(pending: Dict[int, PendingTile], agg: str,
                alpha: float = 1.0) -> List[int]:
    """Return tile ids in processing (descending score) order."""
    if not pending:
        return []
    ids = list(pending.keys())
    w = np.array([tile_ci_width(pending[t], agg) for t in ids], np.float64)
    c = np.array([pending[t].cnt_q for t in ids], np.float64)
    return _score_order(ids, w, c, alpha)


def score_tiles_grouped(pending: Dict[int, GroupedPendingTile], agg: str,
                        alpha: float = 1.0,
                        bin_weight=None) -> List[int]:
    """Heatmap processing order: same policy, but ŵ(t) is the tile's
    WORST per-bin CI-width contribution.

    For sum/mean that is ``(vmax − vmin) · max_b cnt_b`` — the widest
    per-bin sum interval the tile inflicts (the query-level heatmap
    bound is a max over bins, so the tile touching the worst bin hardest
    is the most valuable to process); for min/max it is the value-range
    width, as in the scalar policy. The cost term uses the tile's total
    in-window count.

    ``bin_weight`` (per-bin, from
    :meth:`~repro_torch.core.bounds.GroupedAccumulator.score_bin_weight`)
    turns ŵ(t) into the worst *budget-normalized* contribution — each
    bin's CI width is divided by its own deviation budget
    ``max(φ_b·v_max_b, ε_abs)`` before the max, so under a non-uniform
    :class:`~repro_torch.core.bounds.AccuracyPolicy` refinement effort flows
    to the bins whose constraints are tight (and skips don't-care bins,
    weight 0). ``None`` keeps the uniform-φ score order bit-for-bit.
    """
    if not pending:
        return []
    ids = list(pending.keys())
    if agg in ("sum", "mean"):
        if bin_weight is None:
            w = np.array([pending[t].width * pending[t].cnt_b.max()
                          for t in ids], np.float64)
        else:
            w = np.array([pending[t].width
                          * (pending[t].cnt_b * bin_weight).max()
                          for t in ids], np.float64)
    elif bin_weight is None:
        w = np.array([pending[t].width for t in ids], np.float64)
    else:
        # min/max: the tile's value-range width lands on every bin it
        # touches — weigh by the tightest-budget touched bin
        w = np.array([pending[t].width
                      * ((pending[t].cnt_b > 0) * bin_weight).max()
                      for t in ids], np.float64)
    c = np.array([pending[t].cnt_b.sum() for t in ids], np.float64)
    return _score_order(ids, w, c, alpha)
