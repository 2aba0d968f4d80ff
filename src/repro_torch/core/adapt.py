"""Tile scoring and the greedy selection policy (§3.1 "Processing
Partially Contained Tiles"), scalar half.

Port of :func:`repro.core.adapt.score_tiles`, copied without change.
Score of a pending tile t:

    s(t) = α · ŵ(t) + (1 − α) / ĉount(t ∩ Q)

where ŵ is the tile-confidence-interval width and ĉount the in-window
object count, both normalized to [0, 1] over the query's pending set.
The refinement driver processes tiles in descending score order and
stops as soon as the bound meets φ.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .bounds import PendingTile, tile_ci_width

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
