"""NumPy host mirrors of the kernels (the index's ``"np"`` control plane).

Copied from the reference package (``repro/kernels/ref.py:345-400`` and
``repro/kernels/ops.py:65-90, 574-577``) without change, so the port's
``"np"`` backend equals the reference bit for bit. Segments are
CONTIGUOUS — described by a boundaries vector — and sums accumulate in
float64 with numpy's pairwise algorithm over each segment slice.

Conventions shared with every backend: aggregates are
``(count, sum, min, max)`` on the last axis; an empty selection yields
``(0, 0, +inf, -inf)``; windows are closed rectangles.
"""
from __future__ import annotations

import numpy as np


def window_mask_np(xs, ys, window):
    """NumPy host-side mask (control-plane helper, not a kernel)."""
    x0, y0, x1, y1 = window
    return (xs >= x0) & (xs <= x1) & (ys >= y0) & (ys <= y1)


def bin_agg_np(xs, ys, vals, bbox, gx, gy, n):
    """Per-cell (count, sum, min, max) over the even gx×gy split of one
    bbox: pure clip-binning in float64 (every object lands in exactly one
    cell). Returns float32 ``(gx*gy, 4)``, as the reference does."""
    xs, ys = np.asarray(xs)[:n], np.asarray(ys)[:n]
    vals = np.asarray(vals, np.float32)[:n]
    x0, y0, x1, y1 = np.asarray(bbox, np.float64)
    cw = max((x1 - x0) / gx, 1e-30)
    ch = max((y1 - y0) / gy, 1e-30)
    cx = np.clip(np.floor((xs - x0) / cw).astype(np.int64), 0, gx - 1)
    cy = np.clip(np.floor((ys - y0) / ch).astype(np.int64), 0, gy - 1)
    cid = cy * gx + cx
    k = gx * gy
    cnt = np.bincount(cid, minlength=k + 1)[:k].astype(np.float32)
    s = np.bincount(cid, weights=vals.astype(np.float64),
                    minlength=k + 1)[:k].astype(np.float32)
    mn = np.full(k, np.inf, np.float32)
    mx = np.full(k, -np.inf, np.float32)
    order = np.argsort(cid, kind="stable")
    cs, vs_sorted = cid[order], vals[order]
    bounds = np.searchsorted(cs, np.arange(k + 1))
    for c in range(k):
        a, b = bounds[c], bounds[c + 1]
        if b > a:
            mn[c] = vs_sorted[a:b].min()
            mx[c] = vs_sorted[a:b].max()
    return np.stack([cnt, s, mn, mx], axis=-1)


def segment_window_agg_np(xs, ys, vals, boundaries, window):
    """Per-contiguous-segment (count, sum, min, max) inside ``window``.

    ``boundaries``: int ``(S+1,)``; segment s owns
    ``[boundaries[s], boundaries[s+1])``. Returns float64 ``(S, 4)``;
    empty selection ⇒ (0, 0, +inf, -inf).
    """
    xs, ys = np.asarray(xs), np.asarray(ys)
    vals = np.asarray(vals, np.float32)
    n_seg = len(boundaries) - 1
    x0, y0, x1, y1 = window
    # all-covering window (enrichment stats): segment slices ARE the
    # selection — skip the mask and its boolean-indexing copies
    covers_all = (x0 == -np.inf and y0 == -np.inf
                  and x1 == np.inf and y1 == np.inf)
    if not covers_all:
        m = (xs >= x0) & (xs <= x1) & (ys >= y0) & (ys <= y1)
    out = np.empty((n_seg, 4), np.float64)
    for s in range(n_seg):
        a, b = int(boundaries[s]), int(boundaries[s + 1])
        sel = vals[a:b] if covers_all else vals[a:b][m[a:b]]
        if sel.size:
            out[s] = (sel.size, sel.sum(dtype=np.float64),
                      sel.min(), sel.max())
        else:
            out[s] = (0, 0.0, np.inf, -np.inf)
    return out


def segment_bin_agg_np(xs, ys, vals, boundaries, bboxes, gx, gy):
    """Per-contiguous-segment, per-cell aggregates (float64 ``(S,K,4)``)."""
    xs, ys = np.asarray(xs), np.asarray(ys)
    vals = np.asarray(vals, np.float32)
    bboxes = np.asarray(bboxes, np.float64)
    n_seg = len(boundaries) - 1
    k = gx * gy
    sid = np.repeat(np.arange(n_seg), np.diff(boundaries))
    cw = np.maximum((bboxes[:, 2] - bboxes[:, 0]) / gx, 1e-30)
    ch = np.maximum((bboxes[:, 3] - bboxes[:, 1]) / gy, 1e-30)
    cx = np.clip(np.floor((xs - bboxes[sid, 0]) / cw[sid]).astype(np.int64),
                 0, gx - 1)
    cy = np.clip(np.floor((ys - bboxes[sid, 1]) / ch[sid]).astype(np.int64),
                 0, gy - 1)
    key = sid * k + cy * gx + cx
    order = np.argsort(key, kind="stable")
    vs_sorted = vals[order]
    cell_bounds = np.searchsorted(key[order], np.arange(n_seg * k + 1))
    out = np.empty((n_seg * k, 4), np.float64)
    for c in range(n_seg * k):
        a, b = cell_bounds[c], cell_bounds[c + 1]
        if b > a:
            seg = vs_sorted[a:b]
            out[c] = (b - a, seg.sum(dtype=np.float64), seg.min(), seg.max())
        else:
            out[c] = (0, 0.0, np.inf, -np.inf)
    return out.reshape(n_seg, k, 4)
