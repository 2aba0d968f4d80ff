"""NumPy host mirrors of the kernels (the index's ``"np"`` control plane).

Copied from the reference package (``repro/kernels/ref.py:345-400``,
``:403-459``, ``:464-509`` and ``:512-581``, and ``repro/kernels/ops.py:65-90,
574-577``) without change — apart from the window compare of
:func:`segment_window_agg_multi_np` (ROADMAP C.6) — so the port's
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


def edge_cell_ids_np(xs, ys, x_edges, y_edges, sid):
    """THE host ownership rule for explicit (bin-aligned) split edges.

    Child cx of segment s owns ``[x_edges[s, cx], x_edges[s, cx+1])``
    (``cx = Σ_i 1[x ≥ edge_i]`` over interior edges, f64 comparisons);
    points past the outer edges clamp into the boundary cells, so every
    object lands in exactly one cell. This single implementation serves
    both the index's segment reorganization
    (``core.geometry.edge_cell_ids_segmented`` delegates here) and the
    child-metadata mirror below — they MUST agree bit-for-bit or
    reorganized segments desynchronize from their metadata.
    ``x_edges``/``y_edges`` are ``(S, gx+1)`` / ``(S, gy+1)``; ``sid``
    maps each object to its segment row. Returns cell id = cy*gx + cx.
    """
    x_edges = np.asarray(x_edges, np.float64)
    y_edges = np.asarray(y_edges, np.float64)
    gx = x_edges.shape[1] - 1
    gy = y_edges.shape[1] - 1
    cx = (xs[:, None] >= x_edges[sid][:, 1:-1]).sum(axis=1) \
        if gx > 1 else np.zeros(len(xs), np.int64)
    cy = (ys[:, None] >= y_edges[sid][:, 1:-1]).sum(axis=1) \
        if gy > 1 else np.zeros(len(ys), np.int64)
    return cy * gx + cx


def segment_bin_agg_edges_np(xs, ys, vals, boundaries, x_edges, y_edges):
    """Per-contiguous-segment, per-cell aggregates under per-segment
    split edges (f64 ``(S, K, 4)``) — host mirror of
    :func:`segment_bin_agg_edges_ref` in the contiguous layout.

    Cell ids come from :func:`edge_cell_ids_np` — the one host
    ownership rule, shared with the index's segment reorganization —
    and each cell's sum accumulates its own sorted slice in float64, so
    a k-segment call is bit-for-bit the concatenation of k
    single-segment calls (the sequential split path the batched
    multi-tile split replaces).
    """
    xs, ys = np.asarray(xs), np.asarray(ys)
    vals = np.asarray(vals, np.float32)
    x_edges = np.asarray(x_edges, np.float64)
    y_edges = np.asarray(y_edges, np.float64)
    n_seg = len(boundaries) - 1
    gx = x_edges.shape[1] - 1
    gy = y_edges.shape[1] - 1
    k = gx * gy
    sid = np.repeat(np.arange(n_seg), np.diff(boundaries))
    key = sid * k + edge_cell_ids_np(xs, ys, x_edges, y_edges, sid)
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


def window_bin_ids_np(xs, ys, window, bx, by):
    """Host binning rule of a heatmap window: ``(in_window_mask, bin_id)``.

    The ONE formula both the pending-tile per-bin counts (axis index, no
    file I/O) and the processed per-bin contributions
    (:func:`segment_window_bin_agg_np`) are derived from — they must
    agree bit-for-bit or the grouped accumulator's count cross-check
    fails. Bin id = by_row * bx + bx_col; objects on the closed max edge
    are clipped into the last bin (every selected object lands in
    exactly one bin).
    """
    x0, y0, x1, y1 = (float(window[0]), float(window[1]),
                      float(window[2]), float(window[3]))
    m = (xs >= x0) & (xs <= x1) & (ys >= y0) & (ys <= y1)
    cw = max((x1 - x0) / bx, 1e-30)
    ch = max((y1 - y0) / by, 1e-30)
    cx = np.clip(np.floor((xs - x0) / cw).astype(np.int64), 0, bx - 1)
    cy = np.clip(np.floor((ys - y0) / ch).astype(np.int64), 0, by - 1)
    return m, cy * bx + cx


def window_bin_params(windows, bx, by):
    """Per-window axis-index binning parameters for the DEVICE kernels:
    float32 ``(S, 6)`` rows ``(x0, y0, x1, y1, cw, ch)``.

    THE binning contract. :func:`window_bin_ids_np` runs on float32
    coordinates, so NumPy-2 weak promotion demotes its python-float
    window scalars to f32 at every op — the mask compares and the
    ``floor((x - x0) / cw)`` arithmetic are all f32 — but the cell
    sizes ``cw/ch`` are derived in f64 FIRST and only then rounded.  A
    kernel that recomputes ``(x1 - x0) / bx`` from f32 window coords
    (the rescaled-float binning of the single-window kernels) rounds
    differently and can land edge objects in the neighbouring bin.
    Device kernels must instead take these host-precomputed params and
    bin with ``clip(floor((x - x0) / cw), 0, bx-1)``: IEEE f32
    subtract/divide/floor round identically under numpy and XLA, so the
    device mask and bin ids are BIT-IDENTICAL to the host rule.
    """
    windows = np.asarray(windows, np.float64).reshape(-1, 4)
    out = np.empty((len(windows), 6), np.float32)
    out[:, :4] = windows
    out[:, 4] = np.maximum((windows[:, 2] - windows[:, 0]) / bx, 1e-30)
    out[:, 5] = np.maximum((windows[:, 3] - windows[:, 1]) / by, 1e-30)
    return out


def segment_window_bin_agg_np(xs, ys, vals, boundaries, window, bx, by):
    """Per-contiguous-segment, per-window-bin aggregates (f64 ``(S,K,4)``).

    Host mirror of :func:`segment_window_bin_agg_ref` in the contiguous
    layout. Each (segment, bin) cell's sum accumulates the cell's own
    sorted slice in float64 — per-cell arithmetic is independent of the
    batch composition, so a k-segment call is bit-for-bit the
    concatenation of k single-segment calls (the sequential heatmap
    reference path).
    """
    xs, ys = np.asarray(xs), np.asarray(ys)
    vals = np.asarray(vals, np.float32)
    n_seg = len(boundaries) - 1
    k = bx * by
    m, cid = window_bin_ids_np(xs, ys, window, bx, by)
    sid = np.repeat(np.arange(n_seg), np.diff(boundaries))
    # out-of-window objects go to a sentinel key past every real cell
    key = np.where(m, sid * k + cid, n_seg * k)
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


def segment_window_agg_multi_np(xs, ys, vals, boundaries, windows):
    """Per-contiguous-segment (count, sum, min, max), each segment under
    its OWN window (f64 ``(S, 4)``).

    Delegates each segment's slice to :func:`segment_window_agg_np`, so
    segment s's row is BIT-FOR-BIT what a single-window call over the
    same stream produces — the serving scheduler's packed pass answers
    each query exactly as that query's own per-query round would.

    ``windows`` is a sequence of S windows, each compared AS GIVEN: a
    tuple of Python floats stays weak under numpy 2 and compares in
    float32, exactly as the ticket's own single-window read does. The
    reference turns the windows into a float64 array first
    (``repro/kernels/ref.py:477``), so its rows compare in float64 and
    can disagree with the same query's axis-index count on an object at
    ``float32(e) < e`` (ROADMAP C.6); this copy keeps the ticket's rule.
    """
    n_seg = len(boundaries) - 1
    out = np.empty((n_seg, 4), np.float64)
    two = np.array([0, 0], np.int64)
    for s in range(n_seg):
        a, b = int(boundaries[s]), int(boundaries[s + 1])
        two[1] = b - a
        out[s] = segment_window_agg_np(xs[a:b], ys[a:b], vals[a:b],
                                       two, windows[s])[0]
    return out


def segment_window_bin_agg_multi_np(xs, ys, vals, boundaries, windows,
                                    bx, by):
    """Per-contiguous-segment, per-bin aggregates, each segment binned
    by the bx×by grid of its OWN window (f64 ``(S, bx*by, 4)``).

    Per segment it is bit-for-bit a single-window
    :func:`segment_window_bin_agg_np` call over the same stream (same
    per-cell sorted-slice f64 accumulation), which is what lets the
    serving layer's micro-batched heatmap pass equal the per-query
    reference exactly.
    """
    windows = np.asarray(windows, np.float64)
    n_seg = len(boundaries) - 1
    k = bx * by
    out = np.empty((n_seg, k, 4), np.float64)
    two = np.array([0, 0], np.int64)
    for s in range(n_seg):
        a, b = int(boundaries[s]), int(boundaries[s + 1])
        two[1] = b - a
        out[s] = segment_window_bin_agg_np(xs[a:b], ys[a:b], vals[a:b],
                                           two, windows[s], bx, by)[0]
    return out
