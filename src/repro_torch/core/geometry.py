"""Window/tile overlap classification and the ownership rule.

Port of :mod:`repro.core.geometry`. An object belongs to exactly one
tile, decided by ``cell = clip(floor((p - t0) / cell_size), 0, G - 1)``
(half-open cells, the max edge clamped into the last cell). Query
windows are closed rectangles. Classification is conservative: FULL only
when the tile's closed extent lies inside the window.

The PRECISION of a rule is part of the rule. Ownership differs between
the two places the reference applies it, and object masks have their own:

- **Init ownership is float32.** The init pass calls
  ``bin_cell_ids(dataset.x, dataset.y, domain, gx, gy)`` with ``domain``
  a tuple of Python floats (``repro/core/index.py:181-184``,
  ``repro/data/rawfile.py:83-84``). numpy 2 keeps Python floats weak,
  so ``(xs - x0) / cw`` is float32 arithmetic:
  ``f32(x) − f32(x0)``, rounded, divided by ``f32(cw)``.
  :func:`bin_cell_ids_f32` reproduces that on tensors.
- **Edge ownership is float64.** A bin-aligned split owns objects by
  ``ref.edge_cell_ids_np``: float32 coordinates against float64 edges,
  compared in float64 (:func:`edge_cell_ids_segmented`;
  ``kernels.segment_agg.edge_cell_ids`` on tensors).
- **Split ownership is float64.** A split bins against
  ``self.bbox[t]``, a float64 row (``repro/core/index.py:494-497`` for
  ``_split``, ``:820-826`` for ``_split_batch``): numpy scalars are
  strong, so the same expression runs in float64. :func:`segment_cell_ids`
  reproduces that on tensors.
- **Window compares are float32.** Object masks compare float32
  coordinates with a window of Python floats, float32 under numpy 2
  (``repro/kernels/ops.py:574-577``, ``repro/kernels/ref.py:355-361``);
  the port rounds windows to float32 before any tensor compare
  (``kernels.segment_agg.window_f32``), so the rule holds whatever
  precision the compare runs in. Tile classification, by contrast,
  compares float64 bboxes with the window as given
  (:func:`classify_tiles`).

PyTorch promotes differently from numpy: ``f32_tensor − f64_0dim_tensor``
is float32 in torch, so a literal port of the split rule would silently
bin in float32. Both tensor rules therefore spell out their dtypes, and
divide by per-object (expanded) operands, never by a scalar divisor that
PyTorch may turn into a multiply by the reciprocal.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import ref as ref_mod
from ..kernels.segment_agg import bin_params, cell_keys, clip_cell

DISJOINT, PARTIAL, FULL = 0, 1, 2


def classify_tiles(bbox: np.ndarray, window) -> np.ndarray:
    """bbox: (T, 4) tile extents [x0, y0, x1, y1]; window: length-4.

    Returns int8 (T,) with DISJOINT / PARTIAL / FULL.
    """
    qx0, qy0, qx1, qy1 = window
    tx0, ty0, tx1, ty1 = bbox[:, 0], bbox[:, 1], bbox[:, 2], bbox[:, 3]
    disjoint = (tx1 < qx0) | (tx0 > qx1) | (ty1 < qy0) | (ty0 > qy1)
    full = (tx0 >= qx0) & (tx1 <= qx1) & (ty0 >= qy0) & (ty1 <= qy1)
    out = np.full(bbox.shape[0], PARTIAL, dtype=np.int8)
    out[full] = FULL
    out[disjoint] = DISJOINT
    return out


def bin_cell_ids(xs: np.ndarray, ys: np.ndarray, bbox, gx: int,
                 gy: int) -> np.ndarray:
    """Cell id (cy*gx + cx) for each point under the ownership rule
    (numpy; its precision follows numpy's promotion of ``bbox``)."""
    x0, y0, x1, y1 = bbox
    cw = (x1 - x0) / gx
    ch = (y1 - y0) / gy
    cx = np.clip(np.floor((xs - x0) / max(cw, 1e-30)).astype(np.int64),
                 0, gx - 1)
    cy = np.clip(np.floor((ys - y0) / max(ch, 1e-30)).astype(np.int64),
                 0, gy - 1)
    return cy * gx + cx


def bin_cell_ids_f32(xs: torch.Tensor, ys: torch.Tensor, bbox, gx: int,
                     gy: int) -> torch.Tensor:
    """:func:`bin_cell_ids` for float32 tensors and a bbox of Python
    floats — the init pass's float32 rule."""
    x0, y0, x1, y1 = (float(v) for v in bbox)
    cw = max((x1 - x0) / gx, 1e-30)
    ch = max((y1 - y0) / gy, 1e-30)

    def f32(v, like):
        return torch.tensor(v, dtype=torch.float32,
                            device=like.device).expand_as(like)

    cx = clip_cell((xs - f32(x0, xs)) / f32(cw, xs), gx)
    cy = clip_cell((ys - f32(y0, ys)) / f32(ch, ys), gy)
    return cy * gx + cx


def segment_cell_ids(xs: torch.Tensor, ys: torch.Tensor, sid: torch.Tensor,
                     bboxes: np.ndarray, gx: int, gy: int) -> torch.Tensor:
    """Split ownership key ``sid·k + cy·gx + cx`` of float32 tensors,
    object i binned against ``bboxes[sid[i]]`` in float64 — the rule of
    ``repro/core/index.py:820-826`` (and of ``_split`` for one tile)."""
    return cell_keys(xs, ys, sid, bin_params(bboxes, gx, gy), gx, gy)


def subtile_bboxes(bbox, gx: int, gy: int) -> np.ndarray:
    """(gx*gy, 4) extents of the even gx×gy split of bbox (row-major y)."""
    x0, y0, x1, y1 = bbox
    xs = np.linspace(x0, x1, gx + 1)
    ys = np.linspace(y0, y1, gy + 1)
    return bboxes_from_edges(xs, ys)


def bboxes_from_edges(x_edges: np.ndarray, y_edges: np.ndarray) -> np.ndarray:
    """(gx*gy, 4) child extents from explicit per-axis edge arrays
    (lengths gx+1 / gy+1, increasing; row-major y, like subtile_bboxes)."""
    gx, gy = len(x_edges) - 1, len(y_edges) - 1
    out = np.empty((gx * gy, 4), np.float64)
    for cy in range(gy):
        for cx in range(gx):
            out[cy * gx + cx] = (x_edges[cx], y_edges[cy],
                                 x_edges[cx + 1], y_edges[cy + 1])
    return out


def _snap_axis_edges(e0: float, e1: float, g: int, q0: float, q1: float,
                     b: int) -> np.ndarray:
    """Uniform g+1 split edges of [e0, e1] with each interior edge snapped
    to the nearest bin-grid line of ([q0, q1], b) strictly inside the
    extent; falls back to the uniform edges when no grid line crosses the
    extent or snapping would collapse two children."""
    edges = np.linspace(e0, e1, g + 1)
    if b <= 1 or not (q1 > q0):
        return edges
    lines = q0 + (q1 - q0) / b * np.arange(1, b)
    inside = lines[(lines > e0) & (lines < e1)]
    if inside.size == 0:
        return edges
    snapped = edges.copy()
    for i in range(1, g):
        snapped[i] = inside[np.argmin(np.abs(inside - edges[i]))]
    snapped.sort()
    if np.unique(snapped).size < snapped.size:   # two edges hit one line
        return edges
    return snapped


def _bin_matched_axis_edges(e0: float, e1: float, g0: int, cap: int,
                            q0: float, q1: float, b: int) -> np.ndarray:
    """Bin-count-MATCHED split edges of one axis: cover EVERY bin-grid
    line of ([q0, q1], b) strictly inside (e0, e1) when their count fits
    ``cap`` children, so a tile spanning s ≤ cap bins nests all its
    children in single bins after ONE split (the snapped-g0 policy only
    places g0−1 cuts and needs several splits for s ≥ 3). Fewer inside
    lines than g0−1 cuts ⇒ extra cuts bisect the largest children (still
    nested); more than cap−1 ⇒ best-effort fallback to cap children with
    each cut snapped to its nearest line. Returns increasing edges of
    variable length (≥ g0+1, ≤ cap+1)."""
    if b <= 1 or not (q1 > q0):
        return np.linspace(e0, e1, g0 + 1)
    lines = q0 + (q1 - q0) / b * np.arange(1, b)
    inside = lines[(lines > e0) & (lines < e1)]
    m = int(inside.size)
    if m == 0:
        return np.linspace(e0, e1, g0 + 1)
    if m + 1 > cap:
        return _snap_axis_edges(e0, e1, max(g0, cap), q0, q1, b)
    edges = np.concatenate([[e0], inside, [e1]])
    while len(edges) - 1 < g0:
        # pad to the base child count by bisecting the widest child —
        # a cut interior to a bin keeps every child nested
        gaps = np.diff(edges)
        i = int(np.argmax(gaps))
        edges = np.insert(edges, i + 1, 0.5 * (edges[i] + edges[i + 1]))
    return edges


def bin_matched_split_edges(bbox, window, bx: int, by: int,
                            base=(2, 2), cap: int = 4):
    """Per-axis bin-count-matched split lines for one tile (see
    :func:`_bin_matched_axis_edges`); the host heatmap refinement's
    split-grid sizing when ``IndexConfig.bin_aligned_splits`` is on.
    Returns ``(x_edges, y_edges)`` float64 arrays whose lengths vary per
    tile with the bin span (capped at ``cap+1``)."""
    x0, y0, x1, y1 = (float(bbox[0]), float(bbox[1]), float(bbox[2]),
                      float(bbox[3]))
    qx0, qy0, qx1, qy1 = (float(window[0]), float(window[1]),
                          float(window[2]), float(window[3]))
    return (_bin_matched_axis_edges(x0, x1, base[0], cap, qx0, qx1, bx),
            _bin_matched_axis_edges(y0, y1, base[1], cap, qy0, qy1, by))


def edge_cell_ids_segmented(xs: np.ndarray, ys: np.ndarray,
                            x_edges: np.ndarray, y_edges: np.ndarray,
                            sid: np.ndarray) -> np.ndarray:
    """Cell id (cy*gx + cx) under explicit per-segment split edges.

    The ownership rule for snapped (bin-aligned) splits: child cx of
    segment s owns ``[x_edges[s, cx], x_edges[s, cx+1])``, points past
    the outer edges are clamped into the boundary cells — every object
    lands in exactly one cell, like :func:`bin_cell_ids`. Delegates to
    the ONE implementation (``kernels.ref.edge_cell_ids_np``) the
    child-metadata mirror also uses, so segment reorganization and
    metadata can never disagree on a boundary object.
    """
    return ref_mod.edge_cell_ids_np(np.asarray(xs), np.asarray(ys),
                                    x_edges, y_edges, sid)


def edge_cell_ids(xs: np.ndarray, ys: np.ndarray, x_edges: np.ndarray,
                  y_edges: np.ndarray) -> np.ndarray:
    """Single-tile form of :func:`edge_cell_ids_segmented` (one edge
    array, every object in segment 0)."""
    return edge_cell_ids_segmented(
        np.asarray(xs), np.asarray(ys), np.asarray(x_edges)[None],
        np.asarray(y_edges)[None], np.zeros(len(xs), np.int64))
