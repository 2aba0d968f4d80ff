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
