"""Public kernel ops, with the reference's names and signatures
(``repro/kernels/ops.py``).

Backends, chosen per call (``backend=``, default ``"cuda"``):

- ``"np"`` — the float64 host mirrors of :mod:`repro_torch.kernels.ref`,
  bit for bit the reference's ``"np"`` backend. Host data only: a CUDA
  tensor raises. Returns numpy.
- ``"torch"`` — the plain PyTorch versions, on whatever device the
  tensors are on. Returns a float64 tensor there.
- ``"cuda"`` — the hand-written Hopper kernels. CUDA tensors only: a CPU
  tensor raises (there is no quiet fallback). Returns a float64 tensor
  on the device.

Every backend returns ``(count, sum, min, max)`` rows: counts exact,
sums float64 (``"np"``'s ``bin_agg`` and ``window_agg`` keep the
reference's float32 rows), extrema exact. ``segment_window_bin_select``
also returns the suffix widths, bit for bit equal on every backend.

Precision rules the port keeps, and where the reference states them:

- **Window compare (float32), one window per segment too.** The multi
  ops compare each segment with its own window under the same rule: the
  ``"np"`` mirror keeps each window as given (never a float64 array
  row, which the reference builds, ROADMAP C.6), the other backends
  round each to float32.
- **Window compare (float32).** ``window_mask_np``
  (``repro/kernels/ops.py:574-577``) and ``segment_window_agg_np``
  (``repro/kernels/ref.py:355-361``) compare float32 coordinates with a
  window of Python floats, which numpy 2 keeps weak: the compare is
  float32. (A window of ``np.float64`` would compare in float64: at edge
  0.7 the point ``0.7f`` falls inside under one rule and outside under
  the other.) The torch paths and the kernel round the window to
  float32 first (:func:`~repro_torch.kernels.segment_agg.window_f32`),
  which gives the float32 rule whatever precision the compare runs in;
  the reference's device path does the same (``ops.py:236``). Windows
  stay Python floats or float32, never float64 tensors.
- **Split ownership (float64).** Split binning subtracts a float64 bbox
  from float32 coordinates in float64 (``repro/core/index.py:820-826``,
  ``repro/kernels/ops.py:68-75``, and ``geometry.bin_cell_ids`` under
  ``_split`` at ``repro/core/index.py:494-497``). The CUDA split kernels
  take each segment's ``(x0, y0, cw, ch)`` as doubles computed as the
  host computes them and bin ``((double)x − x0) / cw`` in double — the
  Pallas split kernels re-bin in float32 instead, which can disagree
  with the host on a boundary object.
- **Edge ownership (float64).** Bin-aligned splits own objects by
  ``ref.edge_cell_ids_np``: the float32 coordinate against float64
  edges, compared in float64. The Pallas edges kernel rounds the edges
  to float32 (``repro/kernels/ops.py:320``) and can disagree with the
  host reorganization on an object between ``f32(edge)`` and ``edge``;
  the CUDA kernel keeps the edges float64.
- **Window binning (float32, by contract).** Heatmap bins follow
  ``ref.window_bin_ids_np``: float32 compares, and
  ``clip(floor((x − x0) / cw))`` in float32 with ``cw`` derived in
  float64 and then rounded (``ref.window_bin_params``). The torch paths
  and the kernel take those params and never recompute ``cw`` from the
  float32 window (the rescaled-float binning of the Pallas single-window
  kernels, ``repro/kernels/segment_agg.py:256-260``).
- **Init ownership (float32).** The init pass bins
  ``bin_cell_ids(dataset.x, dataset.y, domain, gx, gy)`` with ``domain``
  a tuple of Python floats (``repro/core/index.py:181-184``,
  ``repro/data/rawfile.py:83-84``): numpy 2 keeps them weak, so that
  binning is float32 arithmetic. No kernel runs it; the index reproduces
  it on tensors (:func:`repro_torch.core.geometry.bin_cell_ids_f32`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..data.rawfile import as_host
from . import fused_select, ref
from .bin_agg import bin_agg_cuda, bin_agg_torch
from .ref import window_mask_np
from .segment_agg import (segment_bin_agg_cuda, segment_bin_agg_edges_cuda,
                          segment_bin_agg_edges_torch, segment_bin_agg_torch,
                          segment_window_agg_cuda,
                          segment_window_agg_multi_cuda,
                          segment_window_agg_multi_torch,
                          segment_window_agg_torch,
                          segment_window_bin_agg_cuda,
                          segment_window_bin_agg_multi_cuda,
                          segment_window_bin_agg_multi_torch,
                          segment_window_bin_agg_torch, window_f32)
from .window_agg import window_agg_cuda, window_agg_torch

BACKENDS = ("np", "torch", "cuda")


def default_backend() -> str:
    return "cuda"


def _backend(backend, *tensors) -> str:
    backend = backend or default_backend()
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if backend == "np":
        return backend
    for t in tensors:
        if t is None:
            continue
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"the {backend!r} backend takes tensors")
        if backend == "cuda" and t.device.type != "cuda":
            raise TypeError("the 'cuda' backend takes CUDA tensors; a "
                            f"tensor on {t.device} was given")
    return backend


def window_mask(xs, ys, window):
    """Closed-window mask of tensors under the float32 compare rule."""
    x0, y0, x1, y1 = window_f32(window)
    return (xs >= x0) & (xs <= x1) & (ys >= y0) & (ys <= y1)


def window_agg(xs, ys, vals, window, *, n=None, backend=None):
    """(count, sum, min, max) of ``vals`` for the first ``n`` objects in
    the closed ``window`` (``n``: the logical length, entries past it are
    ignored; default all). ``"np"`` returns the reference's float32 row;
    ``"torch"``/``"cuda"`` a float64 ``(4,)`` tensor with an exact
    count. ``vals=None`` (device backends) counts only, as over an
    all-zero value plane."""
    backend = _backend(backend, xs, ys, vals)
    if backend == "np":
        xs = as_host(xs)
        n = len(xs) if n is None else int(n)
        return ref.window_agg_np(xs, as_host(ys), as_host(vals), window, n)
    if backend == "torch":
        return window_agg_torch(xs, ys, vals, window, n)
    return window_agg_cuda(xs, ys, vals, window, n)


def window_count(xs, ys, window, *, n=None, backend=None):
    """Count of the first ``n`` objects in ``window`` (axis attributes
    only, no value plane read). ``"np"``: the reference's float32 count;
    ``"torch"``/``"cuda"``: a 0-d float64 tensor."""
    backend = _backend(backend, xs, ys)
    if backend == "np":
        # the reference streams a zero value plane (repro/kernels/ops.py:569)
        zeros = np.zeros(len(as_host(xs)), np.float32)
        return window_agg(xs, ys, zeros, window, n=n, backend="np")[0]
    return window_agg(xs, ys, None, window, n=n, backend=backend)[0]


def segment_window_agg(xs, ys, vals, boundaries, window, *, backend=None):
    """Per-segment (count, sum, min, max) inside the closed ``window``;
    ``boundaries`` (int, (S+1,)) delimit the concatenated segments. An
    all-covering window (±inf edges) yields full-segment aggregates.
    Returns ``(S, 4)``."""
    backend = _backend(backend, xs, ys, vals)
    if backend == "np":
        return ref.segment_window_agg_np(
            as_host(xs), as_host(ys), as_host(vals),
            np.asarray(boundaries, np.int64), window)
    if backend == "torch":
        return segment_window_agg_torch(xs, ys, vals, boundaries, window)
    return segment_window_agg_cuda(xs, ys, vals, boundaries, window)


def segment_bin_agg(xs, ys, vals, boundaries, bboxes, *, gx, gy,
                    backend=None):
    """Per-segment, per-cell (count, sum, min, max): segment s split by
    its own ``bboxes[s]`` into ``gx × gy`` cells. Returns
    ``(S, gx*gy, 4)``; cell id = cy*gx + cx."""
    backend = _backend(backend, xs, ys, vals)
    if backend == "np":
        return ref.segment_bin_agg_np(
            as_host(xs), as_host(ys), as_host(vals),
            np.asarray(boundaries, np.int64), bboxes, gx, gy)
    if backend == "torch":
        return segment_bin_agg_torch(xs, ys, vals, boundaries, bboxes,
                                     gx, gy)
    return segment_bin_agg_cuda(xs, ys, vals, boundaries, bboxes, gx, gy)


def bin_agg(xs, ys, vals, bbox, *, gx, gy, backend=None):
    """Per-cell (count, sum, min, max) over a gx×gy split of one bbox.
    Returns ``(gx*gy, 4)``."""
    backend = _backend(backend, xs, ys, vals)
    if backend == "np":
        xs = as_host(xs)
        return ref.bin_agg_np(xs, as_host(ys), as_host(vals), bbox, gx, gy,
                              len(xs))
    if backend == "torch":
        return bin_agg_torch(xs, ys, vals, bbox, gx, gy)
    return bin_agg_cuda(xs, ys, vals, bbox, gx, gy)


def segment_bin_agg_edges(xs, ys, vals, boundaries, x_edges, y_edges, *,
                          backend=None):
    """Per-segment, per-cell (count, sum, min, max) under per-segment
    SPLIT EDGES: segment s is cut along its own ``x_edges[s]`` (gx+1,) /
    ``y_edges[s]`` (gy+1,) — the bin-aligned split's child metadata.
    Returns ``(S, gx*gy, 4)``; cell id = cy*gx + cx. Ownership is the
    float64 rule of ``ref.edge_cell_ids_np`` on every backend."""
    backend = _backend(backend, xs, ys, vals)
    boundaries = np.asarray(boundaries, np.int64)
    x_edges = np.asarray(x_edges, np.float64)
    y_edges = np.asarray(y_edges, np.float64)
    if backend == "np":
        return ref.segment_bin_agg_edges_np(
            as_host(xs), as_host(ys), as_host(vals), boundaries, x_edges,
            y_edges)
    if backend == "torch":
        return segment_bin_agg_edges_torch(xs, ys, vals, boundaries,
                                           x_edges, y_edges)
    return segment_bin_agg_edges_cuda(xs, ys, vals, boundaries, x_edges,
                                      y_edges)


def segment_window_bin_agg(xs, ys, vals, boundaries, window, *, bx, by,
                           backend=None):
    """Per-segment, per-window-bin (count, sum, min, max) — the heatmap
    primitive: every segment binned by the SAME ``bx × by`` grid over
    the (finite, closed) window, in-window objects only. Returns
    ``(S, bx*by, 4)``; bin id = by_row*bx + bx_col. Binning is the
    contract of ``ref.window_bin_params`` on every backend."""
    backend = _backend(backend, xs, ys, vals)
    boundaries = np.asarray(boundaries, np.int64)
    if backend == "np":
        return ref.segment_window_bin_agg_np(
            as_host(xs), as_host(ys), as_host(vals), boundaries, window,
            bx, by)
    if backend == "torch":
        return segment_window_bin_agg_torch(xs, ys, vals, boundaries,
                                            window, bx, by)
    return segment_window_bin_agg_cuda(xs, ys, vals, boundaries, window,
                                       bx, by)


def segment_window_bin_select(xs, ys, vals, boundaries, window, vmin_s,
                              vmax_s, *, bx, by, backend=None):
    """Fused heatmap-selection primitive: the
    :func:`segment_window_bin_agg` table PLUS the selection-ready suffix
    widths ``suffix_w`` ``(S+1, bx*by)`` of the per-segment sound value
    bounds ``vmin_s/vmax_s`` (fold order; row S exactly zero). Returns
    ``(agg, suffix_w)``; ``suffix_w`` is bit for bit the "np" mirror's
    on every backend."""
    backend = _backend(backend, xs, ys, vals)
    boundaries = np.asarray(boundaries, np.int64)
    if backend == "np":
        return fused_select.segment_window_bin_select_np(
            as_host(xs), as_host(ys), as_host(vals), boundaries, window,
            bx, by, vmin_s, vmax_s)
    if backend == "torch":
        return fused_select.segment_window_bin_select_torch(
            xs, ys, vals, boundaries, window, bx, by, vmin_s, vmax_s)
    return fused_select.segment_window_bin_select_cuda(
        xs, ys, vals, boundaries, window, bx, by, vmin_s, vmax_s)


def segment_window_agg_multi(xs, ys, vals, boundaries, windows, *,
                             backend=None):
    """Per-segment (count, sum, min, max) where segment s is filtered by
    its OWN closed ``windows[s]`` — the multi-query serving primitive:
    the concatenated (query, tile) streams of one serving tick answer N
    different viewports in a single packed pass. ``windows`` holds S
    windows; each compares as its own single-window read would (see the
    module docstring). Returns ``(S, 4)``."""
    backend = _backend(backend, xs, ys, vals)
    if backend == "np":
        return ref.segment_window_agg_multi_np(
            as_host(xs), as_host(ys), as_host(vals),
            np.asarray(boundaries, np.int64), windows)
    if backend == "torch":
        return segment_window_agg_multi_torch(xs, ys, vals, boundaries,
                                              windows)
    return segment_window_agg_multi_cuda(xs, ys, vals, boundaries, windows)


def segment_window_bin_agg_multi(xs, ys, vals, boundaries, windows, *, bx,
                                 by, backend=None):
    """Per-segment, per-bin (count, sum, min, max) where segment s is
    binned by the ``bx × by`` grid of its OWN window ``windows[s]``
    (the contract of ``ref.window_bin_params`` on every backend). All
    segments share the bin resolution; windows may differ freely.
    Returns ``(S, bx*by, 4)``."""
    backend = _backend(backend, xs, ys, vals)
    boundaries = np.asarray(boundaries, np.int64)
    if backend == "np":
        return ref.segment_window_bin_agg_multi_np(
            as_host(xs), as_host(ys), as_host(vals), boundaries, windows,
            bx, by)
    if backend == "torch":
        return segment_window_bin_agg_multi_torch(xs, ys, vals, boundaries,
                                                  windows, bx, by)
    return segment_window_bin_agg_multi_cuda(xs, ys, vals, boundaries,
                                             windows, bx, by)


def segment_window_bin_select_multi(xs, ys, vals, boundaries, windows,
                                    vmin_s, vmax_s, qbounds=None, *, bx,
                                    by, backend=None):
    """Multi-window fused heatmap-selection primitive — the serving
    tick's heatmap pass: the :func:`segment_window_bin_agg_multi` table
    PLUS per-query-span suffix widths ``suffix_w`` ``(S, bx*by)``.
    ``qbounds`` (``(n_q+1,)`` segment offsets, default one span) cuts
    the fold-ordered segments into query spans; row s is the residual
    width over the rest of s's own span, each span's rows bit for bit
    the "np" mirror's on every backend (consumers append the span's
    zero row). Returns ``(agg, suffix_w)``."""
    backend = _backend(backend, xs, ys, vals)
    boundaries = np.asarray(boundaries, np.int64)
    if backend == "np":
        return fused_select.segment_window_bin_select_multi_np(
            as_host(xs), as_host(ys), as_host(vals), boundaries, windows,
            bx, by, vmin_s, vmax_s, qbounds)
    if backend == "torch":
        return fused_select.segment_window_bin_select_multi_torch(
            xs, ys, vals, boundaries, windows, bx, by, vmin_s, vmax_s,
            qbounds)
    return fused_select.segment_window_bin_select_multi_cuda(
        xs, ys, vals, boundaries, windows, bx, by, vmin_s, vmax_s, qbounds)


__all__ = ["window_agg", "window_count", "segment_window_agg",
           "segment_bin_agg", "bin_agg",
           "segment_bin_agg_edges", "segment_window_bin_agg",
           "segment_window_bin_select", "segment_window_agg_multi",
           "segment_window_bin_agg_multi", "segment_window_bin_select_multi",
           "window_mask", "window_mask_np", "default_backend", "BACKENDS"]
