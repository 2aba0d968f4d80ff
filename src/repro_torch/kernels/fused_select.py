"""Fused heatmap select: the per-(segment, window-bin) table plus the
selection suffix widths, in one pass.

Port of :mod:`repro.kernels.fused_select`: the single-window select of a
query's own rounds and the multi-window select of the serving tick.
Given the per-segment sound value bounds ``vmin_s/vmax_s`` (the pending
intervals of a round's tiles, in FOLD ORDER),
``w[s, b] = cnt[s, b] · (vmax_s[s] − vmin_s[s])`` is the per-bin CI
width tile s still contributes while unfolded, and
``suffix_w[s] = Σ_{s' ≥ s} w[s']`` (shape ``(S+1, nb)``, last row
exactly zero) is the residual width after folding the first s tiles —
what ``GroupedAccumulator.round_certain`` consumes. It is a reversed
cumulative sum, never total − prefix, so φ = 0 sees an exact 0.

Three versions, one contract:

- :func:`segment_window_bin_select_np` — the float64 host mirror,
  copied from the reference without change;
- :func:`segment_window_bin_select_torch` — the plain PyTorch version:
  the table from ``segment_window_bin_agg_torch`` and the suffix as a
  Python-ordered reversed loop of float64 multiplies and adds, bit for
  bit numpy's ``cumsum`` on any device;
- :func:`segment_window_bin_select_cuda` — the hand-written kernel
  (``csrc/segment_window_bin_agg.cu`` with its select epilogue; TPU
  original: ``fused_table_pallas`` /
  ``segment_window_bin_select_pallas``). The widths ``vmax − vmin`` are
  taken in float64 on the host (the Pallas op rounds the bounds to
  float32 first), so ``suffix_w`` equals the mirror's bit for bit.

The multi-window select (``segment_window_bin_select_multi_*``; TPU
original: ``fused_table_multi_pallas`` /
``segment_window_bin_select_multi_pallas``) bins segment s by its own
window and cuts the segments into query spans (``qbounds``): row s of
its ``(S, nb)`` suffix is the reversed cumsum over s's OWN span only,
and consumers append each span's zero row. The reference's device
epilogue takes it as a global suffix minus the span's tail in float32
(``segmented_suffix``); here every version walks each span from its
last segment up in float64, so each span's rows are bit for bit the
mirror's — what ``round_certain`` reads must not split the batched
tick from the sequential one.
"""
from __future__ import annotations

import numpy as np
import torch

from . import build
from . import ref
from .segment_agg import (check_spans, host_bounds,
                          launch_segment_window_bin,
                          launch_segment_window_bin_multi,
                          segment_window_bin_agg_multi_torch,
                          segment_window_bin_agg_torch)


def segment_window_bin_select_np(xs, ys, vals, boundaries, window,
                                 bx: int, by: int, vmin_s, vmax_s):
    """Fused host pass: grouped table + selection suffix widths.

    The table is BIT-FOR-BIT ``ref.segment_window_bin_agg_np`` (the
    sequential per-tile f64 reference the batched rounds must match);
    the suffix widths are derived from its count channel and the
    fold-order pending intervals ``vmin_s/vmax_s`` per the module
    contract. Returns ``(agg (S, bx·by, 4) f64, suffix_w (S+1, bx·by)
    f64)``."""
    agg = ref.segment_window_bin_agg_np(xs, ys, vals, boundaries,
                                        window, bx, by)
    dv = (np.asarray(vmax_s, np.float64)
          - np.asarray(vmin_s, np.float64))[:, None]
    w = agg[:, :, 0] * dv
    suffix_w = np.concatenate(
        [np.cumsum(w[::-1], axis=0)[::-1],
         np.zeros((1, bx * by), np.float64)])
    return agg, suffix_w


def widths(vmin_s, vmax_s) -> np.ndarray:
    """Per-segment float64 widths ``vmax − vmin``, as the mirror takes
    them."""
    return (np.asarray(vmax_s, np.float64)
            - np.asarray(vmin_s, np.float64))


def span_suffix(agg: torch.Tensor, vmin_s, vmax_s, qb: np.ndarray,
                rows: int) -> torch.Tensor:
    """``(rows, nb)`` float64 suffix widths of ``w = cnt · (vmax −
    vmin)`` per query span ``[qb[q], qb[q+1])``: each span walked from
    its last segment up, ``acc = acc + w[s]`` — numpy's reversed cumsum,
    bit for bit, on any device. Rows past the spans stay 0."""
    dv = torch.from_numpy(widths(vmin_s, vmax_s)).to(agg.device)
    w = agg[:, :, 0] * dv[:, None]
    suffix = torch.zeros((rows, w.shape[1]), dtype=torch.float64,
                         device=agg.device)
    for a, b in zip(qb[:-1].tolist(), qb[1:].tolist()):
        if b > a:
            acc = w[b - 1]
            suffix[b - 1] = acc
            for s in range(b - 2, a - 1, -1):
                acc = acc + w[s]
                suffix[s] = acc
    return suffix


def segment_window_bin_select_torch(xs, ys, vals, boundaries, window,
                                    bx: int, by: int, vmin_s, vmax_s):
    """Plain version: ``(agg (S, bx*by, 4), suffix_w (S+1, bx*by))``,
    float64 on the input's device."""
    agg = segment_window_bin_agg_torch(xs, ys, vals, boundaries, window,
                                       bx, by)
    n_seg = agg.shape[0]
    return agg, span_suffix(agg, vmin_s, vmax_s,
                            np.array([0, n_seg]), n_seg + 1)


def segment_window_bin_select_cuda(xs, ys, vals, boundaries, window,
                                   bx: int, by: int, vmin_s, vmax_s):
    """Launch ``segment_window_bin_select``: ``(agg (S, bx*by, 4),
    suffix_w (S+1, bx*by))``, float64 on the device."""
    out = launch_segment_window_bin(xs, ys, vals, host_bounds(boundaries),
                                    window, bx, by,
                                    dv=widths(vmin_s, vmax_s))
    build.LAUNCHES["segment_window_bin_select"] += 1
    return out


def segment_window_bin_select_multi_np(xs, ys, vals, boundaries, windows,
                                       bx: int, by: int, vmin_s, vmax_s,
                                       qbounds=None):
    """Multi-window fused host pass: per-segment OWN-window grouped
    table + per-QUERY-SPAN selection suffix widths.

    The table is ``ref.segment_window_bin_agg_multi_np`` — per segment
    bit-for-bit the single-window sorted-slice f64 reference.
    ``qbounds`` (``(n_q+1,)`` segment offsets, default one span) cuts
    the fold-ordered segments into per-query spans; ``suffix_w`` is
    ``(S, bx·by)`` f64 where row s is the residual width over rows
    ``s..end−1`` of s's own span — each span's rows are BIT-FOR-BIT the
    first L rows a single-query :func:`segment_window_bin_select_np`
    would produce over the same stream (same f64 reversed cumsum over
    the same widths; consumers append the literal zero terminal row).
    Returns ``(agg (S, bx·by, 4) f64, suffix_w (S, bx·by) f64)``."""
    agg = ref.segment_window_bin_agg_multi_np(xs, ys, vals, boundaries,
                                              windows, bx, by)
    n_seg = agg.shape[0]
    dv = (np.asarray(vmax_s, np.float64)
          - np.asarray(vmin_s, np.float64))[:, None]
    w = agg[:, :, 0] * dv
    qb = (np.array([0, n_seg], np.int64) if qbounds is None
          else np.asarray(qbounds, np.int64))
    suffix_w = np.empty_like(w)
    for q in range(len(qb) - 1):
        a, b = int(qb[q]), int(qb[q + 1])
        if b > a:
            suffix_w[a:b] = np.cumsum(w[a:b][::-1], axis=0)[::-1]
    return agg, suffix_w


def segment_window_bin_select_multi_torch(xs, ys, vals, boundaries,
                                          windows, bx: int, by: int,
                                          vmin_s, vmax_s, qbounds=None):
    """Plain version: ``(agg (S, bx*by, 4), suffix_w (S, bx*by))``,
    float64 on the input's device."""
    agg = segment_window_bin_agg_multi_torch(xs, ys, vals, boundaries,
                                             windows, bx, by)
    n_seg = agg.shape[0]
    return agg, span_suffix(agg, vmin_s, vmax_s,
                            check_spans(qbounds, n_seg), n_seg)


def segment_window_bin_select_multi_cuda(xs, ys, vals, boundaries,
                                         windows, bx: int, by: int,
                                         vmin_s, vmax_s, qbounds=None):
    """Launch ``segment_window_bin_select_multi``: ``(agg (S, bx*by, 4),
    suffix_w (S, bx*by))``, float64 on the device."""
    out = launch_segment_window_bin_multi(
        xs, ys, vals, host_bounds(boundaries), windows, bx, by,
        dv=widths(vmin_s, vmax_s), qbounds=qbounds)
    build.LAUNCHES["segment_window_bin_select_multi"] += 1
    return out
