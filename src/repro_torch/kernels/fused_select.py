"""Fused heatmap select: the per-(segment, window-bin) table plus the
selection suffix widths, in one pass.

Port of the single-window part of :mod:`repro.kernels.fused_select`.
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
"""
from __future__ import annotations

import numpy as np
import torch

from . import build
from . import ref
from .segment_agg import (host_bounds, launch_segment_window_bin,
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


def segment_window_bin_select_torch(xs, ys, vals, boundaries, window,
                                    bx: int, by: int, vmin_s, vmax_s):
    """Plain version: ``(agg (S, bx*by, 4), suffix_w (S+1, bx*by))``,
    float64 on the input's device."""
    agg = segment_window_bin_agg_torch(xs, ys, vals, boundaries, window,
                                       bx, by)
    dv = torch.from_numpy(widths(vmin_s, vmax_s)).to(agg.device)
    w = agg[:, :, 0] * dv[:, None]
    n_seg = w.shape[0]
    suffix = torch.zeros((n_seg + 1, bx * by), dtype=torch.float64,
                         device=agg.device)
    acc = w[n_seg - 1]
    suffix[n_seg - 1] = acc
    for s in range(n_seg - 2, -1, -1):
        acc = acc + w[s]
        suffix[s] = acc
    return agg, suffix


def segment_window_bin_select_cuda(xs, ys, vals, boundaries, window,
                                   bx: int, by: int, vmin_s, vmax_s):
    """Launch ``segment_window_bin_select``: ``(agg (S, bx*by, 4),
    suffix_w (S+1, bx*by))``, float64 on the device."""
    out = launch_segment_window_bin(xs, ys, vals, host_bounds(boundaries),
                                    window, bx, by,
                                    dv=widths(vmin_s, vmax_s))
    build.LAUNCHES["segment_window_bin_select"] += 1
    return out
