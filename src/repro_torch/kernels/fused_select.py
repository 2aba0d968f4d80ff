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

The SPMD session engine's primitives (:func:`window_bin_ids`,
:func:`window_bin_ids_params`, :func:`fused_count_val`,
:func:`suffix_residual`, :func:`segmented_suffix`) and the oracles built
on them (:func:`segment_window_bin_select_ref`,
:func:`segment_window_bin_select_multi_ref`) are the reference's jnp
expressions as PyTorch functions on any device. The reference computes
them in jnp outside any Pallas kernel, and so do these: they are plain
PyTorch, no kernel's plain version. Their precision:

- comparisons and bin ids are the reference's float32 IEEE operations.
  :func:`window_bin_ids` bins as the reference's SPMD step does, cell
  sizes from the float32 window as XLA compiles ``(x1 − x0) / bx``: a
  multiply by the float32 reciprocal of the constant ``bx``. The cell
  sizes are made on the host in numpy float32, and every division here
  has a tensor of the objects' shape as divisor (PyTorch turns a scalar
  divisor into a multiply by its reciprocal). :func:`window_bin_ids_params`
  bins by host-precomputed contract params (``ref.window_bin_params``,
  ROADMAP C.3) instead;
- counts are int64 and sums float64 (the reference's float32 is exact
  only below 2²⁴); grouped extrema stay float32 with the ±3.4e38
  sentinels;
- the suffix scans run in the width's own dtype (float32 for the
  engine's selection, as in the reference).
"""
from __future__ import annotations

import numpy as np
import torch

from . import build
from . import ref
from .segment_agg import (agg4, check_spans, host_bounds, param_bin_ids,
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


# --------------------------------------------------------------------- #
# the SPMD session engine's primitives (the reference's jnp expressions)
# --------------------------------------------------------------------- #

NEG = -3.4e38
POS = 3.4e38


def rescaled_params(window, bx: int, by: int) -> np.ndarray:
    """Float32 ``(6,)`` row ``(x0, y0, x1, y1, cw, ch)`` of the
    reference's SPMD binning: the window rounded to float32 and
    ``cw = max((x1 − x0) · f32(1/bx), 1e-30)`` in float32 (the
    reference's ``(x1 − x0) / bx`` as XLA compiles a division by a
    constant), likewise ``ch``."""
    if bx < 1 or by < 1:
        raise ValueError(f"an empty bin grid {bx}x{by}")
    w = np.asarray(window.cpu() if isinstance(window, torch.Tensor)
                   else window, np.float32).reshape(4)
    tiny = np.float32(1e-30)
    cw = np.maximum((w[2] - w[0]) * np.float32(1.0 / bx), tiny)
    ch = np.maximum((w[3] - w[1]) * np.float32(1.0 / by), tiny)
    return np.array([w[0], w[1], w[2], w[3], cw, ch], np.float32)


# the reference's name for the contract-param binning; bin id =
# by_row·bx + bx_col (int64)
window_bin_ids_params = param_bin_ids


def window_bin_ids(xs, ys, window, bx: int, by: int):
    """``(in_window_mask, bin_id)`` of the bx×by heatmap grid laid over
    the closed query window, as the reference's SPMD step bins
    (:func:`rescaled_params`: cell sizes through the float32 reciprocal
    of ``bx``, unlike ``segment_agg.window_bin_ids``, whose cell sizes
    are the host contract's); closed-max-edge objects clip into the
    last bin."""
    p = torch.from_numpy(rescaled_params(window, bx, by)).to(xs.device)
    return window_bin_ids_params(xs, ys, p.expand(xs.shape + (6,)), bx,
                                 by)


def fused_count_val(cell, xs, ys, vals, window, cap: int, nb: int,
                    bx: int, by: int, agg: str,
                    neg: float = NEG, pos: float = POS):
    """One-pass classify + per-(tile, bin) grouped scatter of the local
    objects, pre-merge: flat ``(cap·nb,)`` int64 counts and the value
    table — float64 sums, or float32 grouped extrema with the ``pos`` /
    ``neg`` sentinel where no object landed. Key = ``cell·nb + bin``;
    ``nb = 1`` is the scalar query's per-tile scatter. Only in-window
    objects are binned and scattered (a masked-out object adds the
    channel's neutral element in the reference, which changes no
    cell)."""
    assert agg in ("sum", "min", "max"), agg
    p = torch.from_numpy(rescaled_params(window, bx, by)).to(xs.device)
    inq = ((xs >= p[0]) & (xs <= p[2]) & (ys >= p[1]) & (ys <= p[3]))
    idx = torch.nonzero(inq).squeeze(1)
    torch._check(idx.shape[0] <= xs.shape[0])      # for fake sizes
    xq, yq = xs[idx], ys[idx]
    _, wid = window_bin_ids_params(xq, yq, p.expand(xq.shape + (6,)),
                                   bx, by)
    key = cell[idx].to(torch.int64) * nb + wid
    vq = vals[idx]
    # every key < cap·nb: a scatter of fixed length, where bincount's
    # length would depend on the data
    cnt = torch.zeros(cap * nb, dtype=torch.int64,
                      device=xs.device).index_add_(0, key,
                                                   torch.ones_like(key))
    if agg == "sum":
        val = torch.zeros(cap * nb, dtype=torch.float64,
                          device=xs.device).index_add_(0, key, vq.double())
    else:
        fill = pos if agg == "min" else neg
        val = torch.full((cap * nb,), fill, dtype=torch.float32,
                         device=xs.device).scatter_reduce_(
                             0, key, vq, "amin" if agg == "min" else "amax")
    return cnt, val


def suffix_residual(width_sorted, agg: str = "sum"):
    """Selection-ready suffix statistics over a score-sorted width
    matrix ``(T[, nb])``: the residual width if the first j rows are
    processed, shape ``(T+1[, nb])`` with row T exactly zero.
    ``agg="sum"``: reversed cumsum; min/max: reversed running max
    (``torch.cummax`` of the flipped rows). A reversed scan, never
    total − prefix, so φ = 0 sees an exact 0."""
    zrow = torch.zeros((1,) + tuple(width_sorted.shape[1:]),
                       dtype=width_sorted.dtype, device=width_sorted.device)
    flipped = torch.flip(width_sorted, [0])
    if agg == "sum":
        suf = torch.cumsum(flipped, 0)
    else:
        suf = torch.cummax(flipped, 0).values
    return torch.cat([torch.flip(suf, [0]), zrow])


def segmented_suffix(w, qend):
    """Per-query-span inclusive suffix widths over a packed width matrix
    ``(S[, nb])``: row s sums rows ``s .. qend[s]−1`` of s's own span,
    as one global reversed cumsum minus the gathered span tail (the
    reference's device epilogue)."""
    suf = torch.flip(torch.cumsum(torch.flip(w, [0]), 0), [0])
    pad = torch.cat([suf, torch.zeros((1,) + tuple(w.shape[1:]),
                                      dtype=w.dtype, device=w.device)])
    return suf - pad[torch.as_tensor(qend, device=w.device)]


def _segment_bin_agg4(sids, cid, vals, mask, n_seg: int, k: int):
    """Keyed (segment × bin) reduction: float64 ``(n_seg, k, 4)`` of
    ``(count, sum, min, max)``, out-of-range segment ids masked out."""
    sid = torch.as_tensor(sids, device=vals.device).to(torch.int64)
    m = (sid >= 0) & (sid < n_seg)
    if mask is not None:
        m = m & mask
    key = sid.clamp(0, n_seg - 1) * k + cid
    return agg4(key[m], vals[m], n_seg * k).reshape(n_seg, k, 4)


def segment_window_bin_select_ref(xs, ys, vals, sids, window, grid,
                                  valid, n_seg, vmin_s, vmax_s):
    """Oracle of the fused select over a segment-id plane: the grouped
    table under the SPMD binning (:func:`window_bin_ids`) and the
    reversed-cumsum suffix of ``cnt · (vmax_s − vmin_s)``. Returns
    float64 ``(agg (S, k, 4), suffix_w (S+1, k))``."""
    bx, by = grid
    m, cid = window_bin_ids(xs, ys, window, bx, by)
    if valid is not None:
        m = m & valid
    agg = _segment_bin_agg4(sids, cid, vals, m, n_seg, bx * by)
    w = agg[:, :, 0] * (vmax_s - vmin_s).to(agg)[:, None]
    return agg, suffix_residual(w, "sum")


def segment_window_bin_select_multi_ref(xs, ys, vals, sids, params, grid,
                                        valid, n_seg, vmin_s, vmax_s,
                                        qend):
    """Oracle of the multi-window fused select: segment s masked and
    binned by its own contract params (``ref.window_bin_params`` rows,
    :func:`window_bin_ids_params`), then the per-span suffix
    (:func:`segmented_suffix`). Returns float64 ``(agg (S, k, 4),
    suffix_w (S, k))``."""
    bx, by = grid
    sid = torch.as_tensor(sids, device=vals.device).to(torch.int64)
    p = torch.as_tensor(params, device=vals.device)[sid.clamp(0, n_seg - 1)]
    m, cid = window_bin_ids_params(xs, ys, p, bx, by)
    if valid is not None:
        m = m & valid
    agg = _segment_bin_agg4(sid, cid, vals, m, n_seg, bx * by)
    w = agg[:, :, 0] * (vmax_s - vmin_s).to(agg)[:, None]
    return agg, segmented_suffix(w, qend)
