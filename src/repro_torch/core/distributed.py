"""Distributed AQP engine: session-stateful partial adaptive indexing
over a shard mesh (port of :mod:`repro.core.distributed`).

The raw object store is sharded over a :class:`~repro_torch.core.mesh.
ShardMesh`: each shard owns ``n / n_shards`` contiguous objects. The
session state (:class:`ShardedTileState`) persists across queries:

- ``cell`` — one per-object tile id, sharded like the objects: the
  cracked assignment. Refine epochs rewrite it, so query N+1 starts from
  query N's cracked grid;
- a replicated capacity-bounded tile table (bbox / active / level /
  count / sound value bounds), merged across shards;
- a per-(tile, bin) exact-state registry (:class:`GroupedCache`): the
  grouped in-window aggregates of past reads under the session's current
  window. A repeated viewport answers previously-read tiles from it at
  zero read cost.

One φ-constrained query — scalar (:func:`make_session_query_step`) or
heatmap (:func:`make_session_heatmap_step`) — runs the reference's
classify → score → fold program:

  1. each shard's masked binned scatter over its objects, keyed by the
     persistent ``cell`` ids, merged with the mesh's ``psum`` / ``pmin``
     / ``pmax``;
  2. classification of the tile table against the window; full tiles
     and tiles whose per-(tile, bin) state is cached contribute exactly,
     the rest are pending with intervals from the persistent bounds;
  3. greedy selection by the paper's score: suffix scans over the sorted
     (tiles × bins) width matrix give every prefix's residual, and the
     smallest prefix whose per-bin budgets ``τ_b = max(φ_b·|v_b|,
     ε_abs)`` are met is taken;
  4. the selected tiles' exact contributions replace their intervals, the
     per-bin bound is recomputed, and the reads enter the registry.

A refine epoch (:func:`make_refine_epoch`) splits up to
``DistConfig.epoch_k`` of the tiles the step just read along edges
snapped to the query's bin grid, rewrites their objects' ``cell`` ids
shard by shard and appends the merged child metadata. The
:class:`~repro_torch.core.refine.EpochDriver` runs the session loop, and
:class:`DistributedAQPEngine` records every query into an
:class:`~repro_torch.core.engine.EngineTrace`.

Where the reference runs a jitted ``shard_map`` body, the port runs a
plain function on tensors for each shard the mesh holds here
(:meth:`ShardMesh.map_reduce`), then the mesh's reduction.

Precision, and where it differs from the reference:

- the data plane counts in int64 and sums in float64 (per-tile and
  per-(tile, bin) counts, the tile table's ``count``, ``objects_read``,
  the sums of the scatter, the registry and the answers' values, ``lo``,
  ``hi`` and bounds). The reference's float32 is exact only below 2²⁴,
  which the tiles of 10⁸ rows come close to;
- grouped extrema stay float32 with the reference's ±3.4e38 sentinels;
  a min/max heatmap's answer is float32 arithmetic, as the reference's;
- the tile table's ``bbox``, ``vmin`` and ``vmax`` and the selection
  arithmetic (widths, scores, suffix residuals, budgets and the
  midpoint surrogate) stay the reference's float32, so the port selects
  the reference's prefix. Counts enter that arithmetic as float32, as
  the reference holds them;
- the float32 arithmetic follows the reference as XLA compiles it on the
  CPU, where the tests compare the two: a division by a constant is a
  multiply by the float32 reciprocal of the constant (the bin and grid
  cell sizes), and ``q0 + step·i`` (the bin lines a split snaps to) and
  ``x0 + i·cw`` (the initial grid's tile edges) are fused multiply-adds
  — the port takes them in float64 and rounds once. The even split
  edges ``e0·(1 − f) + e1·f`` are exact for the 2×2 split grid (every
  product exact); another split grid may round an interior edge an ulp
  away from the reference's;
- a step's scalars (window, φ, ε_abs) are float32 values, as the
  reference's ``jnp.float32`` arguments.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels import fused_select as fsel
from ..kernels.segment_agg import clip_cell
from .bounds import (AccuracyPolicy, HeatmapResult, QueryResult,
                     bin_budgets_met, budget_ratios, phi_budgets)
from .engine import EngineTrace
from .mesh import ShardMesh
from .refine import EpochDriver

NEG = fsel.NEG
POS = fsel.POS
F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """Configuration of the sharded session (validated at construction;
    the step builders validate bins with clear errors)."""
    grid: Tuple[int, int] = (32, 32)   # initial cracked grid (host grid0)
    alpha: float = 1.0
    # static cap on tiles processed per query (resource-aware bound, like
    # VETI); default = no cap beyond the table itself
    max_process: int = 1 << 20
    capacity: int = 4096               # tile-table slots (static bound)
    split_grid: Tuple[int, int] = (2, 2)   # refine-epoch split grid
    epoch_k: int = 8                   # tiles split per refine epoch
    min_split_count: int = 256         # I/O-cost split factor (paper §2.2)
    max_level: int = 12
    max_epochs: int = 2                # re-selection passes per query

    def __post_init__(self):
        for name, pair in (("grid", self.grid),
                           ("split_grid", self.split_grid)):
            if len(pair) != 2 or int(pair[0]) <= 0 or int(pair[1]) <= 0:
                raise ValueError(f"DistConfig.{name} must be two positive "
                                 f"ints, got {pair}")
        if self.capacity < self.grid[0] * self.grid[1]:
            raise ValueError(
                f"DistConfig.capacity={self.capacity} cannot hold the "
                f"initial {self.grid[0]}x{self.grid[1]} grid "
                f"({self.grid[0] * self.grid[1]} tiles)")
        if self.epoch_k <= 0:
            raise ValueError(f"epoch_k must be > 0, got {self.epoch_k}")
        if self.max_epochs < 0:
            raise ValueError(f"max_epochs must be >= 0, got "
                             f"{self.max_epochs}")


class ShardedTileState(NamedTuple):
    """Session index state (tensors on the mesh's device; ``cell``
    sharded like the objects, everything else replicated). Persists
    across queries and is refined by :func:`make_refine_epoch`."""
    cell: torch.Tensor     # (n,) int32 — per-object tile id (cracked)
    bbox: torch.Tensor     # (cap, 4) f32 — tile extents [x0, y0, x1, y1]
    active: torch.Tensor   # (cap,) bool — leaf tiles
    level: torch.Tensor    # (cap,) int32
    count: torch.Tensor    # (cap,) int64 — global per-tile object counts
    vmin: torch.Tensor     # (cap,) f32 — sound value bounds (session attr)
    vmax: torch.Tensor     # (cap,) f32
    n_tiles: torch.Tensor  # () int64 — table rows in use


class GroupedCache(NamedTuple):
    """Per-(tile, bin) exact state materialized by past reads — valid
    for ``window`` only (a viewport change invalidates it wholesale; a
    split invalidates the parent's row by deactivating the tile)."""
    cnt_tb: torch.Tensor   # (cap, nb) int64 — exact in-window counts
    val_tb: torch.Tensor   # (cap, nb) f64 sums, or f32 grouped extrema
    valid: torch.Tensor    # (cap,) bool
    window: torch.Tensor   # (4,) f32, on the host — the reads' window


def _check_bins(bins) -> Tuple[int, int]:
    bx, by = int(bins[0]), int(bins[1])
    if bx <= 0 or by <= 0:
        raise ValueError(f"heatmap bins must be positive, got {bins}")
    return bx, by


def _f32(a) -> np.ndarray:
    """A window, domain or scalar as float32 numpy on the host."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a·b + c`` rounded once (a fused multiply-add)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _grid_cell_ids(xs, ys, domain, gx: int, gy: int):
    """Tile cell id (int32) of every local object under the implicit
    gx×gy grid over ``domain`` (the host index's clip-binning ownership
    rule) — the session state's initial cracked assignment."""
    d = _f32(domain)
    cw = torch.tensor((d[2] - d[0]) * np.float32(1.0 / gx), dtype=F32,
                      device=xs.device)
    ch = torch.tensor((d[3] - d[1]) * np.float32(1.0 / gy), dtype=F32,
                      device=xs.device)
    cx = clip_cell((xs - float(d[0])) / cw.expand_as(xs), gx)
    cy = clip_cell((ys - float(d[1])) / ch.expand_as(ys), gy)
    return (cy * gx + cx).to(torch.int32)


def _window_mask(xs, ys, window):
    """Closed-rectangle selection mask (the paper's query semantics)."""
    w = _f32(window)
    return ((xs >= float(w[0])) & (xs <= float(w[2]))
            & (ys >= float(w[1])) & (ys <= float(w[3])))


def _window_bin_ids(xs, ys, window, bx: int, by: int):
    """``(in_window_mask, bin_id)`` of the heatmap grid over the query
    window (:func:`repro_torch.kernels.fused_select.window_bin_ids`)."""
    return fsel.window_bin_ids(xs, ys, window, bx, by)


def _scatter_grouped(cell, wid, inq, vf, cap: int, nb: int, agg: str):
    """One shard's per-(tile, bin) masked binned scatter, pre-merge: the
    in-window count (int64) and value state (float64 sum for
    ``agg="sum"``, float32 grouped extrema for min/max) of every
    (tile, bin) cell, flat ``(cap·nb,)``; the caller merges it across
    shards. The composed counterpart of ``fused_count_val``."""
    dev = vf.device
    key = cell.to(torch.int64) * nb + wid
    cnt = torch.zeros(cap * nb, dtype=torch.int64, device=dev).index_add_(
        0, key, inq.to(torch.int64))
    if agg == "sum":
        val = torch.zeros(cap * nb, dtype=torch.float64,
                          device=dev).index_add_(
            0, key, torch.where(inq, vf, 0.0).double())
    elif agg == "min":
        val = torch.full((cap * nb,), POS, dtype=F32,
                         device=dev).scatter_reduce_(
            0, key, torch.where(inq, vf, POS), "amin")
    else:
        val = torch.full((cap * nb,), NEG, dtype=F32,
                         device=dev).scatter_reduce_(
            0, key, torch.where(inq, vf, NEG), "amax")
    return cnt, val


def _classify_tiles(bbox, active, window):
    """(disjoint, full) masks of the tile table against the closed query
    window. Conservative like the host ``geometry.classify_tiles``:
    borderline tiles demote to partial; inactive rows are disjoint."""
    qx0, qy0, qx1, qy1 = (float(v) for v in _f32(window))
    tx0, ty0, tx1, ty1 = bbox[:, 0], bbox[:, 1], bbox[:, 2], bbox[:, 3]
    disjoint = ((~active) | (tx1 < qx0) | (tx0 > qx1)
                | (ty1 < qy0) | (ty0 > qy1))
    full = (active & (tx0 >= qx0) & (tx1 <= qx1)
            & (ty0 >= qy0) & (ty1 <= qy1))
    return disjoint, full


def _snapped_edges(e0, e1, g: int, q0, q1, b: int):
    """Uniform g+1 split edges of each ``[e0, e1]`` with every interior
    edge snapped to the nearest bin-grid line of ``([q0, q1], b)``
    strictly inside the extent; the uniform edges when no line crosses
    the extent or snapping would collapse two children (the reference's
    ``geometry._snap_axis_edges`` rule, vectorized over tiles).
    ``e0``/``e1`` are (K,) float32; returns (K, g+1) float32."""
    dev = e0.device
    frac_np = np.arange(g + 1, dtype=np.float32) / np.float32(g)
    frac = torch.from_numpy(frac_np).to(dev)
    keep = torch.from_numpy(np.float32(1.0) - frac_np).to(dev)
    edges = e0[:, None] * keep + e1[:, None] * frac
    if b <= 1 or g <= 1:
        return edges
    q0, q1 = np.float32(q0), np.float32(q1)
    step = (q1 - q0) * np.float32(1.0 / b)
    lines = torch.from_numpy(
        _fma(step, np.arange(1, b, dtype=np.float32), q0)).to(dev)
    inside = ((lines[None, :] > e0[:, None])
              & (lines[None, :] < e1[:, None]) & bool(q1 > q0))
    has = inside.any(dim=1)
    d = torch.abs(lines[None, None, :] - edges[:, 1:g, None])
    d = torch.where(inside[:, None, :], d, torch.inf)
    snapped_int = lines[torch.argmin(d, dim=2)]          # (K, g-1)
    snapped = torch.cat([e0[:, None], snapped_int, e1[:, None]], dim=1)
    snapped = torch.sort(snapped, dim=1).values
    collapse = (torch.diff(snapped, dim=1) <= 0).any(dim=1)
    return torch.where((has & ~collapse)[:, None], snapped, edges)


def _empty_cache(cap: int, nb: int, agg: str = "sum",
                 device="cpu") -> GroupedCache:
    return GroupedCache(
        cnt_tb=torch.zeros((cap, nb), dtype=torch.int64, device=device),
        val_tb=torch.zeros((cap, nb), device=device,
                           dtype=torch.float64 if agg == "sum" else F32),
        valid=torch.zeros((cap,), dtype=torch.bool, device=device),
        window=torch.full((4,), float("nan"), dtype=F32))


def _amax0(t):
    """``max(t, initial=0)`` of a float tensor (0 for an empty one)."""
    return torch.clamp(t.max(), min=0.0) if t.numel() else t.new_zeros(())


def _prefix_select(order, j, cap: int, pend):
    """The mask of the first ``j`` rows of ``order`` among ``pend``."""
    ranks = torch.arange(cap, device=pend.device)
    sel = torch.zeros(cap, dtype=torch.bool, device=pend.device)
    sel[order] = ranks < j
    return sel & pend


def _score(pend, w_t, cnt_f, alpha: float):
    """The paper's score of the pending tiles (−inf elsewhere)."""
    w_hat = w_t / torch.clamp(w_t.max(), min=1e-9)
    c_hat = cnt_f / torch.clamp(torch.where(pend, cnt_f, 0.0).max(),
                                min=1e-9)
    inv = torch.div(torch.full_like(c_hat, 1 - alpha),
                    torch.clamp(c_hat, min=1e-9))
    return torch.where(pend, alpha * w_hat + inv, -torch.inf)


# --------------------------------------------------------------------- #
# step builders
# --------------------------------------------------------------------- #

def make_init_state(mesh: ShardMesh, cfg: DistConfig = DistConfig()):
    """Builder of a fresh :class:`ShardedTileState` —
    ``init(xs, ys, vals, domain)``: the crude ``cfg.grid`` cracked
    assignment plus merged per-tile metadata (the analog of the host
    index's init pass)."""
    gx, gy = cfg.grid
    t = gx * gy
    cap = cfg.capacity

    def init(xs, ys, vals, domain):
        dev = xs.device
        cell = torch.empty(len(xs), dtype=torch.int32, device=dev)
        pos = torch.tensor(POS, dtype=F32, device=dev)
        neg = torch.tensor(NEG, dtype=F32, device=dev)

        def local(x, y, v, c):
            cid = _grid_cell_ids(x, y, domain, gx, gy)
            c.copy_(cid)
            key = cid.to(torch.int64)
            cnt = torch.bincount(key, minlength=cap)
            mn = torch.full((cap,), POS, dtype=F32,
                            device=dev).scatter_reduce_(0, key, v, "amin")
            mx = torch.full((cap,), NEG, dtype=F32,
                            device=dev).scatter_reduce_(0, key, v, "amax")
            # empty tiles carry the attribute's global bounds (the host
            # index's root fallback)
            gmn = torch.minimum(v.min(), pos) if len(v) else pos
            gmx = torch.maximum(v.max(), neg) if len(v) else neg
            return cnt, mn, mx, gmn, gmx

        cnt, mn, mx, gmn, gmx = mesh.map_reduce(
            local, (xs, ys, vals, cell), ("sum", "min", "max", "min", "max"))
        vmin = torch.where(cnt > 0, mn, gmn)
        vmax = torch.where(cnt > 0, mx, gmx)
        d = _f32(domain)
        cw = (d[2] - d[0]) * np.float32(1.0 / gx)
        ch = (d[3] - d[1]) * np.float32(1.0 / gy)
        ti = np.arange(cap)
        tx0 = _fma((ti % gx).astype(np.float32), cw, d[0])
        ty0 = _fma((ti // gx).astype(np.float32), ch, d[1])
        bbox = np.stack([tx0, ty0, tx0 + cw, ty0 + ch], axis=1)
        return ShardedTileState(
            cell=cell, bbox=torch.from_numpy(bbox).to(dev),
            active=torch.arange(cap, device=dev) < t,
            level=torch.zeros(cap, dtype=torch.int32, device=dev),
            count=cnt, vmin=vmin, vmax=vmax,
            n_tiles=torch.tensor(t, dtype=torch.int64, device=dev))

    return init


def make_session_query_step(mesh: ShardMesh, cfg: DistConfig = DistConfig(),
                            fused: bool = True):
    """Scalar (sum) query step over the session state:
    ``step(state, xs, ys, vals, window, phi)`` — classification, pending
    intervals and selection all come from the persistent tile table.

    ``fused=True`` (default) runs each shard's classify→scatter through
    :func:`~repro_torch.kernels.fused_select.fused_count_val` and the
    selection suffix through ``suffix_residual``; ``fused=False`` keeps
    the composed chain. The two are bit for bit identical on the CPU."""
    cap = cfg.capacity

    def step(state, xs, ys, vals, window, phi):
        w = _f32(window)
        phi = float(np.float32(phi))

        def local(x, y, v, c):
            if fused:
                return fsel.fused_count_val(c, x, y, v, w, cap, 1, 1, 1,
                                            "sum")
            inq = _window_mask(x, y, w)
            return _scatter_grouped(c, torch.zeros_like(c, dtype=torch.int64),
                                    inq, v, cap, 1, "sum")

        cnt_q, s_q = mesh.map_reduce(local, (xs, ys, vals, state.cell),
                                     ("sum", "sum"))
        disjoint, full = _classify_tiles(state.bbox, state.active, w)
        partial = (~disjoint) & (~full) & (cnt_q > 0)
        cnt_f = cnt_q.to(F32)

        # --- CI from the persistent metadata (sum aggregate; §3.1) ---
        exact_sum = torch.where(full, s_q, 0.0).sum()
        lo_p = torch.where(partial, cnt_f * state.vmin, 0.0)
        hi_p = torch.where(partial, cnt_f * state.vmax, 0.0)
        mid_p = torch.where(partial,
                            cnt_f * 0.5 * (state.vmin + state.vmax), 0.0)

        # --- score + greedy selection via suffix sums ---
        width = hi_p - lo_p
        score = _score(partial, width, cnt_f, cfg.alpha)
        order = torch.argsort(-score, stable=True)
        width_sorted = width[order]
        if fused:
            resid = fsel.suffix_residual(width_sorted, "sum")
        else:
            # reversed cumsum, not total − prefix: φ = 0 must see 0
            resid = torch.cat([torch.flip(torch.cumsum(
                torch.flip(width_sorted, [0]), 0), [0]),
                torch.zeros(1, dtype=F32, device=width.device)])
        approx0 = exact_sum.to(F32) + mid_p.sum()
        surrogate = (0.5 * resid) / torch.clamp(torch.abs(approx0),
                                                min=1e-9)
        n_partial = partial.sum()
        jmeet = torch.argmax((surrogate <= phi).to(torch.uint8))
        j = torch.clamp(torch.minimum(jmeet, n_partial), max=cfg.max_process)

        sel = _prefix_select(order, j, cap, partial)
        # processed tiles contribute exact values; the rest midpoints
        value = exact_sum + torch.where(sel, s_q, mid_p.double()).sum()
        lo = exact_sum + torch.where(sel, s_q, lo_p.double()).sum()
        hi = exact_sum + torch.where(sel, s_q, hi_p.double()).sum()
        bound = torch.maximum(hi - value, value - lo) / torch.clamp(
            torch.abs(value), min=1e-9)
        return {"value": value, "lo": lo, "hi": hi, "bound": bound,
                "budget_bound": bound, "n_processed": j,
                "n_partial": n_partial,
                "n_full": (full & (state.count > 0)).sum(),
                "objects_read": torch.where(sel, state.count, 0).sum(),
                "sel": sel}

    return step


def make_session_heatmap_step(mesh: ShardMesh, cfg: DistConfig,
                              bins: Tuple[int, int], agg: str = "sum",
                              with_policy: bool = False,
                              fused: bool = True):
    """Distributed HEATMAP (2-D group-by) step over the session state:
    ``step(state, cache, xs, ys, vals, window, phi, phi_b, eps_abs) →
    (out, new_cache)``.

    Classification and pending intervals come from the persistent tile
    table, previously-read tiles answer from the per-(tile, bin)
    registry at zero read cost, and selection stops at the per-bin
    budgets ``τ_b = max(φ_b·|v_b|, ε_abs)`` (``with_policy=True``; the
    ``with_policy=False`` build takes the same arguments but tests the
    scalar φ — the two are bit for bit identical under the uniform
    policy). ``fused`` as in :func:`make_session_query_step`."""
    assert agg in ("sum", "min", "max"), agg
    bx, by = _check_bins(bins)
    nb = bx * by
    cap = cfg.capacity
    red = torch.amin if agg == "min" else torch.amax
    sent = POS if agg == "min" else NEG
    merge = {"sum": "sum", "min": "min", "max": "max"}[agg]

    def step(state, cache, xs, ys, vals, window, phi, phi_b, eps_abs):
        w = _f32(window)
        phi = float(np.float32(phi))
        eps_abs = float(np.float32(eps_abs))
        dev = state.vmin.device
        phi_b = torch.as_tensor(_f32(phi_b), device=dev)

        def local(x, y, v, c):
            if fused:
                return fsel.fused_count_val(c, x, y, v, w, cap, nb, bx, by,
                                            agg, neg=NEG, pos=POS)
            inq, wid = _window_bin_ids(x, y, w, bx, by)
            return _scatter_grouped(c, wid, inq, v, cap, nb, agg)

        cnt_tb, v_tb = mesh.map_reduce(local, (xs, ys, vals, state.cell),
                                       ("sum", merge))
        cnt_tb = cnt_tb.reshape(cap, nb)
        v_tb = v_tb.reshape(cap, nb)
        mn, mx = state.vmin, state.vmax

        # --- classification + per-(tile, bin) exact-state reuse ---
        disjoint, full = _classify_tiles(state.bbox, state.active, w)
        cnt_q = cnt_tb.sum(dim=1)
        partial = (~disjoint) & (~full) & (cnt_q > 0)
        same_win = bool(torch.equal(cache.window, torch.from_numpy(w)))
        cached = cache.valid & partial & same_win
        # cached rows are authoritative: the registry holds the exact
        # grouped state those reads materialized
        cnt_tb = torch.where(cached[:, None], cache.cnt_tb, cnt_tb)
        v_tb = torch.where(cached[:, None], cache.val_tb, v_tb)
        touch = cnt_tb > 0
        occ = cnt_tb.sum(dim=0) > 0
        exact_t = full | cached
        pend = partial & ~cached
        n_partial = pend.sum()
        cnt_f = cnt_tb.to(F32)

        # --- grouped pending intervals + initial midpoint surrogate ---
        if agg == "sum":
            exact_b = torch.where(exact_t[:, None], v_tb, 0.0).sum(dim=0)
            lo_tb = torch.where(pend[:, None], cnt_f * mn[:, None], 0.0)
            hi_tb = torch.where(pend[:, None], cnt_f * mx[:, None], 0.0)
            mid_tb = torch.where(pend[:, None],
                                 cnt_f * (0.5 * (mn + mx))[:, None], 0.0)
            width_tb = hi_tb - lo_tb
            approx0_b = exact_b.to(F32) + mid_tb.sum(dim=0)
        else:
            ex0 = red(torch.where(exact_t[:, None] & touch, v_tb, sent),
                      dim=0)
            p_lo0 = red(torch.where(pend[:, None] & touch, mn[:, None],
                                    sent), dim=0)
            p_hi0 = red(torch.where(pend[:, None] & touch, mx[:, None],
                                    sent), dim=0)
            lo0 = red(torch.stack([ex0, p_lo0]), dim=0)
            hi0 = red(torch.stack([ex0, p_hi0]), dim=0)
            approx0_b = 0.5 * (lo0 + hi0)
        denom0 = torch.clamp(torch.abs(approx0_b), min=1e-9)

        # --- grouped score: worst per-bin CI width / value range,
        #     budget-normalized under a φ_b policy ---
        if with_policy:
            # inverse deviation budgets 1/τ_b as bin weights (don't-care
            # bins, φ_b = ∞, weigh 0)
            tau0 = phi_budgets(phi_b, denom0, eps_abs, xp=torch)
            bin_w = torch.where(torch.isinf(tau0), 0.0,
                                1.0 / torch.clamp(tau0, min=1e-30))
            if agg == "sum":
                w_t = (width_tb * bin_w[None, :]).amax(dim=1)
            else:
                w_t = torch.where(pend, mx - mn, 0.0) * torch.where(
                    touch, bin_w[None, :], 0.0).amax(dim=1)
            # clamp below f32 inf so w_hat stays NaN-free (a NaN score
            # would sort the widest pending tiles out of the selection)
            w_t = torch.clamp(w_t, max=POS)
        elif agg == "sum":
            w_t = width_tb.amax(dim=1)
        else:
            w_t = torch.where(pend, mx - mn, 0.0)
        score = _score(pend, w_t, cnt_q.to(F32), cfg.alpha)
        order = torch.argsort(-score, stable=True)

        # --- greedy selection via suffix scans ---
        if agg == "sum":
            width_sorted = width_tb[order]
            if fused:
                resid = fsel.suffix_residual(width_sorted, "sum")
            else:
                resid = torch.cat([torch.flip(torch.cumsum(
                    torch.flip(width_sorted, [0]), 0), [0]),
                    torch.zeros((1, nb), dtype=F32, device=dev)])
        else:
            # an unprocessed pending tile leaves at most its value-range
            # width on every bin it touches: a suffix running max
            wb_tb = torch.where(pend[:, None] & touch,
                                (mx - mn)[:, None], 0.0)
            if fused:
                resid = fsel.suffix_residual(wb_tb[order], agg)
            else:
                resid = torch.cat([torch.flip(torch.cummax(
                    torch.flip(wb_tb[order], [0]), 0).values, [0]),
                    torch.zeros((1, nb), dtype=F32, device=dev)])
        ratio = (0.5 * resid) / denom0[None, :]
        if with_policy:
            # a prefix meets once every occupied bin's residual fits its
            # own budget; the uniform policy is bit for bit the scalar
            # test below
            ok = ((~occ)[None, :] | (ratio <= phi_b[None, :])
                  | (0.5 * resid <= eps_abs))
            meets = ok.all(dim=1)
        else:
            surr = torch.where(occ[None, :], ratio, 0.0)
            meets = surr.amax(dim=1) <= phi
        jmeet = torch.argmax(meets.to(torch.uint8))
        j = torch.clamp(torch.minimum(jmeet, n_partial), max=cfg.max_process)

        sel = _prefix_select(order, j, cap, pend)
        sel_c = sel[:, None]
        if agg == "sum":
            values = exact_b + torch.where(sel_c, v_tb,
                                           mid_tb.double()).sum(dim=0)
            lo = exact_b + torch.where(sel_c, v_tb, lo_tb.double()).sum(dim=0)
            hi = exact_b + torch.where(sel_c, v_tb, hi_tb.double()).sum(dim=0)
            dev_b = torch.maximum(hi - values, values - lo)
        else:
            # exact parts: full ∪ cached ∪ selected tiles' grouped
            # extrema; unprocessed pending tiles keep their intervals
            ex_b = red(torch.where((exact_t | sel)[:, None] & touch, v_tb,
                                   sent), dim=0)
            pendm = pend[:, None] & (~sel_c) & touch
            p_lo = red(torch.where(pendm, mn[:, None], sent), dim=0)
            p_hi = red(torch.where(pendm, mx[:, None], sent), dim=0)
            lo = red(torch.stack([ex_b, p_lo]), dim=0)
            hi = red(torch.stack([ex_b, p_hi]), dim=0)
            mid = 0.5 * (lo + hi)
            values = torch.where(occ, mid, sent)
            dev_b = torch.where(occ, torch.maximum(hi - values,
                                                   values - lo), 0.0)
        bin_bound = torch.where(
            occ & (dev_b > 0),
            dev_b / torch.clamp(torch.abs(values), min=1e-9), 0.0)
        bound = _amax0(bin_bound)
        if with_policy:
            # the driver's stopping quantity: the φ-scaled worst budget
            # ratio; the φ = 0 fallback zeroes the budgets, where it
            # reports the plain bound
            tau = phi_budgets(phi_b, torch.clamp(torch.abs(values),
                                                 min=1e-9), eps_abs,
                              xp=torch)
            dev_f = torch.where(occ & torch.isfinite(dev_b), dev_b, 0.0)
            ratios = budget_ratios(dev_f, tau, xp=torch)
            budget_bound = (phi * _amax0(torch.where(
                torch.isfinite(ratios), ratios, 0.0))
                if phi > 0 else bound)
            bin_met = bin_budgets_met(dev_b, values, phi_b, eps_abs, occ,
                                      xp=torch)
        else:
            budget_bound = bound
            bin_met = bin_budgets_met(dev_b, values, phi, 0.0, occ,
                                      xp=torch)

        # --- write the round's reads into the exact-state registry ---
        nvalid = (cache.valid & same_win) | sel
        new_cache = GroupedCache(
            cnt_tb=torch.where(nvalid[:, None], cnt_tb, 0),
            val_tb=torch.where(nvalid[:, None], v_tb, 0.0),
            valid=nvalid, window=torch.from_numpy(w.copy()))
        out = {"values": values, "lo": lo, "hi": hi,
               "bin_bound": bin_bound, "bound": bound,
               "budget_bound": budget_bound, "bin_met": bin_met,
               "bin_count": cnt_tb.sum(dim=0),
               "n_processed": j, "n_partial": n_partial,
               "n_cached": cached.sum(),
               "n_full": (full & (state.count > 0)).sum(),
               "objects_read": torch.where(sel, state.count, 0).sum(),
               "sel": sel}
        return out, new_cache

    return step


def make_refine_epoch(mesh: ShardMesh, cfg: DistConfig,
                      bins: Tuple[int, int] = (1, 1)):
    """Sharded refine epoch: ``epoch(state, xs, ys, vals, window, sel)
    → (new_state, info)``.

    Splits up to ``cfg.epoch_k`` of the tiles ``sel`` marks (the ones
    the preceding selection step just read — zero additional I/O) along
    ``cfg.split_grid`` edges snapped to the bin grid of ``bins`` laid
    over ``window`` (``bins=(1, 1)`` degenerates to the even split),
    rewriting each shard's ``cell`` ids and appending the merged child
    metadata to the replicated table."""
    gx, gy = cfg.split_grid
    k = gx * gy
    kk = cfg.epoch_k
    cap = cfg.capacity
    bx, by = _check_bins(bins)

    def epoch(state, xs, ys, vals, window, sel):
        w = _f32(window)
        dev = state.vmin.device
        sel = torch.as_tensor(sel, device=dev)
        # split candidates: tiles the preceding step just READ
        elig = (sel & state.active
                & (state.count >= cfg.min_split_count)
                & (state.level < cfg.max_level))
        score = torch.where(
            elig, (state.vmax - state.vmin) * state.count.to(F32),
            -torch.inf)
        n_elig = elig.sum()
        room = torch.clamp((cap - state.n_tiles) // k, min=0)
        n_val = torch.minimum(torch.clamp(n_elig, max=kk), room)
        order = torch.argsort(-score, stable=True)
        parents = order[:kk]                               # (K,)
        kp = len(parents)
        slots = torch.arange(kp, device=dev)
        slot_ok = slots < n_val

        # bin-aligned split edges, snapped to THIS query's bin grid
        pb = state.bbox[parents]
        xe = _snapped_edges(pb[:, 0], pb[:, 2], gx, w[0], w[2], bx)
        ye = _snapped_edges(pb[:, 1], pb[:, 3], gy, w[1], w[3], by)

        # each shard rewrites its objects' cell ids: objects of split
        # parents move to their child's fresh table row
        slot_of = torch.full((cap,), -1, dtype=torch.int64, device=dev)
        slot_of[parents[slot_ok]] = slots[slot_ok]
        new_cell = torch.empty_like(state.cell)

        def local(x, y, v, c, c_new):
            c_new.copy_(c)
            j = slot_of[c.to(torch.int64)]
            idx = torch.nonzero(j >= 0).squeeze(1)
            torch._check(idx.shape[0] <= c.shape[0])   # for fake sizes
            jj = j[idx]
            xq, yq = x[idx], y[idx]
            cx = torch.zeros_like(jj)
            for i in range(1, gx):
                cx += (xq >= xe[jj, i]).to(torch.int64)
            cy = torch.zeros_like(jj)
            for i in range(1, gy):
                cy += (yq >= ye[jj, i]).to(torch.int64)
            ckey = jj * k + cy * gx + cx
            c_new[idx] = (state.n_tiles + ckey).to(torch.int32)
            vq = v[idx]
            # a scatter of fixed length (every key < kp·k), where bincount's
            # length would depend on the data
            ccnt = torch.zeros(kp * k, dtype=torch.int64,
                               device=dev).index_add_(0, ckey,
                                                      torch.ones_like(ckey))
            cmn = torch.full((kp * k,), POS, dtype=F32,
                             device=dev).scatter_reduce_(0, ckey, vq, "amin")
            cmx = torch.full((kp * k,), NEG, dtype=F32,
                             device=dev).scatter_reduce_(0, ckey, vq, "amax")
            return ccnt, cmn, cmx

        ccnt, cmn, cmx = mesh.map_reduce(
            local, (xs, ys, vals, state.cell, new_cell),
            ("sum", "min", "max"))
        ccnt = ccnt.reshape(kp, k)
        cmn = cmn.reshape(kp, k)
        cmx = cmx.reshape(kp, k)
        # children clamp into the parent's sound interval; empty
        # children inherit it outright
        pv_lo = state.vmin[parents][:, None]
        pv_hi = state.vmax[parents][:, None]
        cvmin = torch.where(ccnt > 0, torch.maximum(cmn, pv_lo), pv_lo)
        cvmax = torch.where(ccnt > 0, torch.minimum(cmx, pv_hi), pv_hi)

        # child extents from the snapped edges (row-major y, like host)
        ci = torch.arange(k, device=dev)
        cxs, cys = ci % gx, ci // gx
        cb = torch.stack([xe[:, cxs], ye[:, cys], xe[:, cxs + 1],
                          ye[:, cys + 1]], dim=-1)       # (K, k, 4)

        # one masked table append for all children of all valid slots
        rows = torch.where(slot_ok[:, None],
                           state.n_tiles + slots[:, None] * k + ci[None, :],
                           cap).reshape(-1)
        keep = rows < cap
        rows_k = rows[keep]
        prow = parents[slot_ok]
        clev = (state.level[parents] + 1)[:, None].expand(kp, k).reshape(-1)
        bbox2 = state.bbox.clone()
        bbox2[rows_k] = cb.reshape(-1, 4)[keep]
        active2 = state.active.clone()
        active2[rows_k] = True
        active2[prow] = False
        level2 = state.level.clone()
        level2[rows_k] = clev[keep]
        count2 = state.count.clone()
        count2[rows_k] = ccnt.reshape(-1)[keep]
        vmin2 = state.vmin.clone()
        vmin2[rows_k] = cvmin.reshape(-1)[keep]
        vmax2 = state.vmax.clone()
        vmax2[rows_k] = cvmax.reshape(-1)[keep]
        new_state = ShardedTileState(
            cell=new_cell, bbox=bbox2, active=active2, level=level2,
            count=count2, vmin=vmin2, vmax=vmax2,
            n_tiles=state.n_tiles + n_val * k)
        info = {"n_split": n_val,
                "objects_reorganized": torch.where(
                    slot_ok, state.count[parents], 0).sum()}
        return new_state, info

    return epoch


# --------------------------------------------------------------------- #
# stateless one-shot wrappers (the original step contracts)
# --------------------------------------------------------------------- #

def make_query_step(mesh: ShardMesh, cfg: DistConfig = DistConfig()):
    """Stateless one-shot query step:
    ``step(xs, ys, vals, domain, window, phi)`` → dict of replicated
    scalars (value/lo/hi/bound/n_processed/n_partial/objects_read),
    from a fresh session state per call (the crude ``cfg.grid``)."""
    init = make_init_state(mesh, cfg)
    sess = make_session_query_step(mesh, cfg)

    def step(xs, ys, vals, domain, window, phi):
        out = sess(init(xs, ys, vals, domain), xs, ys, vals, window, phi)
        return {key: out[key] for key in
                ("value", "lo", "hi", "bound", "n_processed",
                 "n_partial", "objects_read")}
    return step


def make_heatmap_step(mesh: ShardMesh, cfg: DistConfig,
                      bins: Tuple[int, int], agg: str = "sum"):
    """Stateless one-shot heatmap step:
    ``step(xs, ys, vals, domain, window, phi)`` → dict of replicated
    per-bin tensors (values/lo/hi/bin_bound/bin_count) and scalars
    (bound/n_processed/n_partial/objects_read). For min/max, empty bins
    carry the ±``3.4e38`` sentinel (the engine maps them to ±inf)."""
    bx, by = _check_bins(bins)
    nb = bx * by
    init = make_init_state(mesh, cfg)
    sess = make_session_heatmap_step(mesh, cfg, (bx, by), agg,
                                     with_policy=False)

    def step(xs, ys, vals, domain, window, phi):
        out, _ = sess(init(xs, ys, vals, domain),
                      _empty_cache(cfg.capacity, nb, agg, xs.device),
                      xs, ys, vals, window, phi, np.zeros(nb, np.float32),
                      0.0)
        return {key: out[key] for key in
                ("values", "lo", "hi", "bin_bound", "bound", "bin_count",
                 "n_processed", "n_partial", "objects_read")}
    return step


# --------------------------------------------------------------------- #
# the session engine
# --------------------------------------------------------------------- #

def _host(out) -> dict:
    return {key: v.cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for key, v in out.items()}


class DistributedAQPEngine:
    """Host-facing session wrapper: shards a dataset over the mesh once,
    keeps one :class:`ShardedTileState` per queried attribute (plus a
    per-(attr, bins, agg) grouped exact-state registry), and serves
    φ-constrained queries through the :class:`~repro_torch.core.refine.
    EpochDriver` loop — select → re-select on a budget miss (earlier
    passes' reads answer from the registry) → exact-ish φ = 0 fallback →
    crack-what-you-read. Every query appends a :class:`QueryResult` /
    :class:`HeatmapResult` to :attr:`trace`.

    The mesh sets the device: ``ShardMesh(n_shards)`` runs on the card
    (and raises without one); the CPU only when the mesh asks for it.
    ``dataset`` may be a :class:`~repro_torch.data.rawfile.RawDataset`
    or a :class:`~repro_torch.data.chunked.ChunkedDataset`, held as a
    snapshot of its live chunks (in insertion order) at construction:
    later ``ingest``/``retire`` calls do not reshard."""

    def __init__(self, dataset, mesh: ShardMesh,
                 cfg: DistConfig = DistConfig(), *,
                 defer_epochs: bool = False):
        self.mesh = mesh
        self.cfg = cfg
        # with defer_epochs=True, refine epochs are STAGED instead of
        # applied inside the query — the session state stays frozen for
        # a whole serving tick, and publish_epochs() applies them
        self.defer_epochs = bool(defer_epochs)
        self._staged_epochs: List[tuple] = []
        n_dev = mesh.n_shards
        n = (dataset.n // n_dev) * n_dev  # truncate to shardable length
        if n == 0:
            raise ValueError(
                f"dataset of {dataset.n} objects cannot be sharded over "
                f"{n_dev} shards (fewer objects than shards)")
        self.n = n
        self.xs = mesh.place(dataset.x, n)
        self.ys = mesh.place(dataset.y, n)
        self.vals = {a: mesh.place(dataset.read_all_unaccounted(a), n)
                     for a in dataset.attributes}
        self.domain = np.asarray(dataset.domain(), np.float32)
        self.trace = EngineTrace()
        self._init = make_init_state(mesh, cfg)
        self._query_step = make_session_query_step(mesh, cfg)
        self._states: Dict[str, ShardedTileState] = {}
        self._caches: Dict[tuple, GroupedCache] = {}
        self._heatmap_steps = {}   # (bx, by, agg, policy) → step
        self._epochs = {}          # (bx, by) → refine epoch

    # ------------------------- plumbing ------------------------------ #
    def _state(self, attr: str) -> ShardedTileState:
        if attr not in self._states:
            self._states[attr] = self._init(self.xs, self.ys,
                                            self.vals[attr], self.domain)
        return self._states[attr]

    def reset_session(self, attr: Optional[str] = None):
        """Drop the cracked state (and caches) — back to the crude grid."""
        if attr is None:
            self._states.clear()
            self._caches.clear()
        else:
            self._states.pop(attr, None)
            for key in [c for c in self._caches if c[0] == attr]:
                self._caches.pop(key)

    def _epoch(self, bins: Tuple[int, int]):
        if bins not in self._epochs:
            self._epochs[bins] = make_refine_epoch(self.mesh, self.cfg,
                                                   bins)
        return self._epochs[bins]

    def _heatmap_step(self, bins, agg: str, with_policy: bool):
        key = (bins[0], bins[1], agg, with_policy)
        if key not in self._heatmap_steps:
            self._heatmap_steps[key] = make_session_heatmap_step(
                self.mesh, self.cfg, bins, agg, with_policy)
        return self._heatmap_steps[key]

    def _epoch_runner(self, holder, attr: str, bins, win):
        """The EpochDriver's ``run_epoch`` hook, shared by both query
        paths: crack the tiles the final pass read, persist the state
        in the caller's holder, report how many split. Under
        ``defer_epochs`` the crack is staged instead, with the query's
        selection mask, for :meth:`publish_epochs`."""
        epoch = self._epoch(bins)

        def run_epoch(out):
            if self.defer_epochs:
                self._staged_epochs.append(
                    (attr, bins, np.array(win), np.array(out["sel"])))
                return 0
            st2, info = epoch(holder["state"], self.xs, self.ys,
                              self.vals[attr], win, out["sel"])
            holder["state"] = st2
            return int(info["n_split"])
        return run_epoch

    def publish_epochs(self) -> Dict[str, int]:
        """Apply every staged refine epoch in arrival order and
        invalidate the registry rows of tiles the publication
        deactivated. A tile split by an earlier staged epoch is inactive
        when a later epoch's selection mask reaches it, so it drops out
        of that epoch's eligibility (``sel & active``): a tile never
        splits twice."""
        staged, self._staged_epochs = self._staged_epochs, []
        n_split = 0
        touched = set()
        for attr, bins, win, sel in staged:
            if attr not in self._states:
                continue
            st2, info = self._epoch(bins)(
                self._states[attr], self.xs, self.ys, self.vals[attr],
                win, sel)
            self._states[attr] = st2
            n_split += int(info["n_split"])
            touched.add(attr)
        invalidated = 0
        for attr in touched:
            invalidated += self._invalidate_caches(attr)
        return {"epochs_published": len(staged), "tiles_split": n_split,
                "cache_rows_invalidated": invalidated}

    def _invalidate_caches(self, attr: str) -> int:
        """Drop registry rows of tiles no longer active in the
        published state (split parents); returns rows cleared."""
        active = self._states[attr].active
        dropped = 0
        for key, cache in list(self._caches.items()):
            if key[0] != attr:
                continue
            stale = int((cache.valid & ~active).sum())
            if not stale:
                continue
            dropped += stale
            nvalid = cache.valid & active
            self._caches[key] = GroupedCache(
                cnt_tb=torch.where(nvalid[:, None], cache.cnt_tb, 0),
                val_tb=torch.where(nvalid[:, None], cache.val_tb, 0.0),
                valid=nvalid, window=cache.window)
        return dropped

    @property
    def n_active(self) -> Dict[str, int]:
        """Active tile count per attribute session (diagnostics)."""
        return {a: int(s.active.sum()) for a, s in self._states.items()}

    # ------------------------- queries ------------------------------- #
    def query(self, window, attr: str, phi: float) -> QueryResult:
        """One φ-constrained scalar (sum) window aggregate over the
        session state; returns a :class:`QueryResult` (recorded in
        :attr:`trace`)."""
        t0 = time.perf_counter()
        win = _f32(window)
        holder = {"state": self._state(attr)}

        def run_step(p):
            return _host(self._query_step(holder["state"], self.xs,
                                          self.ys, self.vals[attr], win, p))

        # stateful_steps=False: the scalar step has no per-pass read
        # registry, so a same-φ re-selection would be identical
        out, stats = EpochDriver(
            run_step, self._epoch_runner(holder, attr, (1, 1), win),
            phi, max_epochs=self.cfg.max_epochs,
            max_process=self.cfg.max_process, stateful_steps=False).run()
        self._states[attr] = holder["state"]
        r = QueryResult(
            agg="sum", attr=attr, value=float(out["value"]),
            lo=float(out["lo"]), hi=float(out["hi"]),
            bound=float(out["bound"]),
            exact=int(out["n_processed"]) >= int(out["n_partial"]),
            tiles_full=int(out["n_full"]),
            tiles_partial=int(out["n_partial"]),
            tiles_processed=stats.tiles_processed,
            objects_read=stats.objects_read, read_calls=stats.rounds,
            batch_rounds=stats.epochs,
            eval_time_s=time.perf_counter() - t0)
        self.trace.results.append(r)
        return r

    def heatmap(self, window, attr: str, bins: Tuple[int, int] = (8, 8),
                phi: float = 0.0, agg: str = "sum",
                policy: Optional[AccuracyPolicy] = None) -> HeatmapResult:
        """One φ-constrained heatmap (2-D group-by) query over the
        session state; returns a :class:`HeatmapResult` (flat per-bin
        arrays, empty min/max bins ±inf; recorded in :attr:`trace`).
        ``policy`` allocates the constraint per bin; a trivial policy
        (or φ = 0) runs the plain scalar-φ build."""
        t0 = time.perf_counter()
        bins = _check_bins(bins)
        nb = bins[0] * bins[1]
        with_policy = (policy is not None and phi > 0.0
                       and not policy.is_uniform())
        phi_b = (policy.phi_b(phi, bins).astype(np.float32)
                 if with_policy else None)
        eps_abs = float(policy.eps_abs) if with_policy else 0.0
        step = self._heatmap_step(bins, agg, with_policy)
        ckey = (attr, bins[0], bins[1], agg)
        if ckey not in self._caches:
            self._caches[ckey] = _empty_cache(self.cfg.capacity, nb, agg,
                                              self.mesh.device)
        win = _f32(window)
        holder = {"state": self._state(attr),
                  "cache": self._caches[ckey]}
        zeros = np.zeros(nb, np.float32)

        def run_step(p):
            if with_policy and p > 0.0:
                pb, ea = phi_b, eps_abs
            else:
                # the φ = 0 fallback (and the uniform build) processes
                # to exactness — zeroed budgets, scalar test
                pb, ea = zeros, 0.0
            out, cache2 = step(holder["state"], holder["cache"], self.xs,
                               self.ys, self.vals[attr], win, p, pb, ea)
            holder["cache"] = cache2
            return _host(out)

        out, stats = EpochDriver(
            run_step, self._epoch_runner(holder, attr, bins, win), phi,
            max_epochs=self.cfg.max_epochs,
            max_process=self.cfg.max_process).run()
        self._states[attr] = holder["state"]
        self._caches[ckey] = holder["cache"]

        values = out["values"].astype(np.float64)
        lo = out["lo"].astype(np.float64)
        hi = out["hi"].astype(np.float64)
        bin_met = None
        if with_policy:
            # the verdict against the USER's budgets: the final pass may
            # have been the φ = 0 fallback, whose in-step bin_met was
            # evaluated under zeroed budgets
            occ = out["bin_count"] > 0
            with np.errstate(invalid="ignore"):
                dev = np.maximum(hi - values, values - lo)
            bin_met = bin_budgets_met(dev, values,
                                      phi_b.astype(np.float64), eps_abs,
                                      occ)
        if agg in ("min", "max"):
            # empty bins carry the f32 ±3.4e38 sentinel; the
            # HeatmapResult convention is ±inf
            empty = out["bin_count"] == 0
            fill = np.inf if agg == "min" else -np.inf
            values = np.where(empty, fill, values)
            lo = np.where(empty, fill, lo)
            hi = np.where(empty, fill, hi)
        r = HeatmapResult(
            agg=agg, attr=attr, bins=bins, values=values, lo=lo, hi=hi,
            bin_bound=out["bin_bound"].astype(np.float64),
            bound=float(out["bound"]),
            exact=int(out["n_processed"]) >= int(out["n_partial"]),
            tiles_full=int(out["n_full"]),
            tiles_partial=int(out["n_partial"]),
            tiles_processed=stats.tiles_processed,
            objects_read=stats.objects_read, read_calls=stats.rounds,
            batch_rounds=stats.epochs,
            eval_time_s=time.perf_counter() - t0,
            phi_b=(phi_b.astype(np.float64) if with_policy else None),
            eps_abs=eps_abs, bin_met=bin_met)
        self.trace.results.append(r)
        return r

    def refine(self, attr: str, window=None,
               bins: Tuple[int, int] = (1, 1)) -> dict:
        """Force one refine epoch over the session state (all active
        tiles are candidates; ``window``/``bins`` set the snapping grid —
        default: even splits over the whole domain)."""
        state = self._state(attr)
        win = _f32(window) if window is not None else self.domain
        st2, info = self._epoch(_check_bins(bins))(
            state, self.xs, self.ys, self.vals[attr], win, state.active)
        self._states[attr] = st2
        return {key: int(v) for key, v in info.items()}
