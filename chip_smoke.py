#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py [--seed 0] [--rows 100000000] [--queries 50]
                          [--ticks 10] [--reps 20] [--chunk-rows 3333334]
                          [--pan-steps 24] [--clocks-of TREE]

Phases (each prints its own lines; any failure exits non-zero):

1. Card and build: the card's name and power limit (``nvidia-smi``),
   torch/CUDA versions, and the kernels built from ``src/repro_torch/
   kernels/csrc`` (one ``nvcc`` per source, in parallel).
2. Kernels against their plain PyTorch versions, on the card: the main
   path's shapes (8 segments of ~4e5 objects, 2x2 split cells), a stress
   shape (64 segments, 1.6e7 objects, 4x4 cells) and edge cases (NaN
   values and planes at different offsets mod 16 among them), the
   enrichment's all-covering ``segment_window_agg`` entry at the first
   two as well; counts and extrema must be equal, float64 sums
   within 1e-12 * sum|v| per cell, a NaN on both sides equal; a host
   sample is also held against the float64 numpy mirrors.
3. The main path at the paper's scale: a synthetic dataset of ``--rows``
   objects with 10 value columns resident on the card, an ``AQPEngine``
   with the default ``IndexConfig`` (16x16 initial grid, the "cuda"
   backend), the 50-window exploration path of ~1e5 objects per window
   for ``mean(a0)`` at phi = 0.05 and then phi = 0; every answer checked
   against an on-device float64 oracle; a second engine replays the
   first 10 windows on the sequential path and must end with the same
   index; invariants checked at the end. Launch counts are reset just
   before this phase and read just after it: every kernel must have run.

4. The heatmap path at the same scale, on the same dataset (phase 3's
   engine freed first): a fresh ``AQPEngine`` (default ``IndexConfig``:
   bin-aligned splits, session bin-grid memory) answers
   ``heatmap(w, "mean", "a0", bins=(8, 8))`` over the same windows at
   phi = 0.05 and then phi = 0, every bin checked against an on-device
   float64 oracle; 10 windows under an ``AccuracyPolicy`` with an
   absolute floor must meet every bin's budget; a repeated viewport must
   come down to zero objects read; a second engine replays 10 windows on
   the sequential path and must end with the same index. The three
   heatmap kernels must all have launched in this phase.

5. The serving tick at the same scale, on the same dataset (phase 4's
   engine freed first): B7's workload (``benchmarks/
   serving_concurrency.py``) — ``IndexConfig(grid0=(8, 8),
   min_split_count=512)``, 16 sessions x ``--ticks`` ticks around 8
   zipf-weighted hot spots, every 4th submission a 4x4 ``mean(a0)``
   heatmap, the rest ``mean(a0)`` queries, all at phi = 0.05 — served by
   ``AQPEngine.serve()`` in micro-batched ticks. Every answer must meet
   phi and every 5th contain its oracle; both multi-window kernels must
   have launched. Then 4 sessions x 3 ticks on fresh engines, batched
   against sequential, with and without a crack budget: the same index,
   publication and answers.

Phase 2b holds the heatmap kernels (``segment_bin_agg_edges``,
``segment_window_bin_agg``, ``segment_window_bin_select``) against their
plain versions — the select op's suffix widths bit for bit — on edge
cases (a table too large for shared memory, planes at different offsets
mod 16, 64 segments, an empty stream, two calls back to back, tables of
different sizes in turns, NaN values), a host sample against the numpy
mirrors, and at the heatmap path's shapes: 8 segments of ~3.9e5
objects, 8x8 bins, 4x4 split cells for the batched ops, and one tile of
~3.9e5 objects (1e8 / 256, the initial grid's mean tile) for
``segment_window_bin_agg``, which the path launches only from
``process_heatmap`` with S = 1. Then it times rows 1-10 on three clocks
— rows 1 (one window, and the all-covering window of the index's
enrichment), 2 and 3 at phase 2's shapes, 8, 9 and 10 at phase 5's
median scalar pass (10 segments of 34 190 objects, a window each; rows
9 and 10 with 4x4 bins, row 10 cut into ``HEATMAP_SPANS`` query spans),
4, 6 and 7 at the heatmap path's, 5 at B3's: (a) CUDA events around the
call, L2 flushed (the kernels line's ms), (b) the device time of the
call's kernels from ``torch.profiler``, (c) the wrapper's host
microseconds — and fails unless the profiler sees one kernel a call of
every one-launch row (two of row 5).
``--clocks-of TREE`` builds the port under ``TREE/src`` (a parent commit
unpacked there) and prints only those clocks, so that parent and change
can be timed in turns in one call. Phase 2c holds the
serving tick's kernels (``segment_window_agg_multi``,
``segment_window_bin_agg_multi``, ``segment_window_bin_select_multi``:
one window per segment, suffix widths per query span) against their
plain versions on edge cases (NaN values and empty query spans among
them) and a host sample, and times row 10 where its table of 16 384
cells folds into the global workspace; after phase 5 it checks and
times them at the median shapes of phase 5's passes. Phase 2d holds
``window_agg`` and ``window_count`` against their plain versions on edge
cases (n = 0, 1, 3 and 4097; an unaligned
view with n short of the planes; +-inf, empty and zero-area windows;
objects on the window's edges and their float32 neighbours; NaN
values), checks that views cut at
different offsets raise, holds a host sample against the numpy mirror,
and times ``window_agg`` on one 390 625-object tile and on B3's data
(n = 1e6, B3's window), the shape at which phase 6 launches it.

Right after the dataset is made, the paper-scale scan runs
``window_agg`` and ``window_count`` over the whole file (x, y, a0 on the
card) under B3's window and an all-covering one, each held against its
plain version and timed beside its byte bound.

6. The port's kernels bench (``repro_torch.benchmarks.kernels_bench``,
   B3) at its full size on the card, its rows printed; launch counts are
   reset before it, and ``window_agg`` must have launched in it.

7. Chunked storage on the card (run after phase 5; launch counts reset
   before 7a and read after 7c, where rows 1, 2, 4, 7, 8 and 10 must all
   have launched).
   7a: ``ChunkedDataset.from_dataset`` over phase 3's dataset (its planes,
   not a copy) against a fresh legacy engine, both "cuda", on the first
   10 windows as ``mean(a0)`` queries and 8x8 heatmaps at phi = 0.05:
   equal reads, read calls, rounds, tiles, tile table and permutation;
   float64 values within 1e-12. Phase 3's dataset is then freed.
   7b: B8's streaming session (``benchmarks/streaming_exploration.py``)
   at ``--chunk-rows`` rows a chunk: 30 x-slab chunks of (x, y, a0, a1)
   resident on the card, 3 live (the oldest retired), 2 windows over the
   recent slabs after each ingest, each a ``mean(a0)`` query and a 4x4
   ``sum(a0)`` heatmap at phi = 0.05. B8's gates: every answer contains
   its float64 oracle, no pruned chunk reads, a chunk's index is built on
   its first overlapping query and only while live; and after each
   query's ``prepare`` the device memory allocated since the phase began
   stays within the live chunks' planes and forests plus a fixed 64 MiB.
   The last ingest step runs under ``torch.profiler``, and the host
   seconds of a query's layers (``prepare``, the accumulator build, the
   rounds' reads and applies) are summed over the session.
   7c: the serving tick over 7b's live chunks on fresh engines, batched
   and sequential: 4 sessions x 3 ticks of a ``mean(a0)`` query and a 4x4
   heatmap each, windows across chunk edges (composite rounds), the
   oldest chunk's storage closed before the last tick (its reads degrade,
   ``retired_during_query``); both modes give the same answers, index
   and publication.

8. Prediction on the card (run after phase 5 and before 7a, on phase 3's
   dataset; launch counts reset before it: rows 1, 4 and 7 must launch
   in the phase, 8 and 10 in 8d).
   8a: B9's workload (``benchmarks/predictive_exploration.py``) at the
   paper's scale: its linear pan and random walk (0.3 x domain windows),
   ``--pan-steps`` steps each (B9's full size is 50; cut to 24 by
   default for time), a reactive and a predicted arm on fresh "cuda"
   engines with B9's ``IndexConfig``, 4x4 ``mean(a0)`` heatmaps at
   phi = 0.05 and a budget of 3e6 rows a step (B9's 120 000 at 4e6 rows,
   3 % of the file). Gates: no prefetch reads past its budget or adds a
   speculative row, every answer meets phi, every 4th contains its
   float64 oracle, and on the linear pan the predicted arm's sources
   after warm-up are "linear" with ``hit_linear`` 1.0. The p99
   comparison of query-time reads is printed, not gated, as are the
   predictor's host microseconds: in the arms, and a fresh predictor's
   alone with the card idle before each call.
   8b: 8 linear-pan windows at phi = 0 (mean, count, min, max), a
   prefetching engine against a reactive one: counts and extrema equal,
   means within 1e-12 relative, both equal to the oracle.
   8c: 8 heatmaps under ``AccuracyPolicy(salience="learned")`` with
   phase 4's absolute floor: every bin meets its budget, no speculative
   rows, the resolved map equals the dwell histogram recomputed here.
   8d: 4 sessions x 3 ticks panning (a query and a 4x4 heatmap in turns)
   with ``crack_budget=6`` and ``prefetch_rows=3e6`` on fresh engines,
   batched against sequential: the same answers, prefetch records,
   publication and index; some prefetch reads rows.

Phases 3 to 5, 7 and 8 run with every plain ``*_torch`` kernel version
wrapped in a counter: the card's path must call none of them.

The line before the last is a JSON object describing each kernel (with
its launches in phase 8 as ``launches_phase8``); the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3
PEAK_F32_S = 67e12          # H100 SXM float32, outside the tensor cores
PEAK_F64_S = 34e12          # H100 SXM float64, outside the tensor cores
SUM_RTOL = 1e-12            # |sum - plain| <= SUM_RTOL * sum|v| per cell


class Failed(Exception):
    pass


def log(*a):
    print(*a, flush=True)


# --------------------------------------------------------------------- #
# comparison and timing helpers
# --------------------------------------------------------------------- #

def compare(what, got, want, abs_sum):
    """Counts and extrema equal (``==``, so +-0 agree), float64 sums
    within ``SUM_RTOL * sum|v|``; an extremum or a sum that is NaN on
    both sides counts as equal (a NaN value's cell), and a NaN anywhere
    else differs. Returns the largest absolute difference over all
    channels (equal infinities and NaN pairs count 0)."""
    g = np.asarray(got, np.float64).reshape(-1, 4)
    w = np.asarray(want, np.float64).reshape(-1, 4)
    a = np.asarray(abs_sum, np.float64).reshape(-1)
    if g.shape != w.shape:
        raise Failed(f"{what}: shape {g.shape} != {w.shape}")
    if not np.array_equal(g[:, 0], w[:, 0]):
        raise Failed(f"{what}: counts differ")
    both = np.isnan(g) & np.isnan(w)
    both[:, 0] = False
    if not ((g[:, 2:] == w[:, 2:]) | both[:, 2:]).all():
        raise Failed(f"{what}: extrema differ")
    with np.errstate(invalid="ignore"):
        d = np.abs(g[:, 1] - w[:, 1])
        if not ((d <= SUM_RTOL * a) | both[:, 1]).all():
            raise Failed(f"{what}: sums differ by {np.nanmax(d)} (tol "
                         f"{SUM_RTOL} * sum|v|)")
        diff = np.where((g == w) | both, 0.0, np.abs(g - w))
    return float(diff.max(initial=0.0))


def make_timer(torch, reps):
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def timed(fn):
        """Median ms of ``fn`` from CUDA events, L2 flushed before each
        repetition (the main path meets freshly gathered data)."""
        for _ in range(3):
            fn()
        out = []
        for _ in range(reps):
            flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            out.append(s.elapsed_time(e))
        return float(np.median(out))
    return timed


def bound_ms(nbytes, f32_ops, f64_ops):
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = f32_ops / PEAK_F32_S + f64_ops / PEAK_F64_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# --------------------------------------------------------------------- #
# phase 1
# --------------------------------------------------------------------- #

def card_line():
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def phase_card_and_build(torch, build):
    smi = card_line()
    log("== phase 1: card and build")
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    report = build.build_all()
    log(f"built {sorted(report)} in {time.perf_counter() - t0:.3f} s")
    for name, r in sorted(report.items()):
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


# --------------------------------------------------------------------- #
# phase 2
# --------------------------------------------------------------------- #

def segments(torch, gen, n_seg, rows, lo=0.0, hi=1000.0):
    """Concatenated segments of ~``rows`` objects each, segment s living
    in its own random bbox; values straddle zero."""
    counts = np.full(n_seg, rows, np.int64)
    b = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    n = int(b[-1])
    bboxes = np.empty((n_seg, 4))
    xs = torch.empty(n, device="cuda")
    ys = torch.empty(n, device="cuda")
    rng = np.random.default_rng(int(torch.randint(
        0, 2**31, (1,), generator=gen, device="cuda")))
    for s in range(n_seg):
        x0, y0 = rng.uniform(lo, hi * 0.7, 2)
        w, h = rng.uniform(hi * 0.05, hi * 0.3, 2)
        bboxes[s] = (x0, y0, x0 + w, y0 + h)
        sl = slice(b[s], b[s + 1])
        xs[sl] = torch.rand(rows, generator=gen, device="cuda") * w + x0
        ys[sl] = torch.rand(rows, generator=gen, device="cuda") * h + y0
    vals = torch.randn(n, generator=gen, device="cuda") * 30 + 5
    return xs, ys, vals, b, bboxes


def edge_cases(torch, gen):
    """Small inputs at the rules' edges: empty segments, empty and
    all-covering windows, points on split lines and on the float32
    neighbours of window edges, negative values, NaN values, planes at
    different offsets mod 16."""
    xs, ys, vals, b, bb = segments(torch, gen, 8, 3000)
    cases = []
    # x, y and v as views 0, 1 and 2 floats into their buffers: the
    # kernels' scalar walks (and, under the all-covering window, v's
    # scalar head before its float4 body)
    L = int(b[-1])
    ax, ay, av = (torch.cat([p[:s], p, p[:3]])[s:s + L]
                  for p, s in zip((xs, ys, vals), (0, 1, 2)))
    cases.append(("planes_apart", ax, ay, av, b, bb,
                  (100.0, 100.0, 600.0, 600.0)))
    cases.append(("planes_apart_everywhere", ax, ay, av, b, bb,
                  (-np.inf, -np.inf, np.inf, np.inf)))
    # empty segments between and at the ends
    b_empty = np.array([0, 0, 3000, 3000, 9000, 12000, 12000, 24000, 24000])
    cases.append(("empty_segments", xs, ys, vals, b_empty, bb,
                  (100.0, 100.0, 600.0, 600.0)))
    cases.append(("empty_window", xs, ys, vals, b, bb,
                  (-5.0, -5.0, -1.0, -1.0)))
    cases.append(("everywhere", xs, ys, vals, b, bb,
                  (-np.inf, -np.inf, np.inf, np.inf)))
    # points exactly on each segment's split lines and window edges and
    # on their float32 neighbours; all-negative values
    edge_x, edge_y = [], []
    for s in range(8):
        x0, y0, x1, y1 = bb[s]
        mx, my = 0.5 * (x0 + x1), 0.5 * (y0 + y1)
        for vx in (x0, mx, x1, np.float32(mx), np.nextafter(
                np.float32(mx), np.float32(np.inf))):
            for vy in (y0, my, y1, np.nextafter(np.float32(my),
                                                np.float32(-np.inf))):
                edge_x.append(vx)
                edge_y.append(vy)
    per = len(edge_x) // 8
    ex = torch.tensor(np.asarray(edge_x, np.float32), device="cuda")
    ey = torch.tensor(np.asarray(edge_y, np.float32), device="cuda")
    ev = -torch.rand(len(edge_x), generator=gen, device="cuda") - 1.0
    eb = np.arange(0, 8 * per + 1, per, dtype=np.int64)
    w = tuple(float(v) for v in (bb[0, 0], bb[0, 1], 0.5 * (bb[0, 0] + bb[
        0, 2]), 0.5 * (bb[0, 1] + bb[0, 3])))
    cases.append(("split_lines_and_edges", ex, ey, ev, eb, bb, w))
    # NaN values: on the first in-window object of every segment, on the
    # 8th object of every segment, and on all of segment 3; under a
    # window, the all-covering window, and as the index's enrichment
    # passes them (the value plane as x, y and v: NaN coordinates too)
    win = (100.0, 100.0, 600.0, 600.0)
    inside = ((xs >= win[0]) & (xs <= win[2]) & (ys >= win[1])
              & (ys <= win[3])).cpu().numpy()
    vn = vals.clone()
    for s in range(8):
        hit = np.flatnonzero(inside[b[s]:b[s + 1]])
        if len(hit):
            vn[int(b[s] + hit[0])] = float("nan")
        vn[int(b[s]) + 7] = float("nan")
    vn[int(b[3]):int(b[4])] = float("nan")
    cases.append(("nan_values", xs, ys, vn, b, bb, win))
    cases.append(("nan_everywhere", xs, ys, vn, b, bb,
                  (-np.inf, -np.inf, np.inf, np.inf)))
    cases.append(("nan_enrichment", vn, vn, vn, b, bb,
                  (-np.inf, -np.inf, np.inf, np.inf)))
    return cases


def phase_kernels(torch, timed, seed):
    """Rows 1-3 against their plain versions (row 1 also under the
    all-covering window, its enrichment entry); their largest differences
    at the main path's shapes (the enrichment entry's also over the
    stress shape)."""
    from repro_torch.kernels import bin_agg as ba
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_agg as sa

    log("== phase 2: kernels against their plain versions")
    everywhere = (-np.inf, -np.inf, np.inf, np.inf)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def check_swa(tag, xs, ys, vals, b, window):
        got = sa.segment_window_agg_cuda(xs, ys, vals, b, window)
        want = sa.segment_window_agg_torch(xs, ys, vals, b, window)
        absv = sa.segment_window_agg_torch(xs, ys, vals.abs(), b, window)
        torch.cuda.synchronize()
        return compare(f"segment_window_agg[{tag}]", got.cpu(), want.cpu(),
                       absv[:, 1].cpu())

    def check_sba(tag, xs, ys, vals, b, bb, g):
        got = sa.segment_bin_agg_cuda(xs, ys, vals, b, bb, g, g)
        want = sa.segment_bin_agg_torch(xs, ys, vals, b, bb, g, g)
        absv = sa.segment_bin_agg_torch(xs, ys, vals.abs(), b, bb, g, g)
        torch.cuda.synchronize()
        return compare(f"segment_bin_agg[{tag}]", got.cpu(), want.cpu(),
                       absv[..., 1].cpu())

    def check_ba(tag, xs, ys, vals, bbox, g):
        got = ba.bin_agg_cuda(xs, ys, vals, bbox, g, g)
        want = ba.bin_agg_torch(xs, ys, vals, bbox, g, g)
        absv = ba.bin_agg_torch(xs, ys, vals.abs(), bbox, g, g)
        torch.cuda.synchronize()
        return compare(f"bin_agg[{tag}]", got.cpu(), want.cpu(),
                       absv[:, 1].cpu())

    # --- edge cases, S = 1 / 8 / 64, grids 2x2 and 4x4
    for name, xs, ys, vals, b, bb, window in edge_cases(torch, gen):
        check_swa(name, xs, ys, vals, b, window)
        for g in (2, 4):
            check_sba(f"{name},{g}x{g}", xs, ys, vals, b, bb, g)
            n0 = int(b[1] - b[0]) or int(b[2] - b[1])
            check_ba(f"{name},{g}x{g}", xs[:n0], ys[:n0], vals[:n0], bb[0],
                     g)
    xs, ys, vals, b, bb = segments(torch, gen, 64, 500)
    check_swa("S=64", xs, ys, vals, b, (200.0, 200.0, 700.0, 700.0))
    check_sba("S=64,4x4", xs, ys, vals, b, bb, 4)
    b1 = b[[0, -1]]
    check_swa("S=1", xs, ys, vals, b1, (200.0, 200.0, 700.0, 700.0))
    log("edge cases: equal")

    # --- the main path's shapes: 8 segments of ~3.9e5 objects, 2x2
    seg_rows = 390_625
    xs, ys, vals, b, bb = segments(torch, gen, 8, seg_rows)
    cx, cy = 0.5 * (bb[:, 0] + bb[:, 2]).mean(), 0.5 * (bb[:, 1] +
                                                        bb[:, 3]).mean()
    window = (float(cx - 150), float(cy - 150), float(cx + 150),
              float(cy + 150))
    err_swa = check_swa("main", xs, ys, vals, b, window)
    # the all-covering entry as the index's enrichment calls it: the value
    # plane as x, y and v
    err_swe = check_swa("main,everywhere", vals, vals, vals, b, everywhere)
    err_sba = check_sba("main", xs, ys, vals, b, bb, 2)
    xs1, ys1, vals1 = xs[:seg_rows], ys[:seg_rows], vals[:seg_rows]
    err_ba = check_ba("main", xs1, ys1, vals1, bb[0], 2)

    # a host sample against the float64 numpy mirrors
    m = 50_000
    hb = np.array([0, m, 2 * m], np.int64)
    sx = torch.cat([xs[:m], xs[b[1]:b[1] + m]])
    sy = torch.cat([ys[:m], ys[b[1]:b[1] + m]])
    sv = torch.cat([vals[:m], vals[b[1]:b[1] + m]])
    hx, hy, hv = (t.cpu().numpy() for t in (sx, sy, sv))
    habs = np.abs(hv)
    compare("segment_window_agg[np mirror]",
            sa.segment_window_agg_cuda(sx, sy, sv, hb, window).cpu(),
            ref.segment_window_agg_np(hx, hy, hv, hb, window),
            ref.segment_window_agg_np(hx, hy, habs, hb, window)[:, 1])
    compare("segment_bin_agg[np mirror]",
            sa.segment_bin_agg_cuda(sx, sy, sv, hb, bb[:2], 2, 2).cpu(),
            ref.segment_bin_agg_np(hx, hy, hv, hb, bb[:2], 2, 2),
            ref.segment_bin_agg_np(hx, hy, habs, hb, bb[:2], 2, 2)[..., 1])
    # the bin_agg mirror rounds its sums to float32: counts and extrema
    # equal, sums within float32 rounding of sum|v|
    got = ba.bin_agg_cuda(sx[:m], sy[:m], sv[:m], bb[0], 2, 2).cpu().numpy()
    want = ref.bin_agg_np(hx[:m], hy[:m], hv[:m], bb[0], 2, 2, m)
    wabs = ref.bin_agg_np(hx[:m], hy[:m], habs[:m], bb[0], 2, 2, m)
    if not (np.array_equal(got[:, 0], want[:, 0])
            and (got[:, 2:] == want[:, 2:]).all()
            and (np.abs(got[:, 1] - want[:, 1])
                 <= 2.0 ** -22 * wabs[:, 1]).all()):
        raise Failed("bin_agg disagrees with the numpy mirror")
    log("host sample against the numpy mirrors: equal")

    # --- stress: 64 segments, 1.6e7 objects, 4x4; the all-covering entry
    # over a 64-segment run as the enrichment meets it at init (several
    # passes of a resident block's loop), also with NaN values strewn
    sx, sy, sv, sbnd, sbb = segments(torch, gen, 64, 250_000)
    check_swa("stress", sx, sy, sv, sbnd, (100.0, 100.0, 800.0, 800.0))
    err_swe = max(err_swe, check_swa("stress,everywhere", sv, sv, sv, sbnd,
                                     everywhere))
    sn = sv.clone()
    sn[::1_000_003] = float("nan")
    sn[int(sbnd[40]):int(sbnd[41])] = float("nan")
    err_swe = max(err_swe, check_swa("stress,nan_everywhere", sn, sn, sn,
                                     sbnd, everywhere))
    del sn
    check_sba("stress,4x4", sx, sy, sv, sbnd, sbb, 4)
    t_s = timed(lambda: sa.segment_bin_agg_cuda(sx, sy, sv, sbnd, sbb, 4, 4))
    t_p = timed(lambda: sa.segment_bin_agg_torch(sx, sy, sv, sbnd, sbb,
                                                 4, 4))
    log(f"stress segment_bin_agg (64 x 250000, 4x4): kernel {t_s:.4f} ms, "
        f"plain {t_p:.4f} ms, bound "
        f"{bound_ms(12 * int(sbnd[-1]), 0, 5 * int(sbnd[-1]))[0]:.4f} ms")
    del sx, sy, sv

    return {"segment_window_agg": err_swa,
            "segment_window_agg_everywhere": err_swe,
            "segment_bin_agg": err_sba, "bin_agg": err_ba}


# --------------------------------------------------------------------- #
# phase 2, the heatmap kernels
# --------------------------------------------------------------------- #

def on_lines(torch, xs, ys, lines, lo, hi, rng, k):
    """Move ``k`` objects onto float64 ``lines`` (their float32 rounding
    and both float32 neighbours), spread over ``[lo, hi)`` on the other
    axis; returns new device planes."""
    hx, hy = xs.cpu().numpy().copy(), ys.cpu().numpy().copy()
    idx = rng.choice(len(hx), size=min(k, len(hx)), replace=False)
    line = np.asarray(lines, np.float64)[rng.integers(0, len(lines), len(idx))]
    l32 = line.astype(np.float32)
    step = np.arange(len(idx)) % 3 - 1
    hx[idx] = np.where(step < 0, np.nextafter(l32, np.float32(-np.inf)),
                       np.where(step > 0, np.nextafter(l32, np.float32(
                           np.inf)), l32))
    hy[idx] = rng.uniform(lo, hi, len(idx)).astype(np.float32)
    return (torch.from_numpy(hx).to("cuda"), torch.from_numpy(hy).to("cuda"))


def split_edges(bboxes, g):
    """Per-segment even split edges of ``g`` cells per axis (float64)."""
    t = np.linspace(0.0, 1.0, g + 1)
    xe = bboxes[:, :1] + (bboxes[:, 2:3] - bboxes[:, :1]) * t
    ye = bboxes[:, 1:2] + (bboxes[:, 3:4] - bboxes[:, 1:2]) * t
    return xe, ye


def phase_heatmap_kernels(torch, hs, seed):
    """Rows 4, 6 and 7 against their plain versions; their largest
    differences at the heatmap path's shapes (``hs``: kernel_shapes)."""
    from repro_torch.kernels import fused_select as fs
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_agg as sa

    log("== phase 2b: heatmap kernels against their plain versions")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 1)
    rng = np.random.default_rng(seed + 1)

    def check_edges(tag, xs, ys, vals, b, xe, ye):
        got = sa.segment_bin_agg_edges_cuda(xs, ys, vals, b, xe, ye)
        want = sa.segment_bin_agg_edges_torch(xs, ys, vals, b, xe, ye)
        absv = sa.segment_bin_agg_edges_torch(xs, ys, vals.abs(), b, xe, ye)
        torch.cuda.synchronize()
        return compare(f"segment_bin_agg_edges[{tag}]", got.cpu(),
                       want.cpu(), absv[..., 1].cpu())

    def check_wbin(tag, xs, ys, vals, b, w, bins):
        got = sa.segment_window_bin_agg_cuda(xs, ys, vals, b, w, *bins)
        want = sa.segment_window_bin_agg_torch(xs, ys, vals, b, w, *bins)
        absv = sa.segment_window_bin_agg_torch(xs, ys, vals.abs(), b, w,
                                               *bins)
        torch.cuda.synchronize()
        return compare(f"segment_window_bin_agg[{tag}]", got.cpu(),
                       want.cpu(), absv[..., 1].cpu())

    def check_select(tag, xs, ys, vals, b, w, bins):
        n_seg = len(b) - 1
        vmin = rng.uniform(-120.0, 0.0, n_seg)
        vmax = vmin + rng.uniform(0.0, 240.0, n_seg)
        got, got_w = fs.segment_window_bin_select_cuda(xs, ys, vals, b, w,
                                                       *bins, vmin, vmax)
        want, want_w = fs.segment_window_bin_select_torch(
            xs, ys, vals, b, w, *bins, vmin, vmax)
        absv, _ = fs.segment_window_bin_select_torch(
            xs, ys, vals.abs(), b, w, *bins, vmin, vmax)
        torch.cuda.synchronize()
        if not torch.equal(got_w, want_w):
            raise Failed(f"segment_window_bin_select[{tag}]: suffix_w "
                         "differs from the plain version")
        if not (got_w[-1] == 0).all():
            raise Failed(f"segment_window_bin_select[{tag}]: last suffix "
                         "row is not 0")
        return compare(f"segment_window_bin_select[{tag}]", got.cpu(),
                       want.cpu(), absv[..., 1].cpu())

    def check_all(tag, xs, ys, vals, b, bb, w, bins, g=4):
        xe, ye = split_edges(bb, g)
        check_edges(tag, xs, ys, vals, b, xe, ye)
        check_wbin(tag, xs, ys, vals, b, w, bins)
        check_select(tag, xs, ys, vals, b, w, bins)

    # --- edge cases: S = 1 / 8 / 32, empty segments, objects on split
    # edges, on bin lines and on window edges (and their float32
    # neighbours), a zero-area window, negative values, >2048 cells
    xs, ys, vals, b, bb = segments(torch, gen, 8, 3000)
    cx, cy = 0.5 * (bb[:, 0] + bb[:, 2]).mean(), 0.5 * (bb[:, 1] +
                                                        bb[:, 3]).mean()
    w = (float(cx - 200.3), float(cy - 180.7), float(cx + 190.1),
         float(cy + 210.9))
    bins = (8, 8)
    cw = (w[2] - w[0]) / bins[0]
    xs, ys = on_lines(torch, xs, ys, w[0] + cw * np.arange(bins[0] + 1),
                      w[1], w[3], rng, 4000)
    check_all("bin_lines", xs, ys, vals, b, bb, w, bins)
    xe, ye = split_edges(bb, 4)
    ex, ey = on_lines(torch, xs, ys, xe[:, 1:-1].ravel(), bb[:, 1].min(),
                      bb[:, 3].max(), rng, 4000)
    check_edges("split_edges", ex, ey, vals, b, xe, ye)
    b_empty = np.array([0, 0, 3000, 3000, 9000, 12000, 12000, 24000, 24000])
    check_all("empty_segments", xs, ys, vals, b_empty, bb, w, bins)
    point = (float(np.float32(cx)), float(np.float32(cy)))
    px, py = xs.clone(), ys.clone()
    px[::7] = point[0]
    py[::7] = point[1]
    zero = (point[0], point[1], point[0], point[1])
    check_wbin("zero_area", px, py, vals, b, zero, bins)
    check_select("zero_area", px, py, vals, b, zero, bins)
    check_all("negative", xs, ys, -vals.abs() - 1.0, b, bb, w, bins)
    # NaN values on the first in-window object and the 6th object of
    # every segment, and on all of segment 2
    inside = ((xs >= w[0]) & (xs <= w[2]) & (ys >= w[1])
              & (ys <= w[3])).cpu().numpy()
    vn = vals.clone()
    for s in range(8):
        hit = np.flatnonzero(inside[b[s]:b[s + 1]])
        if len(hit):
            vn[int(b[s] + hit[0])] = float("nan")
        vn[int(b[s]) + 5] = float("nan")
    vn[int(b[2]):int(b[3])] = float("nan")
    check_all("nan_values", xs, ys, vn, b, bb, w, bins)
    check_all("S=1", xs, ys, vals, b[[0, -1]], bb[:1], w, bins)
    xs, ys, vals, b, bb = segments(torch, gen, 32, 2000)
    w32 = (200.0, 200.0, 700.0, 700.0)
    check_all("S=32", xs, ys, vals, b, bb, w32, bins)
    # 32 segments x 16x16 bins = 8192 cells: past the shared table
    check_wbin("S=32,16x16", xs, ys, vals, b, w32, (16, 16))
    check_select("S=32,16x16", xs, ys, vals, b, w32, (16, 16))
    log("heatmap edge cases: equal (suffix_w bit for bit)")

    # --- edge cases of the one-launch design: planes at different offsets
    # mod 16 (the scalar walk), 64 segments, an empty stream, edges past
    # the small parameter block and a split table past the shared one, two
    # calls back to back and tables of different sizes interleaved (the
    # workspace must come back to its identity state after every call)
    xs, ys, vals, b, bb = segments(torch, gen, 8, 3000)
    L = int(b[-1])
    px = torch.cat([xs, xs[:3]])
    py = torch.cat([ys[:1], ys, ys[:2]])
    pv = torch.cat([vals[:2], vals, vals[:1]])
    ox, oy, ov = px[:L], py[1:L + 1], pv[2:L + 2]
    check_all("offsets", ox, oy, ov, b, bb, w, bins)
    # all three planes 4 bytes past a 16-byte boundary: a scalar head of 3
    # objects, the float4 body, a scalar tail of 1
    check_all("shifted", px[1:L + 1], py[1:L + 1], pv[1:L + 1], b, bb, w,
              bins)
    check_all("empty_stream", xs, ys, vals, np.zeros(9, np.int64), bb, w,
              bins)
    for _ in range(2):
        check_all("back_to_back", xs, ys, vals, b, bb, w, bins)
    for tag, bn in (("interleave,8x8", bins), ("interleave,2x2", (2, 2)),
                    ("interleave,8x8", bins), ("interleave,1x1", (1, 1))):
        check_all(tag, xs, ys, vals, b, bb, w, bn, g=bn[0])
    xs, ys, vals, b, bb = segments(torch, gen, 64, 500)
    check_all("S=64", xs, ys, vals, b, bb, w32, bins)
    # 64 x 7 + 64 x 7 = 896 interior edges, 64 x 64 = 4096 split cells
    check_edges("S=64,8x8", xs, ys, vals, b, *split_edges(bb, 8))
    log("one-launch edge cases: equal")

    # --- the heatmap path's shapes (timed on three clocks afterwards)
    xs, ys, vals, b, xe, ye, window = (hs[k] for k in (
        "xs", "ys", "vals", "b", "xe", "ye", "window"))
    vmin, vmax = hs["vmin"], hs["vmax"]
    err_e = check_edges("main", xs, ys, vals, b, xe, ye)
    check_wbin("main", xs, ys, vals, b, window, bins)
    err_s = check_select("main", xs, ys, vals, b, window, bins)
    err_w = check_wbin("tile", hs["xs1"], hs["ys1"], hs["vals1"], hs["b1"],
                       hs["window1"], bins)

    # a host sample against the float64 numpy mirrors
    m = 50_000
    hb = np.array([0, m, 2 * m], np.int64)
    sx = torch.cat([xs[:m], xs[b[1]:b[1] + m]])
    sy = torch.cat([ys[:m], ys[b[1]:b[1] + m]])
    sv = torch.cat([vals[:m], vals[b[1]:b[1] + m]])
    hx, hy, hv = (t.cpu().numpy() for t in (sx, sy, sv))
    habs = np.abs(hv)
    compare("segment_bin_agg_edges[np mirror]",
            sa.segment_bin_agg_edges_cuda(sx, sy, sv, hb, xe[:2],
                                          ye[:2]).cpu(),
            ref.segment_bin_agg_edges_np(hx, hy, hv, hb, xe[:2], ye[:2]),
            ref.segment_bin_agg_edges_np(hx, hy, habs, hb, xe[:2],
                                         ye[:2])[..., 1])
    compare("segment_window_bin_agg[np mirror]",
            sa.segment_window_bin_agg_cuda(sx, sy, sv, hb, window,
                                           *bins).cpu(),
            ref.segment_window_bin_agg_np(hx, hy, hv, hb, window, *bins),
            ref.segment_window_bin_agg_np(hx, hy, habs, hb, window,
                                          *bins)[..., 1])
    got, got_w = fs.segment_window_bin_select_cuda(sx, sy, sv, hb, window,
                                                   *bins, vmin[:2],
                                                   vmax[:2])
    want, want_w = fs.segment_window_bin_select_np(hx, hy, hv, hb, window,
                                                   *bins, vmin[:2],
                                                   vmax[:2])
    compare("segment_window_bin_select[np mirror]", got.cpu(), want,
            ref.segment_window_bin_agg_np(hx, hy, habs, hb, window,
                                          *bins)[..., 1])
    if not np.array_equal(got_w.cpu().numpy(), want_w):
        raise Failed("segment_window_bin_select: suffix_w differs from the "
                     "numpy mirror")
    log("heatmap host sample against the numpy mirrors: equal")

    return {"segment_bin_agg_edges": err_e, "segment_window_bin_agg": err_w,
            "segment_window_bin_select": err_s}


def kernel_shapes(torch, seed):
    """The main path's shapes, made alike for any tree being measured:
    8 segments of 390 625 objects (1e8 / 256, the initial grid's mean
    tile) with a 300 x 300 window, 2x2 split cells (rows 1 and 2, and
    the enrichment: row 1 under the all-covering window with the value
    plane as x, y and v), 8x8 bins and 4x4 split cells (the batched
    rounds of rows 4 and 7); one such tile (row 3's split; row 6's S = 1
    launch under a window crossing it); phase 5's median scalar pass at
    10^8 rows, 10 segments of 34 190 objects each under its own window
    (row 8; with 4x4 bins, rows 9 and 10); and B3's data under B3's
    window (row 5, whose two launches a call no redesign has touched
    yet)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 5)
    seg_rows = 390_625
    xs, ys, vals, b, bb = segments(torch, gen, 8, seg_rows)
    cx, cy = 0.5 * (bb[:, 0] + bb[:, 2]).mean(), 0.5 * (bb[:, 1] +
                                                        bb[:, 3]).mean()
    xe, ye = split_edges(bb, 4)
    x0, y0, x1, y1 = bb[0]
    mx, my, mv, mb, mwins = multi_case(
        torch, np.random.default_rng(seed + 6), 10, 34_190, (4, 4),
        zero_area=False)
    from repro_torch.benchmarks import kernels_bench
    wa = [torch.from_numpy(a).to("cuda")
          for a in kernels_bench.data(1_000_000)]
    return {"xs": xs, "ys": ys, "vals": vals, "b": b, "bb": bb,
            "xe": xe, "ye": ye, "bins": (8, 8),
            "window": (float(cx - 150), float(cy - 150), float(cx + 150),
                       float(cy + 150)),
            "vmin": np.full(8, -150.0), "vmax": np.full(8, 160.0),
            "xs1": xs[:seg_rows], "ys1": ys[:seg_rows],
            "vals1": vals[:seg_rows], "b1": np.array([0, seg_rows], np.int64),
            "window1": (float(x0 + 0.2 * (x1 - x0)),
                        float(y0 + 0.2 * (y1 - y0)),
                        float(x0 + 0.7 * (x1 - x0)),
                        float(y0 + 0.7 * (y1 - y0))),
            "multi": (mx, my, mv, mb, mwins),
            "wa": (*wa, kernels_bench.WINDOW)}


def device_clock(torch, fn, flush, reps):
    """Clock (b): the device time of one call, the sum of the durations of
    the kernels ``torch.profiler`` records over ``reps`` calls (L2 flushed
    before each; the flush's own kernel left out), over ``reps``; with the
    kernels launched per call and their names."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace that lost events is taken again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        ks = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and "at::" not in e.name
              and not e.name.lower().startswith(("memset", "memcpy"))]
        if ks and len(ks) % reps == 0:
            break
    return (sum(e.time_range.elapsed_us() for e in ks) * 1e-3 / reps,
            len(ks) / reps, sorted({e.name.split("(")[0] for e in ks}))


def host_clock(torch, fn, reps):
    """Clock (c): the wrapper's host time of one call, microseconds, the
    least over ``reps`` calls timed without a synchronise."""
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t)
    torch.cuda.synchronize()
    return best * 1e6


def row_clocks(torch, timed, hs, enforce):
    """Rows 1-10 at the main path's shapes (:func:`kernel_shapes`; row 1
    also under the all-covering window, as the index's enrichment calls
    it) on three clocks: (a) CUDA events around the call, L2 flushed,
    median (the table's ms); (b) the device time of its kernels from
    ``torch.profiler``; (c) the wrapper's host microseconds. Also the
    kernels a call launches, which must be 1 (``enforce``; 2 for row 5).
    Rows 9 and 10 take the multi planes with 4x4 bins, the widths of
    phase 2c's timings and ``HEATMAP_SPANS`` even query spans.
    Takes only the op wrappers every tree of the port has, so it
    measures a parent tree as well (``--clocks-of``). Each row carries
    its plain version for the kernels line, except the rows in
    ``LINE_ELSEWHERE``, whose entries phases 2c and 2d write."""
    from repro_torch.kernels import bin_agg as ba
    from repro_torch.kernels import fused_select as fs
    from repro_torch.kernels import segment_agg as sa
    from repro_torch.kernels import window_agg as wa

    xs, ys, vals, b, bb, xe, ye, window, bins = (hs[k] for k in (
        "xs", "ys", "vals", "b", "bb", "xe", "ye", "window", "bins"))
    xs1, ys1, vals1, b1, window1 = (hs[k] for k in (
        "xs1", "ys1", "vals1", "b1", "window1"))
    mx, my, mv, mb, mwins = hs["multi"]
    vmin, vmax = hs["vmin"], hs["vmax"]
    everywhere = (-np.inf, -np.inf, np.inf, np.inf)
    L, L1, Lm = int(b[-1]), int(b1[-1]), int(mb[-1])
    n_seg, nb, ms = len(b) - 1, bins[0] * bins[1], len(mb) - 1
    n_in = int(sa.window_bin_ids(xs, ys, window, *bins)[0].sum())
    n_in1 = int(sa.window_bin_ids(xs1, ys1, window1, *bins)[0].sum())
    wm = torch.from_numpy(sa.windows_f32(mwins, ms)).to("cuda")[
        sa.segment_ids(mb, "cuda")]
    n_inm = int(((mx >= wm[:, 0]) & (mx <= wm[:, 2]) & (my >= wm[:, 1])
                 & (my <= wm[:, 3])).sum())
    nbm = 16
    qbm = even_spans(ms, HEATMAP_SPANS)
    vminm, vmaxm = np.full(ms, -150.0), np.full(ms, 160.0)
    ax, ay, av, aw = hs["wa"]
    La = len(ax)
    n_ina = int(wa.window_agg_torch(ax, ay, None, aw)[0].item())
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    src = "src/repro_torch/kernels/csrc/"
    specs = {
        "segment_window_agg": (
            lambda: sa.segment_window_agg_cuda(xs, ys, vals, b, window),
            lambda: sa.segment_window_agg_torch(xs, ys, vals, b, window),
            # x, y read; v for in-window objects; 4 compares per object,
            # the f64 sum and min/max per in-window object
            bound_ms(8 * L + 4 * n_in + 32 * n_seg, 4 * L + 2 * n_in, n_in),
            src + "segment_window_agg.cu",
            "src/repro/kernels/segment_agg.py:154"),
        "segment_window_agg_everywhere": (
            lambda: sa.segment_window_agg_cuda(vals, vals, vals, b,
                                               everywhere),
            lambda: sa.segment_window_agg_torch(vals, vals, vals, b,
                                                everywhere),
            # v alone read; the f64 sum and min/max per object
            bound_ms(4 * L + 32 * n_seg, 2 * L, L),
            src + "segment_window_agg.cu",
            "src/repro/kernels/segment_agg.py:154"),
        "segment_bin_agg": (
            lambda: sa.segment_bin_agg_cuda(xs, ys, vals, b, bb, 2, 2),
            lambda: sa.segment_bin_agg_torch(xs, ys, vals, b, bb, 2, 2),
            # x, y, v read; 2 f64 subtracts, 2 f64 divides and the f64
            # sum per object, f32 min/max
            bound_ms(12 * L + 32 * n_seg * 4, 2 * L, 5 * L),
            src + "segment_bin_agg.cu",
            "src/repro/kernels/segment_agg.py:524"),
        "bin_agg": (
            lambda: ba.bin_agg_cuda(xs1, ys1, vals1, bb[0], 2, 2),
            lambda: ba.bin_agg_torch(xs1, ys1, vals1, bb[0], 2, 2),
            bound_ms(12 * L1 + 32 * 4, 2 * L1, 5 * L1),
            src + "segment_bin_agg.cu", "src/repro/kernels/bin_agg.py:89"),
        "segment_window_agg_multi": (
            lambda: sa.segment_window_agg_multi_cuda(mx, my, mv, mb, mwins),
            None,
            bound_ms(8 * Lm + 4 * n_inm + 32 * ms, 4 * Lm + 2 * n_inm,
                     n_inm),
            src + "segment_window_agg.cu",
            "src/repro/kernels/segment_agg.py:219"),
        # rows 9 and 10: the bound of time_serving_kernels
        "segment_window_bin_agg_multi": (
            lambda: sa.segment_window_bin_agg_multi_cuda(mx, my, mv, mb,
                                                         mwins, 4, 4),
            None,
            bound_ms(8 * Lm + 4 * n_inm + 32 * ms * nbm, 4 * Lm + 6 * n_inm,
                     n_inm),
            src + "segment_window_bin_agg.cu",
            "src/repro/kernels/segment_agg.py:372"),
        "segment_window_bin_select_multi": (
            lambda: fs.segment_window_bin_select_multi_cuda(
                mx, my, mv, mb, mwins, 4, 4, vminm, vmaxm, qbm),
            None,
            bound_ms(8 * Lm + 4 * n_inm + 40 * ms * nbm, 4 * Lm + 6 * n_inm,
                     n_inm + 2 * ms * nbm),
            src + "segment_window_bin_agg.cu",
            "src/repro/kernels/fused_select.py:498"),
        "window_agg": (
            lambda: wa.window_agg_cuda(ax, ay, av, aw),
            None,
            # x and y read once, v of the in-window objects, the f64 row
            # out; 4 compares per object, the f64 sum and 2 extrema per
            # in-window object
            bound_ms(8 * La + 4 * n_ina + 32, 4 * La + 2 * n_ina, n_ina),
            src + "window_agg.cu", "src/repro/kernels/window_agg.py:77"),
        "segment_bin_agg_edges": (
            lambda: sa.segment_bin_agg_edges_cuda(xs, ys, vals, b, xe, ye),
            lambda: sa.segment_bin_agg_edges_torch(xs, ys, vals, b, xe, ye),
            # x, y, v read; 3 + 3 float64 edge compares and the float64
            # sum per object, float32 min/max
            bound_ms(12 * L + 32 * n_seg * 16, 2 * L, 7 * L),
            src + "segment_bin_agg_edges.cu",
            "src/repro/kernels/segment_agg.py:448"),
        "segment_window_bin_agg": (
            lambda: sa.segment_window_bin_agg_cuda(xs1, ys1, vals1, b1,
                                                   window1, *bins),
            lambda: sa.segment_window_bin_agg_torch(xs1, ys1, vals1, b1,
                                                    window1, *bins),
            # x, y read; v for in-window objects; 4 compares per object,
            # 2 subtracts + 2 divides + min/max per in-window object
            bound_ms(8 * L1 + 4 * n_in1 + 32 * nb, 4 * L1 + 6 * n_in1,
                     n_in1),
            src + "segment_window_bin_agg.cu",
            "src/repro/kernels/segment_agg.py:295"),
        "segment_window_bin_select": (
            lambda: fs.segment_window_bin_select_cuda(
                xs, ys, vals, b, window, *bins, vmin, vmax),
            lambda: fs.segment_window_bin_select_torch(
                xs, ys, vals, b, window, *bins, vmin, vmax),
            bound_ms(8 * L + 4 * n_in + 32 * n_seg * nb
                     + 8 * (n_seg + 1) * nb,
                     4 * L + 6 * n_in, n_in + 2 * n_seg * nb),
            src + "segment_window_bin_agg.cu",
            "src/repro/kernels/fused_select.py:364"),
    }
    # clocks (a) and (c) of every row before any profiler session, whose
    # tracing could stay attached to later launches
    out = {name: {"a_ms": timed(kern), "c_us": host_clock(torch, kern, 20)}
           for name, (kern, *_) in specs.items()}
    for name, (kern, plain, (bms, by), source, rep) in specs.items():
        b_ms, per_call, names = device_clock(torch, kern, flush, 20)
        c = out[name]
        c.update({"b_ms": b_ms, "launches_per_call": per_call,
                  "kernels": names, "bound_ms": bms, "bound_by": by,
                  "b_share_of_bound": bms / b_ms if b_ms else None,
                  "source": source, "replaces": rep, "plain": plain})
        log(f"{name} clocks: (a) {c['a_ms']:.4f} ms, (b) {b_ms:.4f} ms "
            f"device, (c) {c['c_us']:.1f} us host; {per_call:g} kernels a "
            f"call {names}; bound {bms:.4f} ms")
        want = 2 if name == "window_agg" else 1
        if enforce and per_call != want:
            raise Failed(f"{name} launched {per_call:g} kernels a call "
                         f"(profiler), not {want}")
    log("clocks: " + json.dumps({k: {f: v for f, v in c.items()
                                     if f != "plain"}
                                 for k, c in out.items()}))
    return out


# rows timed in phase 2b whose kernels-line entries phases 2c and 2d
# write, at the shapes at which phases 5 and 6 launch them
LINE_ELSEWHERE = ("segment_window_agg_multi", "segment_window_bin_agg_multi",
                  "segment_window_bin_select_multi", "window_agg")
# query spans of a serving heatmap pass at its median (phase 5, 10^8 rows,
# seed 0): rows 9 and 10's clock shape in phase 2b
HEATMAP_SPANS = 3


def phase_clocks(torch, timed, hs, errs):
    """Phase 2b's three clocks of rows 1-10 (one kernel a call enforced on
    all but row 5) and the kernels line's rows 1-4, 6 and 7 (row 1
    twice: one window, and the all-covering entry): ms from clock (a),
    the plain version timed alike, ``errs`` from phases 2 and 2b."""
    log("== phase 2b clocks: rows 1-10 at the main path's shapes")
    rows = {}
    for name, c in row_clocks(torch, timed, hs, enforce=True).items():
        if name in LINE_ELSEWHERE:
            continue
        if name not in errs:
            raise Failed(f"{name} was timed but never held against its "
                         "plain version")
        pms = timed(c.pop("plain"))
        rows[name] = {"name": name, "route": "cuda", "source": c["source"],
                      "replaces": c["replaces"], "launches": 0,
                      "max_abs_err": errs[name], "ms": c["a_ms"],
                      "plain_ms": pms, "bound_ms": c["bound_ms"],
                      "bound_by": c["bound_by"], "library_ms": None}
        log(f"{name}: kernel {c['a_ms']:.4f} ms, plain {pms:.4f} ms, bound "
            f"{c['bound_ms']:.4f} ms ({c['bound_by']}), max_abs_err "
            f"{errs[name]:.3e}")
    return rows


# --------------------------------------------------------------------- #
# phase 2c, the serving kernels
# --------------------------------------------------------------------- #

SERVING_KERNELS = ("segment_window_agg_multi",
                   "segment_window_bin_select_multi")


def multi_case(torch, rng, n_seg, rows, bins, empty=(), zero_area=True):
    """Segments in their own bboxes, segment s under its OWN window (edges
    that are not float32 values, crossing the bbox), objects on each
    window's bin lines and edges and on their float32 neighbours; the
    last segment's window has zero area, with objects on its point.
    Returns cuda planes, boundaries and the windows (Python floats)."""
    counts = np.full(n_seg, rows, np.int64)
    counts[list(empty)] = 0
    b = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    n = int(b[-1])
    xs = np.empty(n, np.float32)
    ys = np.empty(n, np.float32)
    wins = []
    for s in range(n_seg):
        x0, y0 = rng.uniform(0, 700, 2)
        w, h = rng.uniform(50, 300, 2)
        sl = slice(int(b[s]), int(b[s + 1]))
        c = sl.stop - sl.start
        xs[sl] = rng.uniform(x0, x0 + w, c)
        ys[sl] = rng.uniform(y0, y0 + h, c)
        win = tuple(float(np.round(v, 1) + 0.03) for v in (
            x0 + 0.2 * w, y0 + 0.1 * h, x0 + 0.8 * w, y0 + 0.7 * h))
        k = min(c, 3 * (bins[0] + 5))
        if k:
            # bin lines (float64 line, its float32 rounding, neighbours)
            # and the window's edges on x, inside the window on y
            cw = (win[2] - win[0]) / bins[0]
            lines = np.float32(win[0] + cw * np.arange(bins[0] + 1))
            pick = lines[rng.integers(0, len(lines), k)]
            d = np.arange(k) % 3 - 1
            xs[sl][:k] = np.where(d < 0, np.nextafter(pick, np.float32(
                -np.inf)), np.where(d > 0, np.nextafter(
                    pick, np.float32(np.inf)), pick))
            ys[sl][:k] = rng.uniform(win[1], win[3], k).astype(np.float32)
        wins.append(win)
    if zero_area and counts[-1]:
        a = int(b[-2])
        px, py = xs[a], ys[a]
        xs[a:a + 20], ys[a:a + 20] = px, py
        wins[-1] = (float(px), float(py), float(px), float(py))
    vals = rng.normal(5.0, 30.0, n).astype(np.float32)
    dev = [torch.from_numpy(v).to("cuda") for v in (xs, ys, vals)]
    return dev[0], dev[1], dev[2], b, wins


def even_spans(n_seg, n_spans):
    """Query spans cutting ``n_seg`` segments into ``n_spans`` runs."""
    return np.unique(np.linspace(0, n_seg, n_spans + 1).round()).astype(
        np.int64)


def phase_serving_kernels(torch, timed, seed):
    """Rows 8-10 against their plain versions on edge cases (NaN values
    and empty query spans among them) and a host sample; then row 10's
    clocks (a) and (b) where its table is past the shared memory (64
    segments of 16x16 bins, 16 384 cells: one block runs the rows, the
    suffix and the reset over the global workspace)."""
    from repro_torch.kernels import fused_select as fs
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_agg as sa

    log("== phase 2c: serving kernels against their plain versions")
    rng = np.random.default_rng(seed + 2)
    checks = make_multi_checks(torch)
    n_checks = 0
    for tag, n_seg, rows, empty, spans in (
            ("S=1", 1, 3000, (), [0, 0, 1, 1]),
            ("S=16", 16, 3000, (), [0, 1, 5, 5, 6, 16]),
            ("S=16,empty", 16, 3000, (0, 5, 15), [0, 1, 5, 6, 6, 16]),
            ("S=64", 64, 500, (), [0, 8, 9, 9, 30, 31, 64])):
        for bins in ((4, 4), (16, 16)):
            xs, ys, vals, b, wins = multi_case(torch, rng, n_seg, rows, bins,
                                               empty)
            t = f"{tag},{bins[0]}x{bins[1]}"
            checks["segment_window_agg_multi"](t, xs, ys, vals, b, wins)
            checks["segment_window_bin_agg_multi"](t, xs, ys, vals, b, wins,
                                                   bins)
            checks["segment_window_bin_select_multi"](
                t, xs, ys, vals, b, wins, bins, np.array(spans), rng)
            n_checks += 3
    # NaN values on the first in-window object of every segment and on
    # all of segment 3
    for bins in ((4, 4), (16, 16)):
        xs, ys, vals, b, wins = multi_case(torch, rng, 16, 3000, bins)
        w = torch.from_numpy(sa.windows_f32(wins, 16)).to("cuda")[
            sa.segment_ids(b, "cuda")]
        inside = ((xs >= w[:, 0]) & (xs <= w[:, 2]) & (ys >= w[:, 1])
                  & (ys <= w[:, 3])).cpu().numpy()
        for s in range(16):
            hit = np.flatnonzero(inside[b[s]:b[s + 1]])
            if len(hit):
                vals[int(b[s] + hit[0])] = float("nan")
        vals[int(b[3]):int(b[4])] = float("nan")
        t = f"nan_values,{bins[0]}x{bins[1]}"
        checks["segment_window_agg_multi"](t, xs, ys, vals, b, wins)
        checks["segment_window_bin_agg_multi"](t, xs, ys, vals, b, wins,
                                               bins)
        checks["segment_window_bin_select_multi"](
            t, xs, ys, vals, b, wins, bins, np.array([0, 1, 5, 6, 16]), rng)
        n_checks += 3
    log(f"serving edge cases ({n_checks} checks, NaN values among them): "
        "equal (suffix_w bit for bit per span)")

    # a host sample against the float64 numpy mirrors, each segment's
    # window as the ticket gives it (Python floats: float32 compares)
    xs, ys, vals, b, wins = multi_case(torch, rng, 4, 20_000, (4, 4))
    hx, hy, hv = (t.cpu().numpy() for t in (xs, ys, vals))
    habs = np.abs(hv)
    compare("segment_window_agg_multi[np mirror]",
            sa.segment_window_agg_multi_cuda(xs, ys, vals, b, wins).cpu(),
            ref.segment_window_agg_multi_np(hx, hy, hv, b, wins),
            ref.segment_window_agg_multi_np(hx, hy, habs, b, wins)[:, 1])
    want_abs = ref.segment_window_bin_agg_multi_np(hx, hy, habs, b, wins, 4,
                                                   4)[..., 1]
    compare("segment_window_bin_agg_multi[np mirror]",
            sa.segment_window_bin_agg_multi_cuda(xs, ys, vals, b, wins, 4,
                                                 4).cpu(),
            ref.segment_window_bin_agg_multi_np(hx, hy, hv, b, wins, 4, 4),
            want_abs)
    vmin = rng.uniform(-100.0, 0.0, 4)
    vmax = vmin + rng.uniform(0.0, 200.0, 4)
    qb = np.array([0, 1, 4])
    got, got_w = fs.segment_window_bin_select_multi_cuda(
        xs, ys, vals, b, wins, 4, 4, vmin, vmax, qb)
    want, want_w = fs.segment_window_bin_select_multi_np(
        hx, hy, hv, b, wins, 4, 4, vmin, vmax, qb)
    compare("segment_window_bin_select_multi[np mirror]", got.cpu(), want,
            want_abs)
    if not np.array_equal(got_w.cpu().numpy(), want_w):
        raise Failed("segment_window_bin_select_multi: suffix_w differs "
                      "from the numpy mirror")
    log("serving host sample against the numpy mirrors: equal")

    xs, ys, vals, b, wins = multi_case(torch, rng, 64, 500, (16, 16))
    vmin, vmax = np.full(64, -150.0), np.full(64, 160.0)
    qb = even_spans(64, 8)
    checks["segment_window_bin_select_multi"]("global_sink", xs, ys, vals,
                                              b, wins, (16, 16), qb, rng)

    def kern():
        return fs.segment_window_bin_select_multi_cuda(
            xs, ys, vals, b, wins, 16, 16, vmin, vmax, qb)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    a_ms = timed(kern)
    b_ms, per_call, names = device_clock(torch, kern, flush, 20)
    log(f"segment_window_bin_select_multi, global sink (64 segments, "
        f"{int(b[-1])} objects, 16x16 bins, 16 384 cells, 8 spans): (a) "
        f"{a_ms:.4f} ms, (b) {b_ms:.4f} ms device; {per_call:g} kernels a "
        f"call {names}")
    if per_call != 1:
        raise Failed(f"segment_window_bin_select_multi launched {per_call:g} "
                     "kernels a call (profiler) on the global sink, not 1")


def make_multi_checks(torch):
    """``{kernel: check(tag, ...)}``: each multi kernel against its plain
    version on the same CUDA tensors; returns the largest difference."""
    from repro_torch.kernels import fused_select as fs
    from repro_torch.kernels import segment_agg as sa

    def swam(tag, xs, ys, vals, b, wins):
        got = sa.segment_window_agg_multi_cuda(xs, ys, vals, b, wins)
        want = sa.segment_window_agg_multi_torch(xs, ys, vals, b, wins)
        absv = sa.segment_window_agg_multi_torch(xs, ys, vals.abs(), b, wins)
        torch.cuda.synchronize()
        return compare(f"segment_window_agg_multi[{tag}]", got.cpu(),
                       want.cpu(), absv[:, 1].cpu())

    def swbm(tag, xs, ys, vals, b, wins, bins):
        got = sa.segment_window_bin_agg_multi_cuda(xs, ys, vals, b, wins,
                                                   *bins)
        want = sa.segment_window_bin_agg_multi_torch(xs, ys, vals, b, wins,
                                                     *bins)
        absv = sa.segment_window_bin_agg_multi_torch(xs, ys, vals.abs(), b,
                                                     wins, *bins)
        torch.cuda.synchronize()
        return compare(f"segment_window_bin_agg_multi[{tag}]", got.cpu(),
                       want.cpu(), absv[..., 1].cpu())

    def swsm(tag, xs, ys, vals, b, wins, bins, qb, rng):
        n_seg = len(b) - 1
        vmin = rng.uniform(-120.0, 0.0, n_seg)
        vmax = vmin + rng.uniform(0.0, 240.0, n_seg)
        got, got_w = fs.segment_window_bin_select_multi_cuda(
            xs, ys, vals, b, wins, *bins, vmin, vmax, qb)
        want, want_w = fs.segment_window_bin_select_multi_torch(
            xs, ys, vals, b, wins, *bins, vmin, vmax, qb)
        absv, _ = fs.segment_window_bin_select_multi_torch(
            xs, ys, vals.abs(), b, wins, *bins, vmin, vmax, qb)
        torch.cuda.synchronize()
        if not torch.equal(got_w, want_w):
            raise Failed(f"segment_window_bin_select_multi[{tag}]: suffix_w "
                         "differs from the plain version")
        return compare(f"segment_window_bin_select_multi[{tag}]", got.cpu(),
                       want.cpu(), absv[..., 1].cpu())

    return {"segment_window_agg_multi": swam,
            "segment_window_bin_agg_multi": swbm,
            "segment_window_bin_select_multi": swsm}


def time_serving_kernels(torch, timed, seed, shapes):
    """Rows 8-10 at phase 5's median pass shapes (``shapes``: per family,
    the median segments, objects and query spans of a pass): checked
    against their plain versions there, then timed."""
    from repro_torch.kernels import fused_select as fs
    from repro_torch.kernels import segment_agg as sa

    log("== phase 2c timings at phase 5's median pass shapes")
    rng = np.random.default_rng(seed + 3)
    checks = make_multi_checks(torch)
    bins = (4, 4)
    nb = bins[0] * bins[1]
    rows = {}
    sc, hm = shapes["scalar"], shapes["heatmap"]

    def case(shape):
        n_seg = max(1, int(shape["segments"]))
        per = max(1, int(shape["objects"]) // n_seg)
        xs, ys, vals, b, wins = multi_case(torch, rng, n_seg, per, bins,
                                           zero_area=False)
        L = int(b[-1])
        p = torch.from_numpy(sa.bin_params_multi(wins, n_seg, *bins)).to(
            "cuda")[sa.segment_ids(b, "cuda")]
        n_in = int(sa.param_bin_ids(xs, ys, p, *bins)[0].sum())
        return xs, ys, vals, b, wins, n_seg, L, n_in

    xs, ys, vals, b, wins, S, L, n_in = case(sc)
    err = checks["segment_window_agg_multi"]("median", xs, ys, vals, b, wins)
    ms = timed(lambda: sa.segment_window_agg_multi_cuda(xs, ys, vals, b,
                                                        wins))
    pms = timed(lambda: sa.segment_window_agg_multi_torch(xs, ys, vals, b,
                                                          wins))
    # x, y read; v for in-window objects; f64 rows out
    bms, by = bound_ms(8 * L + 4 * n_in + 32 * S, 4 * L + 2 * n_in, n_in)
    rows["segment_window_agg_multi"] = dict(
        shape=(S, L), err=err, ms=ms, pms=pms, bms=bms, by=by,
        source="src/repro_torch/kernels/csrc/segment_window_agg.cu",
        replaces="src/repro/kernels/segment_agg.py:219")

    xs, ys, vals, b, wins, S, L, n_in = case(hm)
    qb = even_spans(S, int(hm["spans"]))
    vmin = np.full(S, -150.0)
    vmax = np.full(S, 160.0)
    err_b = checks["segment_window_bin_agg_multi"]("median", xs, ys, vals,
                                                   b, wins, bins)
    err_s = checks["segment_window_bin_select_multi"](
        "median", xs, ys, vals, b, wins, bins, qb, rng)
    for name, err, kern, plain, extra in (
            ("segment_window_bin_agg_multi", err_b,
             lambda: sa.segment_window_bin_agg_multi_cuda(
                 xs, ys, vals, b, wins, *bins),
             lambda: sa.segment_window_bin_agg_multi_torch(
                 xs, ys, vals, b, wins, *bins), 0),
            ("segment_window_bin_select_multi", err_s,
             lambda: fs.segment_window_bin_select_multi_cuda(
                 xs, ys, vals, b, wins, *bins, vmin, vmax, qb),
             lambda: fs.segment_window_bin_select_multi_torch(
                 xs, ys, vals, b, wins, *bins, vmin, vmax, qb), 1)):
        # x, y read; v for in-window objects; f64 table (and suffix) out;
        # 4 compares per object, 2 subtracts + 2 divides + min/max per
        # in-window object; the suffix's f64 multiply-add per cell
        bms, by = bound_ms(8 * L + 4 * n_in + 32 * S * nb + extra * 8 * S * nb,
                           4 * L + 6 * n_in, n_in + extra * 2 * S * nb)
        rows[name] = dict(
            shape=(S, L), err=err, ms=timed(kern), pms=timed(plain), bms=bms,
            by=by, source="src/repro_torch/kernels/csrc/"
            "segment_window_bin_agg.cu",
            replaces=("src/repro/kernels/segment_agg.py:372"
                      if extra == 0 else
                      "src/repro/kernels/fused_select.py:498"))
    out = {}
    for name, r in rows.items():
        out[name] = {"name": name, "route": "cuda", "source": r["source"],
                     "replaces": r["replaces"], "launches": 0,
                     "max_abs_err": r["err"], "ms": r["ms"],
                     "plain_ms": r["pms"], "bound_ms": r["bms"],
                     "bound_by": r["by"], "library_ms": None}
        log(f"{name} ({r['shape'][0]} segments, {r['shape'][1]} objects): "
            f"kernel {r['ms']:.4f} ms, plain {r['pms']:.4f} ms, bound "
            f"{r['bms']:.4f} ms ({r['by']}), max_abs_err {r['err']:.3e}")
    return out


# --------------------------------------------------------------------- #
# phase 2d, window_agg; the paper-scale scan; phase 6, the port's B3
# --------------------------------------------------------------------- #

WINDOW_AGG_SRC = "src/repro_torch/kernels/csrc/window_agg.cu"
WINDOW_AGG_TPU = "src/repro/kernels/window_agg.py:77"


def check_window_agg(torch, tag, xs, ys, vals, window, n=None):
    """``window_agg`` and ``window_count`` on the card against their
    plain versions on the same tensors; returns the largest difference."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.window_agg import window_agg_torch

    got = ops.window_agg(xs, ys, vals, window, n=n, backend="cuda")
    cnt = ops.window_count(xs, ys, window, n=n, backend="cuda")
    want = window_agg_torch(xs, ys, vals, window, n)
    absv = window_agg_torch(xs, ys, vals.abs(), window, n)
    torch.cuda.synchronize()
    err = compare(f"window_agg[{tag}]", got.cpu(), want.cpu(),
                  absv[1].cpu())
    if cnt.item() != want[0].item():
        raise Failed(f"window_count[{tag}]: {cnt.item()} != "
                     f"{want[0].item()}")
    return err


def phase_window_agg(torch, timed, build, seed):
    from repro_torch.kernels import ref
    from repro_torch.kernels.ops import window_mask as ops_mask
    from repro_torch.kernels.window_agg import (window_agg_cuda,
                                                window_agg_torch)

    log("== phase 2d: window_agg against its plain version")
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 4)
    before = build.LAUNCHES["window_agg"]

    def planes(n, lo=0.0, hi=1000.0):
        a = [rng.uniform(lo, hi, n).astype(np.float32) for _ in range(2)]
        a.append(rng.normal(5.0, 30.0, n).astype(np.float32))
        return [torch.from_numpy(v).to("cuda") for v in a]

    w = (200.3, 180.7, 610.1, 590.9)       # edges that are not float32
    n_cases = 0
    for n in (0, 1, 3, 4097):
        xs, ys, vals = planes(n)
        check_window_agg(torch, f"n={n}", xs, ys, vals, w)
        n_cases += 1
    xs, ys, vals = planes(100_003)
    # an unaligned view and n short of the planes (the float4 body after
    # a scalar head)
    check_window_agg(torch, "view", xs[1:], ys[1:], vals[1:], w,
                     n=len(xs) - 9)
    # views cut at different offsets cannot share the float4 loads: the
    # wrapper raises, launching nothing
    for pl in ((xs[1:-1], ys[2:], vals[:-2]), (xs[1:-1], ys[2:], None),
               (xs[:-1], ys[:-1], vals[1:])):
        n_before = build.LAUNCHES["window_agg"]
        try:
            window_agg_cuda(*pl, w)
        except ValueError:
            pass
        else:
            raise Failed("window_agg took planes at different offsets")
        if build.LAUNCHES["window_agg"] != n_before:
            raise Failed("window_agg launched on planes at different "
                         "offsets")
    for tag, win in (("everywhere", (-np.inf, -np.inf, np.inf, np.inf)),
                     ("empty", (-5.0, -5.0, -1.0, -1.0))):
        check_window_agg(torch, tag, xs, ys, vals, win)
    # a zero-area window with objects on its point
    px, py = float(xs[5]), float(ys[5])
    zx, zy = xs.clone(), ys.clone()
    zx[::11], zy[::11] = px, py
    check_window_agg(torch, "zero_area", zx, zy, vals, (px, py, px, py))
    # objects on the window's edges and their float32 neighbours, the
    # window as Python floats; all-negative values
    hx, hy = xs.cpu().numpy().copy(), ys.cpu().numpy().copy()
    k = 3000
    for j, (axis, e) in enumerate(((hx, w[0]), (hx, w[2]), (hy, w[1]),
                                   (hy, w[3]))):
        e32 = np.float32(e)
        sl = slice(j * k, (j + 1) * k)
        d = np.arange(k) % 3 - 1
        axis[sl] = np.where(d < 0, np.nextafter(e32, np.float32(-np.inf)),
                            np.where(d > 0, np.nextafter(
                                e32, np.float32(np.inf)), e32))
        other = hy if axis is hx else hx
        other[sl] = np.float32(0.5 * (w[1] + w[3]) if axis is hx
                               else 0.5 * (w[0] + w[2]))
    ex, ey = (torch.from_numpy(a).to("cuda") for a in (hx, hy))
    check_window_agg(torch, "edges", ex, ey, vals, w)
    check_window_agg(torch, "negative", ex, ey, -vals.abs() - 1.0, w)
    # a NaN value inside the window, and one anywhere under +-inf
    vn = vals.clone()
    vn[int(torch.nonzero(ops_mask(xs, ys, w))[0, 0])] = float("nan")
    check_window_agg(torch, "nan_values", xs, ys, vn, w)
    vn = vals.clone()
    vn[17] = float("nan")
    check_window_agg(torch, "nan_everywhere", xs, ys, vn,
                     (-np.inf, -np.inf, np.inf, np.inf))
    n_cases += 8
    log(f"window_agg edge cases ({n_cases}, each with window_count): equal;"
        f" planes at different offsets raise")

    # a host sample below 2^24 objects against the numpy mirror: count
    # equal, extrema equal, the sum within one float32 ulp of its row
    xs, ys, vals = planes(2_000_000)
    got = window_agg_cuda(xs, ys, vals, w).cpu().numpy()
    want = ref.window_agg_np(xs.cpu().numpy(), ys.cpu().numpy(),
                             vals.cpu().numpy(), w, len(xs))
    if not (got[0] == want[0] and got[2] == want[2] and got[3] == want[3]
            and abs(got[1] - np.float64(want[1]))
            <= np.spacing(np.abs(want[1]))):
        raise Failed(f"window_agg disagrees with the numpy mirror: {got} "
                     f"vs {want}")
    log("window_agg host sample (2e6 objects) against the numpy mirror: "
        "equal")

    # time at the main path's tile (one 390 625-object segment, 1e8 / 256)
    # and at B3's data, where phase 6 launches it: the kernels line's row
    from repro_torch.benchmarks import kernels_bench
    tile = 390_625
    shapes = (("tile", planes(tile, 300.0, 500.0),
               (350.3, 340.7, 460.1, 450.9)),
              ("B3", [torch.from_numpy(a).to("cuda")
                      for a in kernels_bench.data(1_000_000)],
               kernels_bench.WINDOW))
    for tag, (xs, ys, vals), wt in shapes:
        err = check_window_agg(torch, tag, xs, ys, vals, wt)
        n_in = int(window_agg_torch(xs, ys, None, wt)[0].item())
        ms = timed(lambda: window_agg_cuda(xs, ys, vals, wt))
        pms = timed(lambda: window_agg_torch(xs, ys, vals, wt))
        # x and y read once, v of the in-window objects, the f64 row out;
        # 4 compares per object, the f64 sum and 2 extrema per in-window
        # object (the kernel reads every v: 12 bytes an object)
        bms, by = bound_ms(8 * len(xs) + 4 * n_in + 32,
                           4 * len(xs) + 2 * n_in, n_in)
        log(f"window_agg {tag} ({len(xs)} objects, {n_in} in the window): "
            f"kernel {ms:.4f} ms, plain {pms:.4f} ms, bound {bms:.4f} ms "
            f"({by}), max_abs_err {err:.3e}")
    launched = build.LAUNCHES["window_agg"] - before
    log(f"window_agg launches in phase 2d: {launched}")
    if launched <= 0:
        raise Failed("window_agg was not launched in phase 2d")
    log(f"phase 2d took {time.perf_counter() - t_phase:.3f} s")
    return {"window_agg": {
        "name": "window_agg", "route": "cuda", "source": WINDOW_AGG_SRC,
        "replaces": WINDOW_AGG_TPU, "launches": 0, "max_abs_err": err,
        "ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
        "library_ms": None}}


def phase_scan(torch, timed, ds):
    """``window_agg`` / ``window_count`` over the whole file (x, y, a0 on
    the card) under B3's window and an all-covering one, each against
    its plain version and timed beside its byte bound."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.window_agg import window_agg_torch

    log(f"== paper-scale scan: window_agg over {ds.n} rows")
    t_phase = time.perf_counter()
    x, y = ds.x, ds.y
    a0 = ds.read_all_unaccounted("a0")
    n = ds.n
    out = {}
    for tag, w in (("b3", (200.0, 200.0, 600.0, 600.0)),
                   ("everywhere", (-np.inf, -np.inf, np.inf, np.inf))):
        err = check_window_agg(torch, f"scan,{tag}", x, y, a0, w)
        row = window_agg_torch(x, y, a0, w).cpu().numpy()
        n_in = int(row[0])
        ms = timed(lambda: ops.window_agg(x, y, a0, w, backend="cuda"))
        cms = timed(lambda: ops.window_count(x, y, w, backend="cuda"))
        pms = timed(lambda: window_agg_torch(x, y, a0, w))
        # the bound counts x, y and the in-window v; the kernel reads every
        # v, so its rate (read_gb_s) is over 12 n bytes
        bms = bound_ms(8 * n + 4 * n_in + 32, 4 * n + 2 * n_in, n_in)
        cbms = bound_ms(8 * n + 32, 4 * n, 0)
        out[tag] = {"count": float(row[0]), "sum": float(row[1]),
                    "max_abs_err": err, "window_agg_ms": ms,
                    "bound_ms": bms[0], "bound_by": bms[1],
                    "share_of_bound": bms[0] / ms,
                    "read_gb_s": 12 * n / ms * 1e-6, "window_count_ms": cms,
                    "count_bound_ms": cbms[0],
                    "count_share_of_bound": cbms[0] / cms,
                    "count_read_gb_s": 8 * n / cms * 1e-6, "plain_ms": pms}
        log(f"scan {tag}: window_agg {ms:.4f} ms (bound {bms[0]:.4f} ms, "
            f"{bms[1]}, {bms[0] / ms:.3f} of it; reads "
            f"{12 * n / ms * 1e-6:.1f} GB/s), window_count {cms:.4f} ms "
            f"(bound {cbms[0]:.4f} ms, {cbms[0] / cms:.3f} of it; reads "
            f"{8 * n / cms * 1e-6:.1f} GB/s), plain {pms:.4f} ms, "
            f"count {n_in}, max_abs_err {err:.3e}")
    log(f"scan: {json.dumps(out)}")
    del x, y, a0
    torch.cuda.empty_cache()
    log(f"the scan took {time.perf_counter() - t_phase:.3f} s")
    return out


def phase_bench(torch, build):
    """The port's B3 at its full size, on the card."""
    from repro_torch.benchmarks import common, kernels_bench

    log("== phase 6: the port's kernels bench (B3)")
    t0 = time.perf_counter()
    common.EMITTED.clear()
    build.reset_launches()
    kernels_bench.main()
    launches = dict(build.LAUNCHES)
    log(f"phase 6: {len(common.EMITTED)} B3 rows in "
        f"{time.perf_counter() - t0:.3f} s")
    log(f"launches in phase 6: {json.dumps(launches)}")
    for k in ("window_agg", "bin_agg", "segment_window_bin_select",
              "segment_window_bin_select_multi"):
        if launches.get(k, 0) <= 0:
            raise Failed(f"{k} was not launched by the kernels bench")
    for r in common.EMITTED:
        if not (np.isfinite(r["us_per_call"]) and r["GB_s"] > 0):
            raise Failed(f"B3 row {r['name']} is not a finite time")
    return launches


# --------------------------------------------------------------------- #
# phase 3
# --------------------------------------------------------------------- #

def make_dataset(torch, seed, n_rows):
    from repro_torch.data import make_synthetic_dataset

    t0 = time.perf_counter()
    ds = make_synthetic_dataset(n=n_rows, n_columns=10, seed=seed,
                                device="cuda")
    torch.cuda.synchronize()
    log(f"dataset: {n_rows} rows x (x, y, a0..a9) on the card in "
        f"{time.perf_counter() - t0:.3f} s")
    return ds


def phase_main_path(torch, build, ds, windows):
    from repro_torch.core import AQPEngine, IndexConfig
    from repro_torch.core import geometry

    log(f"== phase 3: main path, {ds.n} rows, {len(windows)} windows")
    build.reset_launches()
    t0 = time.perf_counter()
    eng = AQPEngine(ds, IndexConfig(init_metadata_attrs=("a0",)))
    torch.cuda.synchronize()
    log(f"engine init (16x16 grid, sort, a0 metadata): "
        f"{time.perf_counter() - t0:.3f} s")
    ix = eng.index
    # the device init must own objects by the host's float32 rule
    hx, hy = ds.x.cpu().numpy(), ds.y.cpu().numpy()
    cell = geometry.bin_cell_ids(hx, hy, ds.domain(), 16, 16)
    del hx, hy
    if not np.array_equal(np.bincount(cell, minlength=256), ix.count[:256]):
        raise Failed("device init counts differ from the host rule")
    del cell
    log("init tile counts equal the host float32 rule")

    n_check = min(10, len(windows))
    snap = None
    for phi in (0.05, 0.0):
        for q, w in enumerate(windows):
            r = eng.query(w, "mean", "a0", phi=phi)
            truth = eng.oracle(w, "mean", "a0")
            if phi > 0:
                tol = 1e-9 * max(abs(truth), 1.0)
                ok = (r.lo - tol <= truth <= r.hi + tol
                      and (r.bound <= phi or r.exact))
            else:
                ok = r.exact and abs(r.value - truth) <= 1e-9 * abs(truth)
            log(f"q phi={phi} {q:2d} t={r.eval_time_s:.6f}s "
                f"read={r.objects_read} calls={r.read_calls} "
                f"tiles={r.tiles_processed} value={r.value:.12g} "
                f"oracle={truth:.12g} bound={r.bound:.3e} ok={ok}")
            if not ok:
                raise Failed(f"query {q} at phi={phi}: {r} vs {truth}")
            if phi > 0 and q == n_check - 1:
                snap = (ix.n_tiles, ix.count[:ix.n_tiles].copy(),
                        ix.perm.cpu().numpy().copy())

    seq = AQPEngine(ds, IndexConfig(init_metadata_attrs=("a0",)))
    for w in windows[:n_check]:
        seq.query(w, "mean", "a0", phi=0.05, sequential=True)
    si = seq.index
    if not (si.n_tiles == snap[0] and np.array_equal(
            si.count[:si.n_tiles], snap[1])
            and np.array_equal(si.perm.cpu().numpy(), snap[2])):
        raise Failed("sequential engine's index differs from batched")
    log(f"sequential replay of {n_check} windows: same index "
        f"({si.n_tiles} tiles)")
    launches = dict(build.LAUNCHES)
    del seq, si

    ix.check_invariants("a0")
    log("invariants hold")
    tot = eng.trace.totals()
    log(f"totals: {json.dumps(tot)}")
    log(f"device memory: allocated {torch.cuda.memory_allocated()} B, "
        f"peak {torch.cuda.max_memory_allocated()} B")
    log(f"launches on the main path: {json.dumps(launches)}")
    for k in ("segment_window_agg", "segment_window_agg_everywhere",
              "segment_bin_agg", "bin_agg"):
        if launches.get(k, 0) <= 0:
            raise Failed(f"{k} was not launched on the main path")
    return launches


# --------------------------------------------------------------------- #
# phase 4
# --------------------------------------------------------------------- #

HEATMAP_KERNELS = ("segment_bin_agg_edges", "segment_window_bin_agg",
                   "segment_window_bin_select")


def heatmap_ok(r, truth, phi):
    """Every bin of ``r`` against the oracle: φ > 0 — the bin's interval
    contains it (to 1e-9 relative) and the query bound meets φ; φ = 0 —
    the answer is exact and every bin equals it within 1e-9."""
    fin = np.isfinite(truth)
    if not np.array_equal(np.isfinite(r.values), fin):
        return False
    t = truth[fin]
    tol = 1e-9 * np.maximum(np.abs(t), 1.0)
    if phi > 0:
        return bool((r.lo[fin] - tol <= t).all() and (t <= r.hi[fin] + tol)
                    .all() and (r.bound <= phi or r.exact))
    return bool(r.exact and (np.abs(r.values[fin] - t)
                             <= 1e-9 * np.abs(t)).all())


def phase_heatmap_path(torch, build, ds, windows):
    from repro_torch.core import AccuracyPolicy, AQPEngine, IndexConfig

    log(f"== phase 4: heatmap path, {ds.n} rows, {len(windows)} windows, "
        "bins 8x8")
    bins = (8, 8)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    eng = AQPEngine(ds, IndexConfig(init_metadata_attrs=("a0",)))
    torch.cuda.synchronize()
    log(f"engine init: {time.perf_counter() - t0:.3f} s")
    ix = eng.index

    n_check = min(10, len(windows))
    snap = None
    stats = {}
    for phi in (0.05, 0.0):
        times, reads, calls = [], [], []
        for q, w in enumerate(windows):
            r = eng.heatmap(w, "mean", "a0", bins=bins, phi=phi)
            truth = eng.heatmap_oracle(w, "mean", "a0", bins=bins)
            ok = heatmap_ok(r, truth, phi)
            log(f"h phi={phi} {q:2d} t={r.eval_time_s:.6f}s "
                f"read={r.objects_read} calls={r.read_calls} "
                f"tiles={r.tiles_processed} bound={r.bound:.3e} "
                f"occupied={int(np.isfinite(truth).sum())} ok={ok}")
            if not ok:
                raise Failed(f"heatmap {q} at phi={phi}: a bin misses "
                             "the oracle")
            times.append(r.eval_time_s)
            reads.append(r.objects_read)
            calls.append(r.read_calls)
            if phi > 0 and q == n_check - 1:
                snap = (ix.n_tiles, ix.count[:ix.n_tiles].copy(),
                        ix.perm.cpu().numpy().copy())
        stats[phi] = {
            "eval_time_s_median": float(np.median(times)),
            "eval_time_s_p90": float(np.percentile(times, 90)),
            "eval_time_s_max": float(np.max(times)),
            "eval_time_s_sum": float(np.sum(times)),
            "objects_read_sum": int(np.sum(reads)),
            "objects_read_median": float(np.median(reads)),
            "read_calls_sum": int(np.sum(calls))}
        log(f"heatmap phi={phi}: {json.dumps(stats[phi])}")

    # per-bin budgets with an absolute floor
    policy = AccuracyPolicy(eps_abs=0.5)
    for q, w in enumerate(windows[:n_check]):
        r = eng.heatmap(w, "mean", "a0", bins=bins, phi=0.05, policy=policy)
        truth = eng.heatmap_oracle(w, "mean", "a0", bins=bins)
        fin = np.isfinite(truth)
        tol = 1e-9 * np.maximum(np.abs(truth[fin]), 1.0)
        if not (r.bin_met.all() and (r.lo[fin] - tol <= truth[fin]).all()
                and (truth[fin] <= r.hi[fin] + tol).all()):
            raise Failed(f"policy heatmap {q}: a bin misses its budget or "
                         "the oracle")
    log(f"policy (eps_abs=0.5, phi=0.05) on {n_check} windows: every bin "
        "met its budget and contains the oracle")

    # session memory: the last viewport again, until a repeat reads
    # nothing (registry hits and single-bin children answer it)
    w = windows[-1]
    rep_reads = []
    for _ in range(16):
        r = eng.heatmap(w, "mean", "a0", bins=bins, phi=0.0)
        if not heatmap_ok(r, eng.heatmap_oracle(w, "mean", "a0", bins=bins),
                          0.0):
            raise Failed("repeated viewport: a bin misses the oracle")
        rep_reads.append(r.objects_read)
        if r.objects_read == 0:
            break
    log(f"repeated viewport, objects read per repeat: {rep_reads}")
    if rep_reads[-1] != 0 or any(a < b for a, b in zip(rep_reads,
                                                        rep_reads[1:])):
        raise Failed("repeated viewport did not come down to zero reads")

    seq = AQPEngine(ds, IndexConfig(init_metadata_attrs=("a0",)))
    for w in windows[:n_check]:
        seq.heatmap(w, "mean", "a0", bins=bins, phi=0.05, sequential=True)
    si = seq.index
    if not (si.n_tiles == snap[0] and np.array_equal(
            si.count[:si.n_tiles], snap[1])
            and np.array_equal(si.perm.cpu().numpy(), snap[2])):
        raise Failed("sequential heatmap engine's index differs from "
                     "batched")
    log(f"sequential replay of {n_check} heatmaps: same index "
        f"({si.n_tiles} tiles)")
    launches = dict(build.LAUNCHES)
    del seq, si

    ix.check_invariants("a0")
    log("invariants hold")
    tot = eng.trace.totals()
    log(f"totals: {json.dumps(tot)}")
    log(f"device memory: allocated {torch.cuda.memory_allocated()} B, "
        f"peak {torch.cuda.max_memory_allocated()} B")
    log(f"launches on the heatmap path: {json.dumps(launches)}")
    for k in HEATMAP_KERNELS:
        if launches.get(k, 0) <= 0:
            raise Failed(f"{k} was not launched on the heatmap path")
    return launches


# --------------------------------------------------------------------- #
# phase 5
# --------------------------------------------------------------------- #

# B7's workload (benchmarks/serving_concurrency.py:44-107)
PHI = 0.05
N_HOT = 8
ZIPF_S = 1.3
DOMAIN = 1000.0


def serving_config():
    from repro_torch.core import IndexConfig
    return IndexConfig(grid0=(8, 8), min_split_count=512,
                       init_metadata_attrs=("a0",))


def hot_spots(rng):
    pts = rng.uniform(0.1 * DOMAIN, 0.9 * DOMAIN, size=(N_HOT, 2))
    w = 1.0 / np.arange(1, N_HOT + 1) ** ZIPF_S
    return pts, w / w.sum()


def b7_script(rng, n_sessions, n_ticks):
    """Per tick, per session: (kind, window) — centre a zipf-weighted hot
    spot plus N(0, 20), half-width U(50, 150), every 4th submission a
    4x4 heatmap (B7's ``_submit_workload``)."""
    hot, pw = hot_spots(np.random.default_rng(23))
    ticks, n = [], 0
    for _ in range(n_ticks):
        subs = []
        for k in range(n_sessions):
            cx, cy = (hot[rng.choice(N_HOT, p=pw)]
                      + rng.normal(0, 0.02 * DOMAIN, 2))
            w = rng.uniform(0.05, 0.15) * DOMAIN
            win = (cx - w, cy - w, cx + w, cy + w)
            subs.append(("heatmap" if (n + k) % 4 == 3 else "query", win))
        n += n_sessions
        ticks.append(subs)
    return ticks


def submit(sessions, subs):
    for s, (kind, win) in zip(sessions, subs):
        if kind == "heatmap":
            s.heatmap(win, "mean", "a0", bins=(4, 4), phi=PHI)
        else:
            s.query(win, "mean", "a0", phi=PHI)


class TickRecorder:
    """Records, while active, the segments, objects and query spans of
    every multi-window pass the serving tick makes (by wrapping the two
    ops it calls) and the host time spent in its rounds
    (``ServingEngine._execute_round``: gather, passes, folds) and in
    publication (``EpochStage.publish``)."""

    def __init__(self, ops, engine_cls, stage_cls):
        self.targets = [(ops, "segment_window_agg_multi", "scalar"),
                        (ops, "segment_window_bin_select_multi", "heatmap"),
                        (engine_cls, "_execute_round", "rounds"),
                        (stage_cls, "publish", "publish")]
        self.rec = {"scalar": [], "heatmap": []}
        self.seconds = {"rounds": 0.0, "publish": 0.0}
        self.n_rounds = 0

    def _wrap(self, fn, what):
        rec, seconds = self.rec, self.seconds

        def shape(boundaries, qbounds=None):
            return (len(boundaries) - 1, int(boundaries[-1]),
                    1 if qbounds is None else len(qbounds) - 1)

        if what == "scalar":
            def f(xs, ys, vals, boundaries, windows, **kw):
                rec["scalar"].append(shape(boundaries))
                return fn(xs, ys, vals, boundaries, windows, **kw)
        elif what == "heatmap":
            def f(xs, ys, vals, boundaries, windows, vmin_s, vmax_s,
                  qbounds=None, **kw):
                rec["heatmap"].append(shape(boundaries, qbounds))
                return fn(xs, ys, vals, boundaries, windows, vmin_s, vmax_s,
                          qbounds, **kw)
        else:
            def f(*a, **kw):
                t = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    seconds[what] += time.perf_counter() - t
                    self.n_rounds += what == "rounds"
        return f

    def __enter__(self):
        self.orig = [getattr(o, n) for o, n, _ in self.targets]
        for (o, n, what), fn in zip(self.targets, self.orig):
            setattr(o, n, self._wrap(fn, what))
        return self

    def __exit__(self, *exc):
        for (o, n, _), fn in zip(self.targets, self.orig):
            setattr(o, n, fn)

    def summary(self):
        out = {"rounds": self.n_rounds,
               "rounds_s": self.seconds["rounds"],
               "publish_s": self.seconds["publish"]}
        for fam, r in self.rec.items():
            a = np.asarray(r, np.float64).reshape(-1, 3)
            out[fam] = {"passes": len(a)}
            for j, key in enumerate(("segments", "objects", "spans")):
                out[fam][key] = float(np.median(a[:, j])) if len(a) else 0.0
                out[fam][f"{key}_max"] = float(a[:, j].max(initial=0))
        return out


def profile_tick(torch, server, sessions, subs):
    """One more tick under ``torch.profiler``: its wall time, the device
    time of its kernels and the largest of them by name."""
    from torch.profiler import ProfilerActivity, profile

    submit(sessions, subs)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        server.tick()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    dev = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us > 0:
            dev[e.key] = us * 1e-6
    busy = sum(dev.values())
    out = {"wall_s": wall, "device_busy_s": busy if dev else None,
           "device_idle_share": 1.0 - busy / wall if dev else None,
           "top_device_s": sorted(dev.items(), key=lambda kv: -kv[1])[:8]}
    log(f"profiled tick: {json.dumps(out)}")
    return out


def serving_ok(r, truth, phi):
    """Scalar or heatmap answer against its oracle (per bin within 1e-6,
    as B7 holds it)."""
    if not hasattr(r, "values"):
        return r.lo - 1e-9 <= truth <= r.hi + 1e-9
    fin = np.isfinite(truth)
    return bool((r.lo[fin] - 1e-6 <= truth[fin]).all()
                and (truth[fin] <= r.hi[fin] + 1e-6).all())


def phase_serving(torch, build, ds, n_ticks, n_sessions=16):
    from repro_torch.core import AQPEngine, EpochStage, ServingEngine
    from repro_torch.kernels import ops

    log(f"== phase 5: serving tick, {ds.n} rows, {n_sessions} sessions x "
        f"{n_ticks} ticks (B7's workload)")
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = AQPEngine(ds, serving_config())
    torch.cuda.synchronize()
    log(f"engine init (8x8 grid, min_split_count 512): "
        f"{time.perf_counter() - t0:.3f} s")
    server = eng.serve()
    sessions = [server.open_session(f"s{i}") for i in range(n_sessions)]
    script = b7_script(np.random.default_rng(100 + n_sessions), n_sessions,
                       n_ticks + 1)
    results, windows, tick_s = [], [], []
    published = masked = 0
    reads0 = eng.io_stats.rows_read
    recorder = TickRecorder(ops, ServingEngine, EpochStage)
    build.reset_launches()
    with recorder:
        for subs in script[:n_ticks]:
            submit(sessions, subs)
            t = time.perf_counter()
            rs = server.tick()
            torch.cuda.synchronize()
            tick_s.append(time.perf_counter() - t)
            results.extend(rs)
            windows.extend(w for _, w in subs)
            published += server.last_publish["rounds_published"]
            masked += server.last_publish["splits_masked"]
    launches = dict(build.LAUNCHES)
    rows_read = eng.io_stats.rows_read - reads0

    for i, (r, w) in enumerate(zip(results, windows)):
        if not (r.exact or r.bound <= PHI + 1e-12):
            raise Failed(f"serving answer {i}: bound {r.bound} > phi")
        if i % 5 == 0:
            truth = (eng.heatmap_oracle(w, "mean", "a0", bins=r.bins)
                     if hasattr(r, "values") else
                     eng.oracle(w, "mean", "a0"))
            if not serving_ok(r, truth, PHI):
                raise Failed(f"serving answer {i}: misses the oracle")
    log(f"{len(results)} answers: every bound <= phi or exact; every 5th "
        "contains the oracle")
    stats = {"queries": len(results), "wall_s": float(np.sum(tick_s)),
             "queries_per_s": len(results) / float(np.sum(tick_s)),
             "tick_s": tick_s, "rows_read": int(rows_read),
             "rounds_published": published, "splits_masked": masked,
             "n_tiles": int(eng.index.n_tiles)}
    for kind, cls in (("scalar", "QueryResult"),
                      ("heatmap", "HeatmapResult")):
        t = [r.eval_time_s for r in results if type(r).__name__ == cls]
        stats[f"{kind}_eval_time_s_p50"] = float(np.percentile(t, 50))
        stats[f"{kind}_eval_time_s_p99"] = float(np.percentile(t, 99))
        stats[f"{kind}_n"] = len(t)
    stats["passes"] = recorder.summary()
    log(f"serving: {json.dumps(stats)}")
    log(f"launches on the serving path: {json.dumps(launches)}")
    for k in SERVING_KERNELS:
        if launches.get(k, 0) <= 0:
            raise Failed(f"{k} was not launched on the serving path")
    log(f"device memory: allocated {torch.cuda.memory_allocated()} B, "
        f"peak {torch.cuda.max_memory_allocated()} B")
    stats["profiled_tick"] = profile_tick(torch, server, sessions,
                                          script[n_ticks])
    eng.index.check_invariants("a0")
    log("invariants hold")
    del eng, server, sessions
    torch.cuda.empty_cache()

    # batched == sequential on the card, each mode on a fresh engine
    script = b7_script(np.random.default_rng(55), 4, 3)
    for budget in (None, 1):
        got = {}
        for mode in ("batched", "sequential"):
            e = AQPEngine(ds, serving_config())
            sv = ServingEngine(e, mode=mode, crack_budget=budget)
            ses = [sv.open_session() for _ in range(4)]
            res, pubs = [], []
            for subs in script:
                submit(ses, subs)
                res.extend(sv.tick())
                pubs.append(dict(sv.last_publish))
            ix = e.index
            if mode == "batched":
                ix.check_invariants("a0")
            got[mode] = (res, pubs, ix.n_tiles, int(ix.active.sum()),
                         ix.count[:ix.n_tiles].copy(), ix.perm.clone(),
                         ix.meta_min["a0"][:ix.n_tiles].copy(),
                         ix.meta_max["a0"][:ix.n_tiles].copy())
            del e, sv, ses, ix
        serving_parity(torch, got["batched"], got["sequential"], budget)
        del got
        torch.cuda.empty_cache()
    log(f"phase 5 took {time.perf_counter() - t_phase:.3f} s")
    return launches, stats


def serving_parity(torch, a, b, budget):
    """Batched against sequential: equal index (tile table, permutation,
    extrema) and publication; equal answer fields, values within 1e-12
    relative (float64 sums in another atomic order)."""
    ra, pa, *ia = a
    rb, pb, *ib = b
    if pa != pb:
        raise Failed(f"budget {budget}: publication differs: {pa} vs {pb}")
    if not (ia[0] == ib[0] and ia[1] == ib[1]
            and np.array_equal(ia[2], ib[2]) and torch.equal(ia[3], ib[3])
            and np.array_equal(ia[4], ib[4])
            and np.array_equal(ia[5], ib[5])):
        raise Failed(f"budget {budget}: the batched index differs from the "
                     "sequential one")
    for i, (x, y) in enumerate(zip(ra, rb)):
        for f in ("exact", "tiles_full", "tiles_partial", "tiles_processed",
                  "speculative_rows", "retired_during_query"):
            if getattr(x, f) != getattr(y, f):
                raise Failed(f"budget {budget}, answer {i}: {f} differs")
        for f in ("values", "lo", "hi", "bin_bound", "value", "bound"):
            if hasattr(x, f) and not close_rel(getattr(x, f), getattr(y, f)):
                raise Failed(f"budget {budget}, answer {i}: {f} differs")
    log(f"batched == sequential (crack_budget={budget}): {len(ra)} answers, "
        f"{ia[0]} tiles, publication {pa[-1]}")


# --------------------------------------------------------------------- #
# phase 8, prediction
# --------------------------------------------------------------------- #

# rows 1, 4 and 7 across phase 8; rows 8 and 10 in 8d's batched tick
PREDICT_KERNELS = ("segment_window_agg", "segment_bin_agg_edges",
                   "segment_window_bin_select")
# B9's budget, 6 x 20 000 = 120 000 rows a step at 4e6 rows, kept at 3 %
# of the file
B9_BUDGET = 3_000_000
POLICY_EPS_ABS = 0.5        # phase 4's absolute floor


def median_us(seconds):
    return float(np.median(seconds)) * 1e6 if seconds else None


def b9_arm(torch, ds, wins, predictive, tag):
    """One arm of B9 on a fresh "cuda" engine over ``ds``, with 8a's
    gates; returns its numbers and, for the predicted arm, the
    predictor's hit-rates and sources."""
    from repro_torch.benchmarks import predictive_exploration as b9
    from repro_torch.core import AQPEngine
    from repro_torch.core.predict import prefetch_crack

    eng = AQPEngine(ds, b9.b9_config("cuda"))
    reads, evals, pre_s, spent, sources = [], [], [], 0, []
    with Counting(eng.predictor, "observe") as obs, \
            Counting(eng.predictor, "predict") as pred:
        for q, w in enumerate(wins):
            r = eng.heatmap(w, "mean", "a0", bins=b9.BINS, phi=b9.PHI)
            if not (r.exact or r.bound <= b9.PHI + 1e-12):
                raise Failed(f"8a {tag} step {q}: bound {r.bound} > phi")
            if q % 4 == 0:
                truth = eng.heatmap_oracle(w, "mean", "a0", bins=b9.BINS)
                if not heatmap_ok(r, truth, b9.PHI):
                    raise Failed(f"8a {tag} step {q}: a bin misses the "
                                 "oracle")
            reads.append(r.objects_read)
            evals.append(r.eval_time_s)
            spec = eng.adapt_stats.speculative_rows
            t = time.perf_counter()
            if predictive:
                rec = eng.prefetch(B9_BUDGET)
                sources.append(rec["source"])
            else:
                rec = prefetch_crack(eng.index, w, "a0", b9.BINS, B9_BUDGET,
                                     alpha=eng.alpha)
            torch.cuda.synchronize()
            pre_s.append(time.perf_counter() - t)
            if rec["rows_read"] > B9_BUDGET:
                raise Failed(f"8a {tag} step {q}: prefetch read "
                             f"{rec['rows_read']} rows > {B9_BUDGET}")
            if eng.adapt_stats.speculative_rows != spec:
                raise Failed(f"8a {tag} step {q}: prefetch added "
                             "speculative rows")
            spent += rec["rows_read"]
    q_reads = np.asarray(reads, np.float64)
    p50, p99 = np.percentile(q_reads[b9.WARMUP:], [50, 99])
    out = {"p50_reads": float(p50), "p99_reads": float(p99),
           "total_io": int(q_reads.sum()) + spent, "prefetch_rows": spent,
           "heatmap_eval_s_median": float(np.median(evals)),
           "prefetch_s_sum": float(np.sum(pre_s)),
           "prefetch_s_median": float(np.median(pre_s)),
           "observe_us_median": median_us(obs.each),
           "predict_us_median": median_us(pred.each),
           "n_tiles": int(eng.index.n_tiles)}
    if predictive:
        out["hit_linear"] = eng.predictor.hit_rate("linear")
        out["hit_model"] = eng.predictor.hit_rate("model")
        out["sources"] = sources
        w1 = eng.predictor._params["w1"]
        if w1.device.type != ds.x.device.type:
            raise Failed(f"8a: the predictor's weights are on {w1.device}")
    del eng
    torch.cuda.empty_cache()
    return out


def phase_b9(torch, ds, pan_steps):
    """8a: B9's two scripts and two arms at ``ds``'s scale."""
    from repro_torch.benchmarks import predictive_exploration as b9

    out = {}
    for name, wins in (("linear_pan", b9._linear_pan(pan_steps)),
                       ("random_walk", b9._random_walk(pan_steps))):
        arms = {arm: b9_arm(torch, ds, wins, arm == "predicted",
                            f"{name} {arm}")
                for arm in ("reactive", "predicted")}
        p = arms["predicted"]
        if name == "linear_pan" and not (
                p["hit_linear"] == 1.0
                and set(p["sources"][b9.WARMUP - 1:]) == {"linear"}):
            raise Failed(f"8a linear pan: sources {p['sources']}, "
                         f"hit_linear {p['hit_linear']}")
        log(f"8a {name}: {json.dumps(arms)}")
        log(f"8a {name}: p99 query-time reads, predicted "
            f"{p['p99_reads']:.0f} vs reactive "
            f"{arms['reactive']['p99_reads']:.0f} (printed, not gated); "
            f"hit_linear {p['hit_linear']}, hit_model {p['hit_model']}")
        out[name] = arms
    out["predictor_alone"] = predictor_alone(torch, b9._linear_pan(pan_steps))
    log(f"8a predictor alone on the card: "
        f"{json.dumps(out['predictor_alone'])}")
    return out


def predictor_alone(torch, wins):
    """A fresh predictor on the card observing and predicting ``wins``
    with the device idle before each call: its own host microseconds
    (the arms' ``observe`` also waits there for the query's queued
    device work, at its one synchronise)."""
    from repro_torch.core import ViewportPredictor

    p = ViewportPredictor(device="cuda")
    obs, pred = [], []
    for w in wins:
        for fn, acc in ((lambda: p.observe(w, bins=(4, 4)), obs),
                        (p.predict, pred)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            acc.append(time.perf_counter() - t)
    return {"observe_us_median": median_us(obs),
            "observe_us_max": max(obs) * 1e6,
            "predict_us_median": median_us(pred), "n_trained": p.n_trained,
            "source": p.source}


def phase_neutrality(torch, ds, n_windows=8):
    """8b: φ = 0 heatmaps of a prefetching engine against a reactive one
    on B9's linear pan: counts, minima and maxima equal, means within
    1e-12 relative (float64 sums in another atomic order), both within
    1e-9 of the oracle."""
    from repro_torch.benchmarks import predictive_exploration as b9
    from repro_torch.core import AQPEngine

    eng_p = AQPEngine(ds, b9.b9_config("cuda"))
    eng_r = AQPEngine(ds, b9.b9_config("cuda"))
    prefetched = 0
    for q, w in enumerate(b9._linear_pan(n_windows)):
        prefetched += eng_p.prefetch(B9_BUDGET)["rows_read"]
        for agg in ("mean", "count", "min", "max"):
            a = eng_p.heatmap(w, agg, "a0", bins=b9.BINS, phi=0.0)
            b = eng_r.heatmap(w, agg, "a0", bins=b9.BINS, phi=0.0)
            if not (a.exact and b.exact):
                raise Failed(f"8b window {q} {agg}: not exact")
            same = (close_rel(a.values, b.values) if agg == "mean" else
                    np.array_equal(a.values, b.values, equal_nan=True))
            if not same:
                raise Failed(f"8b window {q} {agg}: prefetch altered the "
                             "answer")
            if agg == "mean":
                truth = eng_r.heatmap_oracle(w, agg, "a0", bins=b9.BINS)
                if not (heatmap_ok(a, truth, 0.0)
                        and heatmap_ok(b, truth, 0.0)):
                    raise Failed(f"8b window {q}: misses the oracle")
    if prefetched <= 0:
        raise Failed("8b: no prefetch read a row")
    log(f"8b: {n_windows} windows x (mean, count, min, max) at phi = 0: "
        f"prefetching engine ({prefetched} rows prefetched) equals the "
        "reactive one, both equal the oracle")
    del eng_p, eng_r
    torch.cuda.empty_cache()


def dwell_salience(steps, window, bins, floor):
    """The dwell histogram of ``steps`` ((window, dwell_s) pairs) over
    ``window``'s bins, normalised into ``(floor, 1]`` — recomputed here
    from the trajectory, apart from the predictor's code."""
    bx, by = bins
    ex = np.linspace(window[0], window[2], bx + 1)
    ey = np.linspace(window[1], window[3], by + 1)
    h = np.zeros((by, bx))
    for (x0, y0, x1, y1), dwell in steps:
        fx = np.clip(np.minimum(ex[1:], x1) - np.maximum(ex[:-1], x0), 0,
                     None) / np.diff(ex)
        fy = np.clip(np.minimum(ey[1:], y1) - np.maximum(ey[:-1], y0), 0,
                     None) / np.diff(ey)
        h += dwell * np.outer(fy, fx)
    if h.max() <= 0:
        return np.ones(bx * by)
    return (floor + (1.0 - floor) * h / h.max()).reshape(-1)


def phase_learned_salience(torch, ds, n_windows=8):
    """8c: heatmaps under ``salience="learned"`` on one engine."""
    from repro_torch.benchmarks import predictive_exploration as b9
    from repro_torch.core import AccuracyPolicy, AQPEngine
    from repro_torch.core.predict import resolve_learned_salience

    eng = AQPEngine(ds, b9.b9_config("cuda"))
    pol = AccuracyPolicy(salience="learned", eps_abs=POLICY_EPS_ABS)
    steps = []
    for q, w in enumerate(b9._linear_pan(n_windows)):
        dwell = 1.0 + (q % 3)
        want = dwell_salience(steps, w, b9.BINS, pol.salience_floor)
        got = resolve_learned_salience(pol, eng.predictor, w, b9.BINS)
        if not np.allclose(got.salience, want, rtol=1e-12, atol=0.0):
            raise Failed(f"8c window {q}: the resolved map differs from "
                         "the host's")
        r = eng.heatmap(w, "mean", "a0", bins=b9.BINS, phi=b9.PHI,
                        policy=pol, dwell_s=dwell)
        truth = eng.heatmap_oracle(w, "mean", "a0", bins=b9.BINS)
        fin = np.isfinite(truth)
        tol = 1e-9 * np.maximum(np.abs(truth[fin]), 1.0)
        if not (r.bin_met.all() and r.speculative_rows == 0
                and np.array_equal(r.phi_b, got.phi_b(b9.PHI, b9.BINS))
                and (r.lo[fin] - tol <= truth[fin]).all()
                and (truth[fin] <= r.hi[fin] + tol).all()):
            raise Failed(f"8c window {q}: a bin misses its budget or the "
                         "oracle, or rows were speculative")
        steps.append((w, dwell))
    log(f"8c: {n_windows} learned-salience heatmaps: every bin met its "
        f"budget (eps_abs {POLICY_EPS_ABS}), zero speculative rows, the "
        "resolved map equals the host's")
    del eng
    torch.cuda.empty_cache()


def pan_sessions(n_sessions, n_ticks, size=0.2 * DOMAIN):
    """Per tick, per session: (kind, window) — session i pans linearly
    from its own corner, a ``mean(a0)`` query and a 4x4 heatmap in
    turns."""
    ticks = []
    for t in range(n_ticks):
        subs = []
        for i in range(n_sessions):
            x0 = 0.1 * DOMAIN + 0.2 * DOMAIN * i + 0.03 * DOMAIN * t
            y0 = 0.1 * DOMAIN + 0.15 * DOMAIN * (i % 2) + 0.04 * DOMAIN * t
            subs.append(("heatmap" if (t + i) % 2 else "query",
                         (x0, y0, x0 + size, y0 + size)))
        ticks.append(subs)
    return ticks


def phase_serving_prefetch(torch, build, ds, n_sessions=4, n_ticks=3):
    """8d: the serving tick with ``prefetch_rows`` on fresh engines,
    batched against sequential; rows 8 and 10 must launch."""
    from repro_torch.core import AQPEngine, ServingEngine

    script = pan_sessions(n_sessions, n_ticks)
    got, prefetches = {}, {}
    before = dict(build.LAUNCHES)
    for mode in ("batched", "sequential"):
        e = AQPEngine(ds, serving_config())
        sv = ServingEngine(e, mode=mode, crack_budget=6,
                           prefetch_rows=B9_BUDGET)
        ses = [sv.open_session(f"s{i}") for i in range(n_sessions)]
        res, pubs, recs = [], [], []
        for subs in script:
            submit(ses, subs)
            rs = sv.tick()
            for i, (r, (kind, w)) in enumerate(zip(rs, subs)):
                truth = (e.heatmap_oracle(w, "mean", "a0", bins=(4, 4))
                         if kind == "heatmap" else e.oracle(w, "mean", "a0"))
                if not ((r.exact or r.bound <= PHI + 1e-12)
                        and serving_ok(r, truth, PHI)):
                    raise Failed(f"8d {mode}: answer {i} misses phi or "
                                 "its oracle")
            res.extend(rs)
            pubs.append(dict(sv.last_publish))
            recs.append([dict(p) for p in sv.last_prefetch])
        ix = e.index
        got[mode] = (res, pubs, ix.n_tiles, int(ix.active.sum()),
                     ix.count[:ix.n_tiles].copy(), ix.perm.clone(),
                     ix.meta_min["a0"][:ix.n_tiles].copy(),
                     ix.meta_max["a0"][:ix.n_tiles].copy(), ix)
        prefetches[mode] = recs
        if mode == "batched":
            launched = {k: build.LAUNCHES.get(k, 0) - before.get(k, 0)
                        for k in SERVING_KERNELS}
        del sv, ses
    if prefetches["batched"] != prefetches["sequential"]:
        raise Failed("8d: the prefetch records differ between modes")
    bad = same_tile_index(torch, got["batched"][-1], got["sequential"][-1])
    if bad is not None:
        raise Failed(f"8d: the batched index differs: {bad}")
    serving_parity(torch, got["batched"][:-1], got["sequential"][:-1],
                   "6, prefetch_rows 3e6")
    rows = [p["rows_read"] for recs in prefetches["batched"] for p in recs]
    log(f"8d: prefetch records per tick {json.dumps(prefetches['batched'])}")
    if not rows or max(rows) <= 0:
        raise Failed("8d: no prefetch read a row")
    log(f"8d launches of the batched ticks: {json.dumps(launched)}")
    for k in SERVING_KERNELS:
        if launched[k] <= 0:
            raise Failed(f"{k} was not launched in 8d")
    del got
    torch.cuda.empty_cache()
    return {"prefetches": len(rows), "prefetch_rows": int(sum(rows))}


def phase_prediction(torch, build, ds, pan_steps):
    """Phase 8 on phase 3's dataset: 8a-8d; the launches of the phase."""
    log(f"== phase 8: prediction, {ds.n} rows, B9 at {pan_steps} steps a "
        f"script, budget {B9_BUDGET} rows a step")
    t_phase = time.perf_counter()
    build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    b9 = phase_b9(torch, ds, pan_steps)
    phase_neutrality(torch, ds)
    phase_learned_salience(torch, ds)
    serving = phase_serving_prefetch(torch, build, ds)
    launches = dict(build.LAUNCHES)
    log(f"launches in phase 8: {json.dumps(launches)}")
    for k in PREDICT_KERNELS:
        if launches.get(k, 0) <= 0:
            raise Failed(f"{k} was not launched in phase 8")
    wall = time.perf_counter() - t_phase
    log(f"phase 8 took {wall:.3f} s, device memory peak "
        f"{torch.cuda.max_memory_allocated()} B, on {card_line()}")
    return {"b9": b9, "serving": serving, "launches": launches,
            "wall_s": wall}


# --------------------------------------------------------------------- #
# phase 7, chunked storage
# --------------------------------------------------------------------- #

# rows 1, 2, 4, 7, 8 and 10: the kernels the chunked path must launch
CHUNK_KERNELS = ("segment_window_agg", "segment_bin_agg",
                 "segment_bin_agg_edges", "segment_window_bin_select",
                 "segment_window_agg_multi", "segment_window_bin_select_multi")
# B8's workload (benchmarks/streaming_exploration.py:49-137)
N_CHUNKS = 30
LIVE_CAP = 3
QUERIES_PER_STEP = 2
MEM_MARGIN = 64 << 20       # fixed allowance over planes and forests, B


def b8_config():
    from repro_torch.core import IndexConfig
    return IndexConfig(grid0=(8, 8), min_split_count=512,
                       init_metadata_attrs=("a0",))


def recent_window(rng, hi_slab_edge, width_slabs=2.0):
    """B8's query window over the most recent ``width_slabs`` slabs."""
    slab = DOMAIN / N_CHUNKS
    x1 = rng.uniform(hi_slab_edge - 0.3 * slab, hi_slab_edge)
    x0 = max(0.0, x1 - rng.uniform(0.8, width_slabs) * slab)
    y0 = rng.uniform(0.0, 0.5) * DOMAIN
    y1 = y0 + rng.uniform(0.3, 0.5) * DOMAIN
    return (float(x0), float(y0), float(x1), float(y1))


def close_rel(u, v):
    """Equal infinities and NaN positions; finite values within 1e-12
    relative (float64 sums in another atomic order)."""
    u = np.atleast_1d(np.asarray(u, np.float64))
    v = np.atleast_1d(np.asarray(v, np.float64))
    fin = np.isfinite(u)
    return bool(u.shape == v.shape and np.array_equal(fin, np.isfinite(v))
                and np.array_equal(np.isnan(u), np.isnan(v))
                and (u[~fin & ~np.isnan(u)] == v[~fin & ~np.isnan(v)]).all()
                and (np.abs(u[fin] - v[fin]) <= 1e-12 * np.abs(v[fin])).all())


def same_answer(x, y):
    """Exact count-like fields; float64 values within 1e-12 relative."""
    for f in ("exact", "tiles_full", "tiles_partial", "tiles_processed",
              "objects_read", "read_calls", "batch_rounds",
              "speculative_rows", "retired_during_query"):
        if getattr(x, f) != getattr(y, f):
            return f
    for f in ("value", "lo", "hi", "bound", "values", "bin_bound"):
        if hasattr(x, f) and not close_rel(getattr(x, f), getattr(y, f)):
            return f
    return None


def same_tile_index(torch, a, b):
    """Tile table, permutation and extrema equal; sums within 1e-12."""
    n = a.n_tiles
    if b.n_tiles != n or not torch.equal(a.perm, b.perm):
        return "n_tiles or perm"
    for k in ("bbox", "offset", "count", "active", "level", "parent"):
        if not np.array_equal(getattr(a, k)[:n], getattr(b, k)[:n]):
            return k
    for k in ("meta_min", "meta_max", "meta_valid"):
        if not np.array_equal(getattr(a, k)["a0"][:n],
                              getattr(b, k)["a0"][:n]):
            return k
    if not close_rel(a.meta_sum["a0"][:n], b.meta_sum["a0"][:n]):
        return "meta_sum"
    return None


class Counting:
    """While active, wraps ``owner.name`` (a method or a module function):
    counts its calls, through ``composite(args)`` the composite ones
    among them (``args`` past the first), and its host seconds, in all
    and each (outermost calls only)."""

    def __init__(self, owner, name, composite=lambda a: False):
        self.owner, self.name, self.composite = owner, name, composite
        self.calls = self.composites = 0
        self.seconds = 0.0
        self.each = []
        self._depth = 0

    def __enter__(self):
        self.orig = getattr(self.owner, self.name)

        def f(*a, **kw):
            self.calls += 1
            self.composites += bool(self.composite(a[1:]))
            self._depth += 1
            t = time.perf_counter()
            try:
                return self.orig(*a, **kw)
            finally:
                self._depth -= 1
                if not self._depth:
                    self.each.append(time.perf_counter() - t)
                    self.seconds += self.each[-1]
        setattr(self.owner, self.name, f)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)


def phase_chunked_legacy(torch, ds, windows):
    """7a: a single chunk wrapping phase 3's dataset (its planes, not a
    copy) against a fresh legacy engine, both "cuda"."""
    from repro_torch.core import AQPEngine, IndexConfig
    from repro_torch.data import ChunkedDataset

    wins = windows[:10]
    log(f"== phase 7a: one chunk over phase 3's {ds.n} rows against the "
        f"legacy engine, {len(wins)} windows")
    t0 = time.perf_counter()
    cds = ChunkedDataset.from_dataset(ds)
    if cds.chunk(0).data is not ds:
        raise Failed("from_dataset copied the dataset")
    legacy = AQPEngine(ds, IndexConfig(init_metadata_attrs=("a0",)))
    chunked = AQPEngine(cds, IndexConfig(init_metadata_attrs=("a0",)))
    n = 0
    for q, w in enumerate(wins):
        for kind, call in (
                ("query", lambda e: e.query(w, "mean", "a0", phi=0.05)),
                ("heatmap", lambda e: e.heatmap(w, "mean", "a0",
                                                bins=(8, 8), phi=0.05))):
            a, b = call(legacy), call(chunked)
            bad = same_answer(a, b)
            if bad is not None or b.pruned_chunks != 0:
                raise Failed(f"7a {kind} {q}: {bad} differs from the "
                             "legacy engine")
            n += 1
    bad = same_tile_index(torch, legacy.index, chunked.index._indexes[0])
    if bad is not None:
        raise Failed(f"7a: the chunk's index differs from the legacy "
                     f"one: {bad}")
    chunked.index.check_invariants("a0")
    log(f"7a: {n} answers equal the legacy engine's (reads, read calls, "
        f"rounds, tiles; values within 1e-12), same index "
        f"({legacy.index.n_tiles} tiles, perm equal) in "
        f"{time.perf_counter() - t0:.3f} s")


def chunk_bytes(cds, forests):
    """Device bytes the live chunks' planes (x, y and the value columns,
    float32) and the built forests (perm int64, x_s and y_s float32)
    hold."""
    planes = sum(c.n * 4 * (2 + len(c.data.attributes))
                 for c in cds.chunks())
    return planes + sum(ti.ds.n * 16 for ti in forests)


def phase_streaming(torch, src):
    """7b: B8's streaming session over device chunks, with its gates
    and the device memory bound; the last ingest step runs under
    ``torch.profiler``. Returns the numbers and the live chunks' source
    arrays."""
    from repro_torch.core import AQPEngine, ChunkIndexSet
    from repro_torch.core import query as query_mod
    from repro_torch.core.index import _chunk_overlaps
    from repro_torch.data import ChunkedDataset
    from torch.profiler import ProfilerActivity, profile

    log(f"== phase 7b: B8's streaming session, {len(src)} chunks of "
        f"{len(src[0][0])} rows, {LIVE_CAP} live")
    slab = DOMAIN / N_CHUNKS
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cds = ChunkedDataset(device="cuda")
    eng = AQPEngine(cds, b8_config())
    rng = np.random.default_rng(5)
    peak_live_rows = violations = prune_leaks = lazy_faults = 0
    ever = set()                  # chunk ids some query's window overlapped
    mem = []                      # (allocated - base, bound) per query

    def step(i, x, y, cols):
        """Ingest, retire down to LIVE_CAP, and B8's queries of one step
        (the oracles come after)."""
        nonlocal peak_live_rows
        cds.ingest(x, y, cols)
        while cds.n_chunks > LIVE_CAP:
            cds.retire(cds.live_ids[0])
        peak_live_rows = max(peak_live_rows, cds.n)
        out = []
        for _ in range(QUERIES_PER_STEP):
            w = recent_window(rng, (i + 1) * slab)
            snaps = {c.chunk_id: c.stats.snapshot() for c in cds.chunks()}
            r = eng.query(w, "mean", "a0", phi=PHI)
            # after the query's prepare: retired forests are dropped
            mem.append((torch.cuda.memory_allocated() - base,
                        chunk_bytes(cds, eng.index._indexes.values())
                        + MEM_MARGIN))
            gates(w, snaps)
            out.append((w, r, eng.heatmap(w, "sum", "a0", bins=(4, 4),
                                          phi=PHI)))
        return out

    def gates(w, snaps):
        """B8's prune purity across one query, and lazy building: the
        init pass paid once, on the first overlapping query, and by no
        other chunk."""
        nonlocal prune_leaks, lazy_faults
        for c in cds.chunks():
            d = c.stats.delta(snaps[c.chunk_id])
            if d.pruned_calls > 0 and (d.rows_read or d.read_calls
                                       or d.init_rows):
                prune_leaks += 1
            if _chunk_overlaps(c.bbox, w):
                ever.add(c.chunk_id)
            if c.stats.init_rows != (c.n if c.chunk_id in ever else 0):
                lazy_faults += 1
        built = eng.index.built_ids()
        if len(built) > cds.n_chunks or not set(built) <= set(
                cds.live_ids):
            lazy_faults += 1

    q_times, h_times = [], []
    runs = Counting(ChunkIndexSet, "_read_batch_runs", lambda a: len(
        np.unique(np.asarray(a[0]) // eng.index._stride)) > 1)
    # the host's layers of a query: the forest's housekeeping and lazy
    # builds, the accumulator build (classification, axis counts), the
    # rounds' reads with their kernel passes and copies, their applies
    layers = {"prepare": Counting(ChunkIndexSet, "prepare"),
              "build": Counting(query_mod, "_build_accumulator"),
              "build_grouped": Counting(query_mod,
                                        "_build_grouped_accumulator"),
              "read": runs, "apply": Counting(ChunkIndexSet, "apply_batch")}
    with contextlib.ExitStack() as stack:
        for c in layers.values():
            stack.enter_context(c)
        for i, (x, y, cols) in enumerate(src):
            if i < len(src) - 1:
                done = step(i, x, y, cols)
            else:
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t = time.perf_counter()
                    done = step(i, x, y, cols)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t
            for w, r, h in done:
                truth = eng.oracle(w, "mean", "a0")
                if np.isfinite(truth) and not (r.lo - 1e-3 <= truth
                                               <= r.hi + 1e-3):
                    violations += 1
                ht = eng.heatmap_oracle(w, "sum", "a0", bins=(4, 4))
                fin = np.isfinite(ht)
                if not ((h.lo[fin] - 1e-2 <= ht[fin]).all()
                        and (ht[fin] <= h.hi[fin] + 1e-2).all()):
                    violations += 1
                q_times.append(r.eval_time_s)
                h_times.append(h.eval_time_s)
    eng.index.check_invariants("a0")
    tot = eng.trace.totals()
    dev = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us > 0:
            dev[e.key] = us * 1e-6
    busy = sum(dev.values())
    used = np.array(mem, np.int64)
    worst = int(np.argmax(used[:, 0] - used[:, 1]))
    out = {"steps": len(src), "chunk_rows": len(src[0][0]),
           "rows_streamed": sum(len(s[0]) for s in src),
           "peak_live_rows": peak_live_rows,
           "live": cds.n_chunks, "built": len(eng.index.built_ids()),
           "violations": violations, "prune_leaks": prune_leaks,
           "lazy_faults": lazy_faults,
           "queries": len(q_times), "heatmaps": len(h_times),
           "query_eval_s_median": float(np.median(q_times)),
           "heatmap_eval_s_median": float(np.median(h_times)),
           "query_eval_s_sum": float(np.sum(q_times)),
           "heatmap_eval_s_sum": float(np.sum(h_times)),
           "rounds": tot["total_batch_rounds"],
           "read_calls": tot["total_read_calls"],
           "read_calls_per_round": tot["total_read_calls"]
           / max(tot["total_batch_rounds"], 1),
           "host_s": {k: c.seconds for k, c in layers.items()},
           "driver_rounds": runs.calls,
           "composite_rounds": runs.composites,
           "composite_share": runs.composites / max(runs.calls, 1),
           "objects_read": tot["total_objects_read"],
           "pruned_chunks": tot["total_pruned_chunks"],
           "init_rows": cds.stats.init_rows,
           "mem_allocated_peak_B": int(used[:, 0].max()),
           "mem_bound_at_peak_B": int(used[np.argmax(used[:, 0]), 1]),
           "mem_closest_B": [int(used[worst, 0]), int(used[worst, 1])],
           "mem_margin_B": MEM_MARGIN,
           "max_allocated_B": torch.cuda.max_memory_allocated() - base,
           "profiled_step": {
               "wall_s": wall, "device_busy_s": busy if dev else None,
               "device_idle_share": 1.0 - busy / wall if dev else None,
               "top_device_s": [(k[:60], v) for k, v in sorted(
                   dev.items(), key=lambda kv: -kv[1])[:6]]}}
    log(f"7b: {json.dumps(out)}")
    if violations or prune_leaks or lazy_faults:
        raise Failed(f"7b gates: violations={violations} prune_leaks="
                     f"{prune_leaks} lazy_faults={lazy_faults}")
    if (used[:, 0] > used[:, 1]).any():
        raise Failed(f"7b: device memory over its bound at query {worst}: "
                     f"{used[worst].tolist()}")
    log(f"7b gates: violations == 0, prune_leaks == 0, built "
        f"{out['built']} <= live {out['live']}, every chunk's init pass on "
        f"its first overlapping query; device memory after each query's "
        f"prepare at most {out['mem_allocated_peak_B']} B over the phase's "
        f"start, within live planes + forests + {MEM_MARGIN} B (closest: "
        f"{out['mem_closest_B']})")
    live = [src[cid] for cid in cds.live_ids]
    return out, live


def straddling(rng, edges, ticks, n_sessions=4):
    """Per tick, per session: a mean(a0) query and a 4x4 heatmap over a
    window across one of ``edges`` (the x where one live chunk ends and
    the next begins); sessions 0 and 1 across the first edge. The last
    tick asks phi = 0, so every pending tile is read."""
    slab = DOMAIN / N_CHUNKS
    out = []
    for t in range(ticks):
        subs = []
        for s in range(n_sessions):
            e = edges[0 if s < 2 else -1]
            x0 = e - rng.uniform(0.1, 0.5) * slab
            x1 = e + rng.uniform(0.1, 0.5) * slab
            y0 = rng.uniform(0.0, 0.6) * DOMAIN
            win = (float(x0), float(y0), float(x1),
                   float(y0 + rng.uniform(0.2, 0.4) * DOMAIN))
            subs.append((win, PHI if t < ticks - 1 else 0.0))
        out.append(subs)
    return out


def forest_state(torch, ix):
    """The forest's built indexes joined, in build order, as phase 5's
    equivalence check reads one index."""
    tis = list(ix._indexes.values())
    cat = lambda k: np.concatenate(  # noqa: E731
        [getattr(t, k)[:t.n_tiles] for t in tis])
    return (sum(t.n_tiles for t in tis),
            int(sum(t.active[:t.n_tiles].sum() for t in tis)),
            cat("count"), torch.cat([t.perm for t in tis]),
            np.concatenate([t.meta_min["a0"][:t.n_tiles] for t in tis]),
            np.concatenate([t.meta_max["a0"][:t.n_tiles] for t in tis]))


def phase_chunked_serving(torch, live, n_ticks=3, n_sessions=4):
    """7c: the serving tick over 7b's live chunks, batched against
    sequential, each on a fresh engine over fresh device chunks; the
    oldest chunk's storage goes before the last tick (retired during the
    query)."""
    from repro_torch.core import AQPEngine, ServingEngine
    from repro_torch.core import serving as serving_mod
    from repro_torch.data import ChunkedDataset

    log(f"== phase 7c: serving tick over {len(live)} chunks, {n_sessions} "
        f"sessions x {n_ticks} ticks across chunk edges")
    got, stats, script = {}, {}, None
    for mode in ("batched", "sequential"):
        cds = ChunkedDataset(device="cuda")
        for x, y, cols in live:
            cds.ingest(x, y, cols)
        if script is None:
            edges = [c.bbox[0] for c in cds.chunks()[1:]]
            script = straddling(np.random.default_rng(77), edges, n_ticks,
                                n_sessions)
        sv = ServingEngine(AQPEngine(cds, b8_config()), mode=mode)
        ses = [sv.open_session() for _ in range(n_sessions)]
        res, pubs, tick_s = [], [], []
        folds = Counting(serving_mod._QueryRun, "fold",
                         lambda a: len(a[2].get("runs") or ()) > 1)
        with folds:
            for t, subs in enumerate(script):
                if t == n_ticks - 1:
                    # the oldest chunk's storage goes while its forest is
                    # still listed: the tick's reads of it degrade
                    cds.chunk(cds.live_ids[0]).data.close()
                for s, (win, phi) in zip(ses, subs):
                    s.query(win, "mean", "a0", phi=phi)
                    s.heatmap(win, "mean", "a0", bins=(4, 4), phi=phi)
                t0 = time.perf_counter()
                rs = sv.tick()
                torch.cuda.synchronize()
                tick_s.append(time.perf_counter() - t0)
                res.extend(rs)
                pubs.append(dict(sv.last_publish))
                if t == n_ticks - 1:
                    continue
                for i, r in enumerate(rs):
                    win, phi = subs[i // 2]
                    truth = (sv.engine.heatmap_oracle(win, "mean", "a0",
                                                      bins=(4, 4))
                             if hasattr(r, "values") else
                             sv.engine.oracle(win, "mean", "a0"))
                    if not ((r.exact or r.bound <= phi + 1e-12)
                            and serving_ok(r, truth, phi)):
                        raise Failed(f"7c {mode} tick {t}: answer {i} "
                                     "misses its oracle")
        degraded = [r.retired_during_query for r in rs]
        want = [True] * 4 + [False] * (2 * n_sessions - 4)
        if degraded != want:
            raise Failed(f"7c {mode}: retired_during_query {degraded}")
        ix = sv.engine.index
        ix.check_invariants("a0")
        got[mode] = (res, pubs) + forest_state(torch, ix)
        n_rounds = sum(r.batch_rounds for r in res)
        stats[mode] = {"tickets": len(res), "wall_s": float(np.sum(tick_s)),
                       "queries_per_s": len(res) / float(np.sum(tick_s)),
                       "tick_s": tick_s, "query_rounds": folds.calls,
                       "composite_rounds": folds.composites,
                       "composite_share": folds.composites
                       / max(folds.calls, 1),
                       "read_calls": int(sum(r.read_calls for r in res)),
                       "read_calls_per_round": sum(r.read_calls for r in res)
                       / max(n_rounds, 1),
                       "degraded": int(sum(degraded))}
        cds.retire(cds.live_ids[0])
        del sv, ses, ix, cds
        torch.cuda.empty_cache()
    log(f"7c: {json.dumps(stats)}")
    if stats["batched"]["composite_rounds"] <= 0:
        raise Failed("7c: no composite round in the batched tick")
    serving_parity(torch, got["batched"], got["sequential"], None)
    return stats


def phase_chunked(torch, build, chunk_rows, t_phase):
    """Phase 7 after 7a: B8's chunks at ``chunk_rows`` rows each, 7b and
    7c; the launches of the whole phase (counted since 7a)."""
    from repro_torch.data import make_streaming_chunks

    t0 = time.perf_counter()
    src = make_streaming_chunks(n_chunks=N_CHUNKS, rows_per_chunk=chunk_rows,
                                n_columns=2, domain=DOMAIN, seed=31)
    log(f"7b data: {N_CHUNKS} chunks x {chunk_rows} rows x (x, y, a0, a1) "
        f"made on the host in {time.perf_counter() - t0:.3f} s")
    stream, live = phase_streaming(torch, src)
    del src
    serving = phase_chunked_serving(torch, live)
    launches = dict(build.LAUNCHES)
    log(f"launches in phase 7: {json.dumps(launches)}")
    for k in CHUNK_KERNELS:
        if launches.get(k, 0) <= 0:
            raise Failed(f"{k} was not launched in phase 7")
    wall = time.perf_counter() - t_phase
    log(f"phase 7 took {wall:.3f} s on {card_line()}")
    return {"streaming": stream, "serving": serving, "launches": launches,
            "wall_s": wall}


class PlainGuard:
    """While active, counts every call of a plain ``*_torch`` kernel
    version: each such function of the kernel modules, and each name
    ``ops`` or another kernel module bound to one, is wrapped with a
    counter. The card's path (``backend="cuda"``) must call none."""

    def __init__(self):
        from repro_torch.kernels import (bin_agg, fused_select, ops,
                                         segment_agg, window_agg)
        self.modules = (segment_agg, fused_select, bin_agg, window_agg, ops)
        self.calls = {}

    def _counted(self, name, fn):
        calls = self.calls

        def f(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return f

    def __enter__(self):
        self.saved = []
        for m in self.modules:
            for name, fn in list(vars(m).items()):
                if name.endswith("_torch") and callable(fn):
                    self.saved.append((m, name, fn))
                    setattr(m, name, self._counted(name, fn))
        return self

    def __exit__(self, *exc):
        for m, name, fn in self.saved:
            setattr(m, name, fn)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=100_000_000)
    ap.add_argument("--queries", type=int, default=50)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--ticks", type=int, default=10)
    ap.add_argument("--chunk-rows", type=int, default=3_333_334,
                    help="rows per chunk of phase 7b (B8's 30 chunks: "
                    "10^8 rows at the default)")
    ap.add_argument("--pan-steps", type=int, default=24,
                    help="steps a script of phase 8a (B9's full size: 50)")
    ap.add_argument("--clocks-of", metavar="TREE",
                    help="only build the port under TREE/src and print "
                    "phase 2b's three clocks of rows 1-10 (to time "
                    "a parent tree and this one in turns in one call)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    tree = HERE if args.clocks_of is None else os.path.abspath(args.clocks_of)
    sys.path.insert(0, os.path.join(tree, "src"))
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    try:
        phase_card_and_build(torch, build)
        timed = make_timer(torch, args.reps)
        shapes = kernel_shapes(torch, args.seed)
        if args.clocks_of is not None:
            log(f"== phase 2b clocks of {tree}")
            clocks = row_clocks(torch, timed, shapes, enforce=False)
            print(json.dumps({"clocks_of": tree, "clocks": {
                k: {f: v for f, v in c.items() if f != "plain"}
                for k, c in clocks.items()}}))
            return 0
        errs = phase_kernels(torch, timed, args.seed)
        errs.update(phase_heatmap_kernels(torch, shapes, args.seed))
        phase_serving_kernels(torch, timed, args.seed)
        rows = phase_clocks(torch, timed, shapes, errs)
        del shapes
        rows.update(phase_window_agg(torch, timed, build, args.seed))
        torch.cuda.empty_cache()
        from repro_torch.data import exploration_path
        log("== dataset for phases 3 and 4")
        ds = make_dataset(torch, args.seed, args.rows)
        phase_scan(torch, timed, ds)
        windows = exploration_path(ds, n_queries=args.queries,
                                   target_objects=100_000, seed=11)
        with PlainGuard() as guard:
            launches = phase_main_path(torch, build, ds, windows)
            torch.cuda.empty_cache()
            launches.update({k: v for k, v in phase_heatmap_path(
                torch, build, ds, windows).items() if k in HEATMAP_KERNELS})
            torch.cuda.empty_cache()
            serving_launches, stats = phase_serving(torch, build, ds,
                                                    args.ticks)
            torch.cuda.empty_cache()
            launches8 = phase_prediction(torch, build, ds,
                                         args.pan_steps)["launches"]
            t7 = time.perf_counter()
            build.reset_launches()
            phase_chunked_legacy(torch, ds, windows)
            del ds
            torch.cuda.empty_cache()
            phase_chunked(torch, build, args.chunk_rows, t7)
        log(f"plain kernel versions called in phases 3-5, 7 and 8: "
            f"{json.dumps(guard.calls)}")
        if guard.calls:
            raise Failed("the card's path called a plain kernel version: "
                         f"{guard.calls}")
        launches.update({k: v for k, v in serving_launches.items()
                         if k in SERVING_KERNELS})
        rows.update(time_serving_kernels(torch, timed, args.seed,
                                         stats["passes"]))
        launches["window_agg"] = phase_bench(torch, build)["window_agg"]
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    for name, row in rows.items():
        row["launches"] = int(launches.get(name, 0))
        row["launches_phase8"] = int(launches8.get(name, 0))
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
