#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py [--seed 0] [--rows 100000000] [--queries 50]
                          [--ticks 10]

Phases (each prints its own lines; any failure exits non-zero):

1. Card and build: the card's name and power limit (``nvidia-smi``),
   torch/CUDA versions, and the kernels built from ``src/repro_torch/
   kernels/csrc`` (one ``nvcc`` per source, in parallel).
2. Kernels against their plain PyTorch versions, on the card: the main
   path's shapes (8 segments of ~4e5 objects, 2x2 split cells), a stress
   shape (64 segments, 1.6e7 objects, 4x4 cells) and edge cases; counts
   and extrema must be equal, float64 sums within 1e-12 * sum|v| per
   cell; a host sample is also held against the float64 numpy mirrors.
   Median times from CUDA events beside each kernel's bound.
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

Phase 2 also holds the heatmap kernels (``segment_bin_agg_edges``,
``segment_window_bin_agg``, ``segment_window_bin_select``) against their
plain versions — the select op's suffix widths bit for bit — on edge
cases, a table too large for shared memory, a host sample against the
numpy mirrors, and at the heatmap path's shapes: 8 segments of ~3.9e5
objects, 8x8 bins, 4x4 split cells for the batched ops, and one tile of
~3.9e5 objects (1e8 / 256, the initial grid's mean tile) for
``segment_window_bin_agg``, which the path launches only from
``process_heatmap`` with S = 1. Phase 2c holds the serving tick's
kernels (``segment_window_agg_multi``, ``segment_window_bin_agg_multi``,
``segment_window_bin_select_multi``: one window per segment, suffix
widths per query span) against their plain versions on edge cases and a
host sample; after phase 5 it checks and times them at the median
shapes of phase 5's passes. Phase 2d holds ``window_agg`` and
``window_count`` against their plain versions on edge cases (n = 0, 1,
3 and 4097; an unaligned view with n short of the planes; +-inf, empty
and zero-area windows; objects on the window's edges and their float32
neighbours), checks that views cut at different offsets raise, holds a
host sample against the numpy mirror, and times ``window_agg`` on one
390 625-object tile and on B3's data (n = 1e6, B3's window), the shape
at which phase 6 launches it.

Right after the dataset is made, the paper-scale scan runs
``window_agg`` and ``window_count`` over the whole file (x, y, a0 on the
card) under B3's window and an all-covering one, each held against its
plain version and timed beside its byte bound.

6. The port's kernels bench (``repro_torch.benchmarks.kernels_bench``,
   B3) at its full size on the card, its rows printed; launch counts are
   reset before it, and ``window_agg`` must have launched in it.

The line before the last is a JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
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
    within ``SUM_RTOL * sum|v|``. Returns the largest absolute
    difference over all channels (equal infinities count 0)."""
    g = np.asarray(got, np.float64).reshape(-1, 4)
    w = np.asarray(want, np.float64).reshape(-1, 4)
    a = np.asarray(abs_sum, np.float64).reshape(-1)
    if g.shape != w.shape:
        raise Failed(f"{what}: shape {g.shape} != {w.shape}")
    if not np.array_equal(g[:, 0], w[:, 0]):
        raise Failed(f"{what}: counts differ")
    if not ((g[:, 2] == w[:, 2]).all() and (g[:, 3] == w[:, 3]).all()):
        raise Failed(f"{what}: extrema differ")
    d = np.abs(g[:, 1] - w[:, 1])
    if not (d <= SUM_RTOL * a).all():
        raise Failed(f"{what}: sums differ by {d.max()} (tol "
                     f"{SUM_RTOL} * sum|v|)")
    with np.errstate(invalid="ignore"):
        diff = np.where(g == w, 0.0, np.abs(g - w))
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

def phase_card_and_build(torch, build):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
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
    neighbours of window edges, negative values."""
    xs, ys, vals, b, bb = segments(torch, gen, 8, 3000)
    cases = []
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
    return cases


def phase_kernels(torch, timed, seed):
    from repro_torch.kernels import bin_agg as ba
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import segment_agg as sa

    log("== phase 2: kernels against their plain versions")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    rows = {}

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
    L = int(b[-1])
    cx, cy = 0.5 * (bb[:, 0] + bb[:, 2]).mean(), 0.5 * (bb[:, 1] +
                                                        bb[:, 3]).mean()
    window = (float(cx - 150), float(cy - 150), float(cx + 150),
              float(cy + 150))
    err_swa = check_swa("main", xs, ys, vals, b, window)
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

    # --- stress: 64 segments, 1.6e7 objects, 4x4
    sx, sy, sv, sbnd, sbb = segments(torch, gen, 64, 250_000)
    check_swa("stress", sx, sy, sv, sbnd, (100.0, 100.0, 800.0, 800.0))
    check_sba("stress,4x4", sx, sy, sv, sbnd, sbb, 4)
    t_s = timed(lambda: sa.segment_bin_agg_cuda(sx, sy, sv, sbnd, sbb, 4, 4))
    t_p = timed(lambda: sa.segment_bin_agg_torch(sx, sy, sv, sbnd, sbb,
                                                 4, 4))
    log(f"stress segment_bin_agg (64 x 250000, 4x4): kernel {t_s:.4f} ms, "
        f"plain {t_p:.4f} ms, bound "
        f"{bound_ms(12 * int(sbnd[-1]), 0, 5 * int(sbnd[-1]))[0]:.4f} ms")
    del sx, sy, sv

    # --- times at the main path's shapes
    n_in = int(ops.window_mask(xs, ys, window).sum())
    specs = {
        "segment_window_agg": (
            lambda: sa.segment_window_agg_cuda(xs, ys, vals, b, window),
            lambda: sa.segment_window_agg_torch(xs, ys, vals, b, window),
            bound_ms(8 * L + 4 * n_in + 32 * 8, 4 * L + 2 * n_in, n_in),
            err_swa, "src/repro_torch/kernels/csrc/segment_window_agg.cu",
            "src/repro/kernels/segment_agg.py:154"),
        "segment_bin_agg": (
            lambda: sa.segment_bin_agg_cuda(xs, ys, vals, b, bb, 2, 2),
            lambda: sa.segment_bin_agg_torch(xs, ys, vals, b, bb, 2, 2),
            bound_ms(12 * L + 32 * 8 * 4, 2 * L, 5 * L),
            err_sba, "src/repro_torch/kernels/csrc/segment_bin_agg.cu",
            "src/repro/kernels/segment_agg.py:524"),
        "bin_agg": (
            lambda: ba.bin_agg_cuda(xs1, ys1, vals1, bb[0], 2, 2),
            lambda: ba.bin_agg_torch(xs1, ys1, vals1, bb[0], 2, 2),
            bound_ms(12 * seg_rows + 32 * 4, 2 * seg_rows, 5 * seg_rows),
            err_ba, "src/repro_torch/kernels/csrc/segment_bin_agg.cu",
            "src/repro/kernels/bin_agg.py:89"),
    }
    for name, (kern, plain, (bms, by), err, src, rep) in specs.items():
        ms, pms = timed(kern), timed(plain)
        rows[name] = {"name": name, "route": "cuda", "source": src,
                      "replaces": rep, "launches": 0, "max_abs_err": err,
                      "ms": ms, "plain_ms": pms, "bound_ms": bms,
                      "bound_by": by, "library_ms": None}
        log(f"{name}: kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
            f"{bms:.4f} ms ({by}), max_abs_err {err:.3e}")
    return rows


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


def phase_heatmap_kernels(torch, timed, seed):
    from repro_torch.kernels import fused_select as fs
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_agg as sa

    log("== phase 2b: heatmap kernels against their plain versions")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 1)
    rng = np.random.default_rng(seed + 1)
    rows = {}

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
    check_all("S=1", xs, ys, vals, b[[0, -1]], bb[:1], w, bins)
    xs, ys, vals, b, bb = segments(torch, gen, 32, 2000)
    w32 = (200.0, 200.0, 700.0, 700.0)
    check_all("S=32", xs, ys, vals, b, bb, w32, bins)
    # 32 segments x 16x16 bins = 8192 cells: past the shared table
    check_wbin("S=32,16x16", xs, ys, vals, b, w32, (16, 16))
    check_select("S=32,16x16", xs, ys, vals, b, w32, (16, 16))
    log("heatmap edge cases: equal (suffix_w bit for bit)")

    # --- the heatmap path's shapes: 8 segments of ~3.9e5 objects, 8x8
    # bins, 4x4 split cells
    seg_rows = 390_625
    xs, ys, vals, b, bb = segments(torch, gen, 8, seg_rows)
    L = int(b[-1])
    cx, cy = 0.5 * (bb[:, 0] + bb[:, 2]).mean(), 0.5 * (bb[:, 1] +
                                                        bb[:, 3]).mean()
    window = (float(cx - 150), float(cy - 150), float(cx + 150),
              float(cy + 150))
    xe, ye = split_edges(bb, 4)
    n_seg = len(b) - 1
    vmin = np.full(n_seg, -150.0)
    vmax = np.full(n_seg, 160.0)
    err_e = check_edges("main", xs, ys, vals, b, xe, ye)
    check_wbin("main", xs, ys, vals, b, window, bins)
    err_s = check_select("main", xs, ys, vals, b, window, bins)
    # process_heatmap's launch: S = 1, one tile of seg_rows objects that
    # the window crosses
    xs1, ys1, vals1 = xs[:seg_rows], ys[:seg_rows], vals[:seg_rows]
    b1 = np.array([0, seg_rows], np.int64)
    x0, y0, x1, y1 = bb[0]
    window1 = (float(x0 + 0.2 * (x1 - x0)), float(y0 + 0.2 * (y1 - y0)),
               float(x0 + 0.7 * (x1 - x0)), float(y0 + 0.7 * (y1 - y0)))
    err_w = check_wbin("tile", xs1, ys1, vals1, b1, window1, bins)

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

    # --- times at the heatmap path's shapes
    n_in = int(sa.window_bin_ids(xs, ys, window, *bins)[0].sum())
    n_in1 = int(sa.window_bin_ids(xs1, ys1, window1, *bins)[0].sum())
    nb = bins[0] * bins[1]
    out_b = 32 * n_seg * nb
    specs = {
        "segment_bin_agg_edges": (
            lambda: sa.segment_bin_agg_edges_cuda(xs, ys, vals, b, xe, ye),
            lambda: sa.segment_bin_agg_edges_torch(xs, ys, vals, b, xe, ye),
            # x, y, v read; 3 + 3 float64 edge compares and the float64
            # sum per object, float32 min/max
            bound_ms(12 * L + 32 * n_seg * 16, 2 * L, 7 * L),
            err_e, "src/repro_torch/kernels/csrc/segment_bin_agg_edges.cu",
            "src/repro/kernels/segment_agg.py:448"),
        "segment_window_bin_agg": (
            lambda: sa.segment_window_bin_agg_cuda(xs1, ys1, vals1, b1,
                                                   window1, *bins),
            lambda: sa.segment_window_bin_agg_torch(xs1, ys1, vals1, b1,
                                                    window1, *bins),
            # x, y read; v for in-window objects; 4 compares per object,
            # 2 subtracts + 2 divides + min/max per in-window object
            bound_ms(8 * seg_rows + 4 * n_in1 + 32 * nb,
                     4 * seg_rows + 6 * n_in1, n_in1),
            err_w, "src/repro_torch/kernels/csrc/segment_window_bin_agg.cu",
            "src/repro/kernels/segment_agg.py:295"),
        "segment_window_bin_select": (
            lambda: fs.segment_window_bin_select_cuda(
                xs, ys, vals, b, window, *bins, vmin, vmax),
            lambda: fs.segment_window_bin_select_torch(
                xs, ys, vals, b, window, *bins, vmin, vmax),
            bound_ms(8 * L + 4 * n_in + out_b + 8 * (n_seg + 1) * nb,
                     4 * L + 6 * n_in, n_in + 2 * n_seg * nb),
            err_s, "src/repro_torch/kernels/csrc/segment_window_bin_agg.cu",
            "src/repro/kernels/fused_select.py:364"),
    }
    for name, (kern, plain, (bms, by), err, src, rep) in specs.items():
        ms, pms = timed(kern), timed(plain)
        rows[name] = {"name": name, "route": "cuda", "source": src,
                      "replaces": rep, "launches": 0, "max_abs_err": err,
                      "ms": ms, "plain_ms": pms, "bound_ms": bms,
                      "bound_by": by, "library_ms": None}
        log(f"{name}: kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
            f"{bms:.4f} ms ({by}), max_abs_err {err:.3e}")
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


def phase_serving_kernels(torch, seed):
    from repro_torch.kernels import fused_select as fs
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_agg as sa

    log("== phase 2c: serving kernels against their plain versions")
    rng = np.random.default_rng(seed + 2)
    checks = make_multi_checks(torch)
    n_checks = 0
    for tag, n_seg, rows, empty, spans in (
            ("S=1", 1, 3000, (), [0, 1]),
            ("S=16", 16, 3000, (), [0, 1, 5, 6, 16]),
            ("S=16,empty", 16, 3000, (0, 5, 15), [0, 1, 5, 6, 16]),
            ("S=64", 64, 500, (), [0, 8, 9, 30, 31, 64])):
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
    log(f"serving edge cases ({n_checks} checks): equal (suffix_w bit for "
        "bit per span)")

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
    n_cases += 6
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
    for k in ("segment_window_agg", "segment_bin_agg", "bin_agg"):
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
            if not hasattr(x, f):
                continue
            u = np.atleast_1d(np.asarray(getattr(x, f), np.float64))
            v = np.atleast_1d(np.asarray(getattr(y, f), np.float64))
            fin = np.isfinite(u)
            if not (np.array_equal(fin, np.isfinite(v))
                    and (u[~fin] == v[~fin]).all()
                    and (np.abs(u[fin] - v[fin])
                         <= 1e-12 * np.abs(v[fin])).all()):
                raise Failed(f"budget {budget}, answer {i}: {f} differs")
    log(f"batched == sequential (crack_budget={budget}): {len(ra)} answers, "
        f"{ia[0]} tiles, publication {pa[-1]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=100_000_000)
    ap.add_argument("--queries", type=int, default=50)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--ticks", type=int, default=10)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    try:
        phase_card_and_build(torch, build)
        timed = make_timer(torch, args.reps)
        rows = phase_kernels(torch, timed, args.seed)
        rows.update(phase_heatmap_kernels(torch, timed, args.seed))
        phase_serving_kernels(torch, args.seed)
        rows.update(phase_window_agg(torch, timed, build, args.seed))
        torch.cuda.empty_cache()
        from repro_torch.data import exploration_path
        log("== dataset for phases 3 and 4")
        ds = make_dataset(torch, args.seed, args.rows)
        phase_scan(torch, timed, ds)
        windows = exploration_path(ds, n_queries=args.queries,
                                   target_objects=100_000, seed=11)
        launches = phase_main_path(torch, build, ds, windows)
        torch.cuda.empty_cache()
        launches.update({k: v for k, v in phase_heatmap_path(
            torch, build, ds, windows).items() if k in HEATMAP_KERNELS})
        torch.cuda.empty_cache()
        serving_launches, stats = phase_serving(torch, build, ds, args.ticks)
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
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
