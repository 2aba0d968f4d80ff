"""B3 — the port's data-plane kernel microbenchmarks.

The counterpart of ``benchmarks/kernels_bench.py`` on the port's three
backends: the float64 host mirrors (``np``), the plain PyTorch versions
(``torch``) and the hand-written Hopper kernels (``cuda``), on B3's data
(``default_rng(0)``, n = 1 000 000, or 200 000 under ``--smoke``; window
``[200, 200, 600, 600]``, bbox ``[0, 0, 1000, 1000]``, 4 segments, 2×2
bins, a multi-window case of two query spans). Rows are
``name,us_per_call,derived``; the derived field scores each row against
the bandwidth roofline (:func:`repro_torch.launch.roofline.
aqp_kernel_roofline`) and names the device it ran on.

- **Timing** is min-of-reps wall time per call, each call followed by
  ``torch.cuda.synchronize()`` on the card: the per-call cost a caller
  sees, launch and host-side work included, as B3 times. (``chip_smoke.py``
  times the kernels with CUDA events instead, L2 flushed, median: the
  device-side time at the engine's shapes. Both are kept: one is what a
  caller of the op pays, the other what the kernel costs the card.)
- **Bytes** are what the port's kernels must stream: x, y and v once,
  12 n (8 n for ``window_count``, which reads no value plane). B3 counts
  16 n for the segmented rows (``nb4``) because its Pallas kernels also
  stream a segment-id plane; the port's kernels take segment boundaries
  instead and read none.
- **Device.** ``main()`` runs on the card and raises without one;
  ``main(device="cpu")`` runs the ``np`` and ``torch`` rows only, and
  scores the ``torch`` rows against the host bandwidth
  (``AQP_BW["np"]``), never the card's.
- **Not carried over.** B3's ``MIN_*_JNP_GB_S`` floors gate XLA:CPU
  numbers of another implementation, and its VMEM sizing rows describe
  the TPU's on-chip memory; neither says anything about this port, and
  no floor takes their place. Nor do the Pallas interpret-mode rows,
  which time the reference's validation path.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..data.rawfile import resolve_device
from ..kernels import ops
from ..launch.roofline import aqp_kernel_roofline
from . import common
from .common import emit

REPS = 15
WINDOW = (200.0, 200.0, 600.0, 600.0)


def data(n):
    """B3's x, y, v planes (float32 numpy) of ``n`` objects."""
    rng = np.random.default_rng(0)
    xs = rng.uniform(0, 1000, n).astype(np.float32)
    ys = rng.uniform(0, 1000, n).astype(np.float32)
    vs = rng.normal(0, 10, n).astype(np.float32)
    return xs, ys, vs


def _klabel(n: int) -> str:
    """Row label suffix derived from the actual element count, so smoke
    rows can't be mistaken for full-size numbers in BENCH output."""
    return f"{n // 1000}K" if n < 1_000_000 else f"{n // 1_000_000}M"


def main(device="cuda"):
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    where = torch.cuda.get_device_name(dev) if on_card else "cpu"

    def time_call(fn, *args, **kw):
        """Min-of-reps seconds per call (the first call warms up)."""
        fn(*args, **kw)
        sync()
        best = float("inf")
        for _ in range(REPS):
            t0 = time.perf_counter()
            fn(*args, **kw)
            sync()
            best = min(best, time.perf_counter() - t0)
        return best

    def row(name, n_bytes, backend, fn, *args, **kw):
        t = time_call(fn, *args, backend=backend, **kw)
        r = aqp_kernel_roofline(n_bytes, t, backend if on_card else "np")
        emit(name, t * 1e6,
             f"GB_s={r['achieved_GB_s']:.2f}"
             f";roofline_fraction={r['roofline_fraction']:.4f}"
             f";bound_GB_s={r['bound_GB_s']:.0f};backend={backend}"
             f";device={where}",
             GB_s=r["achieved_GB_s"],
             roofline_fraction=r["roofline_fraction"])

    backends = ("np", "torch", "cuda") if on_card else ("np", "torch")
    n = 200_000 if common.SMOKE else 1_000_000
    xs, ys, vs = data(n)
    win = np.array(WINDOW, np.float32)
    bbox = np.array([0, 0, 1000, 1000], np.float32)
    planes = {"np": (xs, ys, vs)}
    planes["torch"] = planes["cuda"] = tuple(
        torch.from_numpy(a).to(dev) for a in (xs, ys, vs))
    nb3 = 3 * n * 4   # x, y, v streamed once
    k = _klabel(n)

    for be in backends:
        row(f"window_agg_{be}_{k}", nb3, be, ops.window_agg, *planes[be],
            tuple(win))
    for be in backends[1:]:
        row(f"bin_agg_{be}_{k}_2x2", nb3, be, ops.bin_agg, *planes[be],
            bbox, gx=2, gy=2)

    # --- fused selection: 4 tiles' concatenated segments and their
    # pending value intervals, the batched-refinement round shape
    n_seg = 4
    bounds = np.linspace(0, n, n_seg + 1).astype(np.int64)
    vmin_s = np.full(n_seg, -30.0)
    vmax_s = np.full(n_seg, 30.0)
    for be in backends:
        row(f"fused_select_{be}_{k}_4seg_2x2", nb3, be,
            ops.segment_window_bin_select, *planes[be], bounds, tuple(win),
            vmin_s, vmax_s, bx=2, by=2)

    # --- multi-window fused select (the serving tick's heatmap op): each
    # segment under its own window, suffix widths per query span
    wins = [tuple(float(v) for v in win + 40.0 * s) for s in range(n_seg)]
    qb = np.array([0, 2, n_seg], np.int64)   # two query spans
    for be in backends:
        row(f"fused_multi_{be}_{k}_4seg_2x2", nb3, be,
            ops.segment_window_bin_select_multi, *planes[be], bounds, wins,
            vmin_s, vmax_s, qbounds=qb, bx=2, by=2)

    if on_card:
        row(f"window_count_cuda_{k}", 2 * n * 4, "cuda", ops.window_count,
            *planes["cuda"][:2], tuple(win))


if __name__ == "__main__":
    main()
