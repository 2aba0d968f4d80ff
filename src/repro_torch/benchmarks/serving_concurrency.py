"""B7 — concurrent multi-session serving: latency and throughput vs
session count over ONE shared adaptive index (port of
``benchmarks/serving_concurrency.py``).

N sessions (N ∈ {1, 4, 16}) each orbit a zipf-hot viewport: viewport
centres are drawn zipf-weighted from a small pool of hot spots (a few
regions absorb most of the traffic — the workload concurrent
exploration frontends actually see). Every tick, each live session
submits one φ-constrained mean query (every 4th submission a 4×4
heatmap); the :class:`~repro_torch.core.serving.ServingEngine`
micro-batches the tick into fused gathered reads + packed multi-window
kernel passes (``segment_window_agg_multi``, and one
``segment_window_bin_select_multi`` launch a heatmap pass on the card)
and publishes staged cracking atomically at tick end.

Reported per N: p50/p99 per-query latency (``eval_time_s``), aggregate
served rows/s, queries/s, reads and publish/mask counters. The
``rows_per_s`` terms are what ``compare.py`` gates.

Hard acceptance gates (asserted):
- every answer is φ-contained: ``exact or bound ≤ φ``, and its CI
  contains the oracle truth on a sampled subset;
- a same-tick micro-batched round equals the sequential per-query
  reference — answers AND published index evolution: bit for bit under
  ``"np"``; on a device every count, the tile table, the permutation
  and the extrema equal, float64 values within 1e-12 relative (sums in
  another order). The batched tick compares each segment under its
  ticket's rule (``ROADMAP.md`` queue C item 6).

Datasets are the bench dataset's array form (on the host ``storage=
"array"``, as the reference: B7 measures scheduling and kernel fusion,
not text parsing).

    PYTHONPATH=src python -m repro_torch.benchmarks.serving_concurrency \
        [--smoke] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..core import AQPEngine, ServingEngine
from . import common
from .common import (VALUE_RTOL, bench_config, emit, require, resolve,
                     same_index, same_values)

PHI = 0.05
DOMAIN = 1000.0
N_HOT = 8                  # hot-spot pool size (zipf-weighted)
ZIPF_S = 1.3               # zipf exponent over the hot-spot ranks
SESSION_COUNTS = (1, 4, 16)
ORACLE_SAMPLE = 5          # containment-check every k-th result

# answer fields that must match across serving modes
PARITY_FIELDS = ("value", "lo", "hi", "bound", "exact", "tiles_full",
                 "tiles_partial", "tiles_processed", "speculative_rows",
                 "retired_during_query")
# the float64 ones among them (and the heatmap's per-bin arrays)
VALUE_FIELDS = ("value", "lo", "hi", "bound", "values", "bin_bound")


def _ticks():
    return 4 if common.SMOKE else 10


def _serving_cfg(backend):
    return bench_config(backend,
                        min_split_count=64 if common.SMOKE else 512)


def _engine(seed, device, backend):
    backend, data_device = resolve(device, backend)
    ds = common.dataset(seed, data_device, storage="array")
    return AQPEngine(ds, _serving_cfg(backend)), backend


def _hot_spots(rng):
    pts = rng.uniform(0.1 * DOMAIN, 0.9 * DOMAIN, size=(N_HOT, 2))
    w = 1.0 / np.arange(1, N_HOT + 1) ** ZIPF_S
    return pts, w / w.sum()


def _submit_workload(server, sessions, rng, hot, pw, n_ticks):
    """Drive ``n_ticks`` micro-batched rounds; returns results +
    (window per result) in served order."""
    results, windows = [], []
    for _ in range(n_ticks):
        for k, s in enumerate(sessions):
            cx, cy = (hot[rng.choice(N_HOT, p=pw)]
                      + rng.normal(0, 0.02 * DOMAIN, 2))
            w = rng.uniform(0.05, 0.15) * DOMAIN
            win = (cx - w, cy - w, cx + w, cy + w)
            if (len(results) + k) % 4 == 3:
                s.heatmap(win, "mean", "a0", bins=(4, 4), phi=PHI)
            else:
                s.query(win, "mean", "a0", phi=PHI)
            windows.append(win)
        results.extend(server.tick())
    return results, windows


def session_sweep(n_sessions: int, device="cuda", backend=None):
    eng, _ = _engine(common.SEED, device, backend)
    server = ServingEngine(eng)
    sessions = [server.open_session(f"s{i}") for i in range(n_sessions)]
    rng = np.random.default_rng(100 + n_sessions)
    hot, pw = _hot_spots(np.random.default_rng(23))

    reads0 = eng.io_stats.rows_read
    t0 = time.perf_counter()
    results, windows = _submit_workload(server, sessions, rng, hot, pw,
                                        _ticks())
    wall = time.perf_counter() - t0
    rows = eng.io_stats.rows_read - reads0

    # hard gate 1: φ-containment on EVERY answer + sampled oracle truth
    for i, (r, win) in enumerate(zip(results, windows)):
        require(r.exact or r.bound <= PHI + 1e-12,
                f"B7 answer {i}: bound {r.bound} over phi")
        if i % ORACLE_SAMPLE == 0:
            if not hasattr(r, "values"):          # scalar
                truth = eng.oracle(win, "mean", "a0")
                require(r.lo - 1e-9 <= truth <= r.hi + 1e-9,
                        f"B7 answer {i} over {win} misses the oracle")
            else:                                  # heatmap bins
                ht = eng.heatmap_oracle(win, "mean", "a0", bins=r.bins)
                fin = np.isfinite(ht)
                require((r.lo[fin] - 1e-6 <= ht[fin]).all()
                        and (ht[fin] <= r.hi[fin] + 1e-6).all(),
                        f"B7 heatmap {i} over {win} misses the oracle")

    lat = np.array([r.eval_time_s for r in results])
    return {
        "n_sessions": n_sessions,
        "queries": len(results),
        "wall_s": wall,
        "p50_ms": float(np.percentile(lat, 50) * 1e3),
        "p99_ms": float(np.percentile(lat, 99) * 1e3),
        "rows_read": int(rows),
        "rows_per_s": rows / wall,
        "queries_per_s": len(results) / wall,
        "rounds_published": server.last_publish["rounds_published"],
        "splits_masked": server.last_publish["splits_masked"],
        "epochs": server.epoch,
    }


def batched_equals_sequential(device="cuda", backend=None) -> bool:
    """Hard gate 2: the SAME multi-session tick script served batched
    and sequentially yields identical answers and identical published
    index state (see the module docstring for what "identical" is on a
    device)."""
    out = {}
    for mode in ("batched", "sequential"):
        eng, backend = _engine(common.SEED + 1, device, backend)
        server = ServingEngine(eng, mode=mode)
        sessions = [server.open_session() for _ in range(4)]
        rng = np.random.default_rng(55)
        hot, pw = _hot_spots(np.random.default_rng(23))
        results, _ = _submit_workload(server, sessions, rng, hot, pw, 3)
        out[mode] = (results, server.index, server.last_publish)
    exact = backend == "np"
    ra, ia, pa = out["batched"]
    rb, ib, pb = out["sequential"]
    ok = len(ra) == len(rb) and pa == pb and same_index(ia, ib, exact)
    for x, y in zip(ra, rb):
        for f in PARITY_FIELDS + ("values", "bin_bound"):
            if hasattr(x, f):
                ok &= same_values(getattr(x, f), getattr(y, f),
                                  exact or f not in VALUE_FIELDS)
    return bool(ok)


def main(device="cuda", backend=None):
    for n in SESSION_COUNTS:
        out = session_sweep(n, device, backend)
        emit(f"serving_n{n}",
             out["wall_s"] * 1e6 / max(out["queries"], 1),
             f"sessions={n};queries={out['queries']};"
             f"p50_ms={out['p50_ms']:.2f};p99_ms={out['p99_ms']:.2f};"
             f"rows_per_s={out['rows_per_s']:.0f};"
             f"queries_per_s={out['queries_per_s']:.1f};"
             f"rows_read={out['rows_read']};"
             f"epochs={out['epochs']};"
             f"rounds_published={out['rounds_published']};"
             f"splits_masked={out['splits_masked']}", **out)
    parity = batched_equals_sequential(device, backend)
    require(parity, "micro-batched tick diverged from sequential reference")
    bit = resolve(device, backend)[0] == "np"
    emit("serving_batched_eq_sequential", 0.0,
         f"bit_for_bit={parity and bit}"
         + ("" if bit else f";values_rtol={VALUE_RTOL:g}"),
         equal=parity)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny-n smoke sizing (same code paths)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    if a.smoke:
        common.configure_smoke()
    print("name,us_per_call,derived")
    main(device=a.device)
