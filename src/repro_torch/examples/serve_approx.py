"""Concurrent AQP serving over an LM-adjacent object store: several
analyst sessions sweep φ-constrained viewport queries against ONE
shared adaptive index (port of ``examples/serve_approx.py``).

Scenario: 300K "token embedding" records projected to 2-D (axis
attributes) with per-record scalar metrics (loss, entropy, ...). Four
analysts each orbit a hot region: "mean loss in this viewport, ±5%".
Same-tick queries are micro-batched into fused reads + packed kernel
passes; index cracking publishes atomically between ticks, so no
session ever sees a half-applied split.

    PYTHONPATH=src python -m repro_torch.examples.serve_approx [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..benchmarks.common import resolve
from ..core import AQPEngine, IndexConfig
from ..data.rawfile import RawDataset

PHI = 0.05
N_SESSIONS = 4
N_TICKS = 10


def make_embedding_store(n=300_000, seed=0, device="cuda"):
    rng = np.random.default_rng(seed)
    # 2-D projection: a few semantic clusters
    centers = rng.uniform(-50, 50, size=(12, 2))
    assign = rng.integers(0, 12, n)
    xy = centers[assign] + rng.normal(0, 4, size=(n, 2))
    # per-record metrics keyed to cluster identity + noise
    loss = 2.0 + 0.3 * assign + rng.gamma(2.0, 0.25, n)
    entropy = rng.uniform(0, 8, n) + (assign % 3)
    return RawDataset(xy[:, 0], xy[:, 1],
                      {"loss": loss.astype(np.float32),
                       "entropy": entropy.astype(np.float32)},
                      device=device)


def sweep(server, sessions, hot_spots, rng):
    """Run N_TICKS micro-batched rounds; every session submits one
    viewport per tick. Returns (results_served, windows, seconds,
    objects_read, last_ticket) — the last ticket is captured explicitly
    at submit time."""
    served, windows = [], []
    last_ticket = None
    reads0 = server.engine.io_stats.rows_read
    t0 = time.perf_counter()
    for _ in range(N_TICKS):
        for s, hot in zip(sessions, hot_spots):
            cx, cy = hot + rng.normal(0, 3, 2)
            w = rng.uniform(5, 18)
            win = (cx - w, cy - w, cx + w, cy + w)
            last_ticket = s.query(win, "mean", "loss", phi=PHI)
            windows.append(win)
        served.extend(server.tick())
    dt = time.perf_counter() - t0
    reads = server.engine.io_stats.rows_read - reads0
    return served, windows, dt, reads, last_ticket


def main(n=300_000, device="cuda", backend=None):
    backend, data_device = resolve(device, backend)
    ds = make_embedding_store(n=n, device=data_device)
    eng = AQPEngine(ds, IndexConfig(grid0=(16, 16), min_split_count=128,
                                    init_metadata_attrs=("loss",),
                                    backend=backend))
    server = eng.serve()
    sessions = [server.open_session(f"analyst-{i}")
                for i in range(N_SESSIONS)]

    rng = np.random.default_rng(3)
    # each analyst orbits one hot cluster centre
    hot_spots = rng.uniform(-40, 40, size=(N_SESSIONS, 2))

    served, windows, dt, reads, last_ticket = sweep(server, sessions,
                                                    hot_spots, rng)
    for r in served:
        if not (r.exact or r.bound <= PHI + 1e-9):
            raise AssertionError(f"a served answer misses phi: {r.bound}")
    n_q = len(served)
    ms_per = dt * 1e3 / max(n_q, 1)
    print(f"served {n_q} φ={PHI:.0%} queries from {N_SESSIONS} sessions "
          f"in {dt*1e3:.1f} ms ({ms_per:.2f} ms/query), "
          f"{reads} objects read")

    # spot-check guarantee quality on the explicitly captured last
    # ticket (its own window + result)
    if last_ticket is not None and last_ticket.result is not None:
        last = last_ticket.result
        truth = eng.oracle(last_ticket.window, "mean", "loss")
        print(f"last query: approx={last.value:.4f} truth={truth:.4f} "
              f"bound={last.bound:.3%} "
              f"inside_CI={last.lo <= truth <= last.hi}")

    # second sweep over the same hot regions: the adapted (and now
    # published) index answers mostly from metadata
    served2, windows2, dt2, reads2, _ = sweep(server, sessions, hot_spots,
                                              rng)
    print(f"re-sweep: {len(served2)} queries in {dt2*1e3:.1f} ms, "
          f"{reads2} objects read "
          f"(I/O saved {1 - reads2/max(reads, 1):.1%})")

    per_session = {s.name: s.trace.totals()["queries"] for s in sessions}
    print(f"per-session queries: {per_session}; "
          f"epochs published: {server.epoch}")
    return {"served": served + served2, "windows": windows + windows2,
            "oracle": [eng.oracle(w, "mean", "loss")
                       for w in windows + windows2]}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the data lives; 'cpu' runs the engine "
                         "under 'torch'")
    main(device=ap.parse_args().device)
