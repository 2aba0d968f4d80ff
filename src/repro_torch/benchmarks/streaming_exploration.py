"""B8 — streaming exploration over a chunked, lazily-indexed file (port
of ``benchmarks/streaming_exploration.py``).

The scenario the chunked storage layer exists for: the raw file is ~10×
larger than what the analyst ever has resident — chunks arrive in
time/x order, the session explores a sliding window over the most
RECENT data, and old chunks retire as new ones land. Demonstrated
properties, per the acceptance criteria:

- **containment throughout streaming**: every scalar CI and every
  occupied heatmap bin's CI contains the live-data oracle, across
  ingest and retire events (violations are counted and must be 0);
- **pruning is free**: chunks whose axis bbox misses the query window
  cost ZERO read calls — not even their per-chunk index is built; live
  non-overlapping chunks' row counters must not move across a query
  (``prune_leaks`` must be 0);
- **lazy indexing**: a chunk pays its init pass on the FIRST query that
  overlaps it, never earlier (reported as built/live/seen counts);
- **bounded working set**: retirement keeps resident rows at
  ``live ≤ LIVE_CAP`` chunks while the session sweeps the whole
  ~10×-larger logical file;
- **degenerate-case parity**: a single-chunk ChunkedDataset reproduces
  the legacy engine (answers, reads, index evolution, I/O counters) —
  bit for bit under ``"np"``; on a device every counter, the tile table
  and the permutation equal, float64 values within 1e-12 relative.

Placement: on the host (``"np"``) the chunks are per-chunk ``mmap``
files in a temporary directory, as the reference's; on a device the
chunks' columns are resident there and retiring a chunk frees them.

    PYTHONPATH=src python -m repro_torch.benchmarks.streaming_exploration \
        [--smoke] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import shutil
import tempfile

import numpy as np

from ..core import AQPEngine
from ..data import ChunkedDataset, make_synthetic_dataset
from ..data.rawfile import IOStats
from ..data.synthetic import make_streaming_chunks
from . import common
from .common import (VALUE_RTOL, bench_config, emit, require, resolve,
                     same_index, same_values)

N_CHUNKS = 30          # logical file = N_CHUNKS slabs in x/time order
LIVE_CAP = 3           # working set: ≤ this many chunks resident (~10×)
QUERIES_PER_STEP = 2   # queries after each ingest (windowed on recent x)
DOMAIN = 1000.0
PHI = 0.05
# the last chunks made, by rows a chunk: chip_smoke.py's phase 7 and
# phase 9 stream the same 10⁸-row file, made once on the host
_CHUNKS = {}


def chunk_cfg(backend, **kw):
    kw.setdefault("min_split_count", 512 if not common.SMOKE else 64)
    return bench_config(backend, **kw)


def rows_per_chunk():
    """The reference's chunk size: a tenth of ``N_ROWS`` (so the
    logical file is three times the bench dataset)."""
    return max(common.N_ROWS // 10, 4_000)


def chunks(n_rows: int):
    """B8's ``N_CHUNKS`` x-slab chunks of ``n_rows`` rows (x, y, a0, a1;
    ``seed=31``) as host arrays, kept for the next caller that asks for
    the same size."""
    if n_rows not in _CHUNKS:
        _CHUNKS.clear()
        _CHUNKS[n_rows] = make_streaming_chunks(
            n_chunks=N_CHUNKS, rows_per_chunk=n_rows, n_columns=2,
            domain=DOMAIN, seed=31)
    return _CHUNKS[n_rows]


def recent_window(rng, hi_slab_edge, width_slabs=2.0):
    """A query window over the most recent ``width_slabs`` slabs of x —
    the time-windowed access pattern of streaming exploration."""
    slab = DOMAIN / N_CHUNKS
    x1 = rng.uniform(hi_slab_edge - 0.3 * slab, hi_slab_edge)
    x0 = max(0.0, x1 - rng.uniform(0.8, width_slabs) * slab)
    y0 = rng.uniform(0.0, 0.5) * DOMAIN
    y1 = y0 + rng.uniform(0.3, 0.5) * DOMAIN
    return (float(x0), float(y0), float(x1), float(y1))


def streaming_session(device="cuda", backend=None, mmap_dir=None,
                      chunk_rows=None):
    """The streaming session; ``mmap_dir`` holds the chunks' files on
    the host (``"np"``), ``chunk_rows`` defaults to
    :func:`rows_per_chunk`."""
    backend, data_device = resolve(device, backend)
    src = chunks(rows_per_chunk() if chunk_rows is None else chunk_rows)
    total_rows = sum(len(x) for x, _, _ in src)
    if data_device is None:
        cds = ChunkedDataset(storage="mmap", mmap_dir=mmap_dir, device=None)
    else:
        cds = ChunkedDataset(device=data_device)
    eng = AQPEngine(cds, chunk_cfg(backend))
    rng = np.random.default_rng(5)
    slab = DOMAIN / N_CHUNKS

    violations = 0
    prune_leaks = 0         # pruned-chunk reads that should never happen
    peak_live_rows = 0
    seen_chunks = 0
    for i, (x, y, cols) in enumerate(src):
        cds.ingest(x, y, cols)
        seen_chunks += 1
        while cds.n_chunks > LIVE_CAP:
            cds.retire(cds.live_ids[0])
        peak_live_rows = max(peak_live_rows, cds.n)
        hi_edge = (i + 1) * slab
        for q in range(QUERIES_PER_STEP):
            w = recent_window(rng, hi_edge)
            # snapshot live per-chunk counters: pruned chunks must not
            # move their read counters across the query
            unpruned = {c.chunk_id: c.stats.snapshot()
                        for c in cds.chunks()}
            r = eng.query(w, "mean", "a0", phi=PHI)
            truth = eng.oracle(w, "mean", "a0")
            if np.isfinite(truth) and not (r.lo - 1e-3 <= truth
                                           <= r.hi + 1e-3):
                violations += 1
            for c in cds.chunks():
                d = c.stats.delta(unpruned[c.chunk_id])
                if d.pruned_calls > 0 and (d.rows_read or d.read_calls
                                           or d.init_rows):
                    prune_leaks += 1
            h = eng.heatmap(w, "sum", "a0", bins=(4, 4), phi=PHI)
            ht = eng.heatmap_oracle(w, "sum", "a0", bins=(4, 4))
            fin = np.isfinite(ht)
            if not ((h.lo[fin] - 1e-2 <= ht[fin]).all()
                    and (ht[fin] <= h.hi[fin] + 1e-2).all()):
                violations += 1

    tot = eng.trace.totals()
    agg_stats = cds.stats            # includes retired chunks (monotone)
    return {
        "totals": tot,
        "violations": violations,
        "prune_leaks": prune_leaks,
        "total_rows": total_rows,
        "peak_live_rows": peak_live_rows,
        "rows_read": agg_stats.rows_read,
        "init_rows": agg_stats.init_rows,
        "pruned_calls": agg_stats.pruned_calls,
        "built": len(eng.index.built_ids()),
        "live": cds.n_chunks,
        "seen": seen_chunks,
    }


def single_chunk_parity(device="cuda", backend=None):
    """Acceptance: single-chunk ChunkedDataset ≡ legacy engine —
    answers, per-query I/O counters, index evolution, dataset
    IOStats."""
    backend, data_device = resolve(device, backend)
    exact = backend == "np"
    n = max(common.N_ROWS // 20, 4_000)
    ds_l = make_synthetic_dataset(n=n, seed=5, device=data_device)
    ds_c = make_synthetic_dataset(n=n, seed=5, device=data_device)
    legacy = AQPEngine(ds_l, chunk_cfg(backend))
    chunked = AQPEngine(ChunkedDataset.from_dataset(ds_c), chunk_cfg(backend))
    rng = np.random.default_rng(2)
    counters = ["exact", "tiles_full", "tiles_partial", "tiles_processed",
                "objects_read", "read_calls", "batch_rounds",
                "speculative_rows"]
    ok = True
    for _ in range(6):
        x0, y0 = rng.uniform(0, 600, 2)
        w = (x0, y0, x0 + 300.0, y0 + 300.0)
        a = legacy.query(w, "mean", "a0", phi=PHI)
        b = chunked.query(w, "mean", "a0", phi=PHI)
        ok &= all(getattr(a, f) == getattr(b, f) for f in counters)
        ok &= all(same_values(getattr(a, f), getattr(b, f), exact)
                  for f in ("value", "lo", "hi", "bound"))
        ha = legacy.heatmap(w, "sum", "a0", bins=(4, 4), phi=PHI)
        hb = chunked.heatmap(w, "sum", "a0", bins=(4, 4), phi=PHI)
        ok &= bool(same_values(ha.values, hb.values, exact)
                   and same_values(ha.lo, hb.lo, exact)
                   and same_values(ha.hi, hb.hi, exact)
                   and ha.objects_read == hb.objects_read)
    ok &= same_index(legacy.index, chunked.index._indexes[0], exact)
    ok &= all(getattr(ds_l.stats, f.name) == getattr(ds_c.stats, f.name)
              for f in dataclasses.fields(IOStats))
    return bool(ok)


def main(device="cuda", backend=None, chunk_rows=None):
    """B8; ``chunk_rows`` overrides the rows a chunk (``chip_smoke.py``:
    a 10⁸-row logical file)."""
    on_host = resolve(device, backend)[1] is None
    mmap_dir = tempfile.mkdtemp(prefix="b8_chunks_") if on_host else None
    try:
        out = streaming_session(device, backend, mmap_dir, chunk_rows)
    finally:
        if mmap_dir is not None:
            shutil.rmtree(mmap_dir, ignore_errors=True)
    tot = out["totals"]
    # containment and prune-purity are hard acceptance gates, not just
    # reported numbers — fail the bench run loudly if they regress
    require(out["violations"] == 0, f"B8 containment: {out}")
    require(out["prune_leaks"] == 0, f"B8 pruned-chunk reads: {out}")
    emit("streaming_chunked",
         tot["total_time_s"] * 1e6 / max(tot["queries"], 1),
         f"rows_total={out['total_rows']};"
         f"peak_live_rows={out['peak_live_rows']};"
         f"file_over_ws={out['total_rows'] / out['peak_live_rows']:.1f}x;"
         f"rows_read={out['rows_read']};"
         f"init_rows={out['init_rows']};"
         f"pruned_calls={out['pruned_calls']};"
         f"pruned_per_query="
         f"{tot['total_pruned_chunks'] / max(tot['queries'], 1):.2f};"
         f"chunks_seen={out['seen']};live={out['live']};"
         f"built={out['built']};"
         f"violations={out['violations']};"
         f"prune_leaks={out['prune_leaks']}",
         **{k: v for k, v in out.items() if k != "totals"},
         time_s=tot["total_time_s"], queries=tot["queries"])
    parity = single_chunk_parity(device, backend)
    require(parity, "single-chunk ChunkedDataset diverged from legacy")
    emit("streaming_single_chunk_parity", 0.0,
         f"bit_for_bit={parity and on_host}"
         + ("" if on_host else f";values_rtol={VALUE_RTOL:g}"),
         equal=parity)
    return out


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
