"""B6 — heatmap (2-D group-by) exploration: per-viewport binned
aggregates under a per-bin accuracy constraint φ (port of
``benchmarks/heatmap_exploration.py``).

The binned-view workload visual exploration frontends actually send
(VALINOR/RawVis; generalized to approximate bins by arXiv 2505.19872):
each viewport renders a bx×by heatmap, and the φ-constrained path should
(a) read fewer objects than exact per-bin answering, (b) amortize
refinement into one gathered read + one packed
``segment_window_bin_select`` kernel per round, and (c) get cheaper
along the path as tiles split finer than bins and start answering from
metadata alone.

The φ_b section runs the same viewport workload on a SKEWED dataset (one
hot spatial corner, near-zero values everywhere else) three ways —
uniform φ, ε_abs-floored φ_b (``AccuracyPolicy``), center-salience φ_b —
and reports objects read plus the per-bin ACHIEVED error
(worst/mean |value − oracle| over occupied bins): uniform φ is dragged
toward exactness by the near-zero bins, the floored allocation is not.

Gates (asserted): no session reads a speculative row, and every query
of the floored and salience sessions meets every bin's budget. The port
adds one gate the reference leaves to its tests: the first
``SEQ_QUERIES`` viewports of the φ = 5 % path answered on the
sequential per-tile path give the batched path's answers and index
(bit for bit under ``"np"``; float64 values within 1e-12 relative on a
device, whose sums run in another order). On the card that replay is
the path that launches ``segment_window_bin_agg``.

The distributed arm (``--distributed``; always at the smoke size, as
in the reference) runs a repeated-window heatmap session on the SPMD
session engine over a ``ShardMesh`` of ``--shards`` shards (default 1,
the reference's one-device baseline row) against the stateless one-shot
step, plus one floored φ_b query. Its gates: the repeat reads no more
than the first query, and the φ_b query meets every bin's budget.

    python -m repro_torch.benchmarks.heatmap_exploration [--smoke]
        [--device cpu] [--phi-floor 0.02] [--salience center]
        [--distributed] [--shards 8]

``--phi-floor`` is RELATIVE to the hottest bin's |oracle| (a scale-free
spec for the absolute ε_abs floor); ``--salience none`` drops the
salience session.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..core import AQPEngine, AccuracyPolicy, IndexConfig
from ..core.distributed import (DistConfig, DistributedAQPEngine,
                                make_heatmap_step)
from ..core.mesh import ShardMesh
from ..data.rawfile import RawDataset
from . import common
from .common import (bench_config, emit, fresh_engine, mixed_io_summary,
                     require, resolve, same_index, same_values, workload)

BINS = (8, 8)
N_QUERIES = 20
PHI_B = 0.05              # constraint of the φ_b comparison sessions
FLOOR_FRAC = 0.02         # default ε_abs = 2% of the hottest bin
SALIENCE = "center"
SEQ_QUERIES = 5           # viewports of the sequential-path replay


def run_session(phi: float, bins=BINS, n_queries=N_QUERIES, device="cuda",
                backend=None, sequential=False):
    eng = fresh_engine(device=device, backend=backend)
    wins = workload(eng.dataset, n_queries)
    for w in wins:
        eng.heatmap(w, "mean", "a0", bins=bins, phi=phi,
                    sequential=sequential)
    return eng, eng.trace.totals()


def skewed_dataset(n=None, seed=3, device="cuda"):
    """One hot corner of large values, near-zero noise elsewhere — the
    regime where uniform φ degenerates to exact per-bin answering. The
    reference's arrays; on the host its ``storage="csv"`` file, on a
    device resident columns."""
    n = (common.N_ROWS // 4) if n is None else n
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1000, n).astype(np.float32)
    y = rng.uniform(0, 1000, n).astype(np.float32)
    hot = (x > 750) & (y > 750)
    v = np.where(hot, rng.normal(100, 10, n),
                 rng.normal(0, 0.02, n)).astype(np.float32)
    return RawDataset(x, y, {"a0": v},
                      storage="csv" if device is None else "array",
                      device=device)


def run_phi_b_session(policy, ds, wins, truths, backend, bins=BINS,
                      phi=PHI_B):
    """One skewed-viewport session; returns (totals, achieved-error and
    bound stats vs the per-bin oracle, summed over the path).
    ``truths`` carries the per-window oracle grids, shared across the
    uniform/floored/salience sessions."""
    eng = AQPEngine(ds, bench_config(backend))
    worst_err = worst_bound = mean_err = 0.0
    unmet = 0
    for w, truth in zip(wins, truths):
        r = eng.heatmap(w, "sum", "a0", bins=bins, phi=phi, policy=policy)
        fin = np.isfinite(truth)
        err = np.abs(r.values[fin] - truth[fin])
        worst_err = max(worst_err, float(err.max(initial=0.0)))
        mean_err += float(err.mean()) / len(wins)
        worst_bound = max(worst_bound, r.bound)
        if r.bin_met is not None and not r.bin_met.all():
            unmet += 1
    return eng.trace.totals(), {
        "worst_bin_err": worst_err, "mean_bin_err": mean_err,
        "worst_bin_bound": worst_bound, "queries_unmet": unmet}


def phi_b_comparison(floor_frac=FLOOR_FRAC, salience=SALIENCE,
                     device="cuda", backend=None):
    """Uniform φ vs floored/salience φ_b on the skewed dataset — the
    per-bin-allocation acceptance numbers."""
    backend, data_device = resolve(device, backend)
    ds = skewed_dataset(device=data_device)
    wins = [(500.0 + 20.0 * (i % 5), 500.0 + 20.0 * (i // 5),
             1000.0, 1000.0) for i in range(min(N_QUERIES, 10))]
    # per-window oracles, computed ONCE and shared by every session (and
    # by the floor calibration) — they depend only on (ds, window, bins)
    eng0 = AQPEngine(ds, IndexConfig(grid0=(8, 8), backend=backend))
    truths = [eng0.heatmap_oracle(w, "sum", "a0", bins=BINS)
              for w in wins]
    del eng0
    # calibrate the absolute floor off the hottest bin (scale-free spec)
    eps_abs = floor_frac * float(np.nanmax(np.abs(
        np.where(np.isfinite(truths[0]), truths[0], 0.0))))

    sessions = [("uniform", None),
                ("floored", AccuracyPolicy(eps_abs=eps_abs))]
    if salience != "none":
        sessions.append(
            ("salience", AccuracyPolicy(eps_abs=eps_abs,
                                        salience=salience)))
    out = {}
    for name, policy in sessions:
        tot, errs = run_phi_b_session(policy, ds, wins, truths, backend)
        emit(f"heatmap_phi_b_{name}",
             tot["total_time_s"] * 1e6 / tot["queries"],
             mixed_io_summary(tot, extra=[
                 f"worst_bin_err={errs['worst_bin_err']:.3f}",
                 f"mean_bin_err={errs['mean_bin_err']:.3f}",
                 f"worst_bin_bound={errs['worst_bin_bound']:.4f}",
                 f"queries_unmet={errs['queries_unmet']}",
                 f"eps_abs={eps_abs:.1f}"]),
             rows_read=tot["total_objects_read"],
             read_calls=tot["total_read_calls"],
             speculative_rows=tot["total_speculative_rows"], **errs)
        require(tot["total_speculative_rows"] == 0,
                f"B6 phi_b {name}: {tot['total_speculative_rows']} "
                "speculative rows")
        if policy is not None:
            require(errs["queries_unmet"] == 0,
                    f"B6 phi_b {name}: {errs['queries_unmet']} queries "
                    "left a bin over its budget")
        out[name] = tot
    ratio = out["floored"]["total_objects_read"] / max(
        out["uniform"]["total_objects_read"], 1)
    emit("heatmap_phi_b_gain", 0.0,
         f"reads_uniform={out['uniform']['total_objects_read']};"
         f"reads_floored={out['floored']['total_objects_read']};"
         f"floored_read_frac={ratio:.3f};"
         f"speculative_floored={out['floored']['total_speculative_rows']}",
         floored_read_frac=ratio)
    return out


def sequential_parity(device="cuda", backend=None,
                      n_queries=SEQ_QUERIES):
    """The first ``n_queries`` viewports of the φ = 5 % path on the
    batched and the sequential path, fresh engines: equal answers (read
    counters, tiles, values) and equal index (tile table, permutation,
    metadata)."""
    backend, _ = resolve(device, backend)
    exact = backend == "np"
    got = []
    for sequential in (False, True):
        eng, _ = run_session(0.05, n_queries=n_queries, device=device,
                             backend=backend, sequential=sequential)
        got.append(eng)
    a, b = got
    ok = True
    for x, y in zip(a.trace.results, b.trace.results):
        for f in ("objects_read", "tiles_full", "tiles_partial",
                  "tiles_processed", "speculative_rows", "exact"):
            ok &= getattr(x, f) == getattr(y, f)
        for f in ("values", "lo", "hi", "bin_bound"):
            ok &= same_values(getattr(x, f), getattr(y, f), exact)
    ok &= same_index(a.index, b.index, exact)
    emit("heatmap_batched_eq_sequential", 0.0,
         f"queries={n_queries};equal={bool(ok)};bit_for_bit={exact}",
         queries=n_queries, equal=bool(ok))
    require(ok, "B6: the sequential heatmap path diverged from the "
            "batched one")
    return bool(ok)


def distributed_session(bins=BINS, phi=0.05, repeats=4,
                        floor_frac=FLOOR_FRAC, salience=SALIENCE,
                        device="cuda", backend=None, shards=1, ds=None):
    """Repeated-window DISTRIBUTED heatmap session over the sharded
    session state on ``shards`` shards: query 1 pays the surrogate
    price, query 2+ answer previously-read tiles from the per-(tile,
    bin) registry and the cracked grid — against the stateless one-shot
    step, which pays the full price on every repeat. Also one floored
    φ_b query and its per-bin budget verdict. ``ds`` replaces the
    skewed dataset (the card's runs pass a larger one)."""
    backend, data_device = resolve(device, backend)
    if ds is None:
        ds = skewed_dataset(device=data_device)
    mesh = ShardMesh(shards, device)
    cfg = DistConfig(grid=(16, 16), capacity=2048, min_split_count=512)
    eng = DistributedAQPEngine(ds, mesh, cfg)
    # deliberately NOT grid-aligned: the boundary tiles are partial, so
    # query 1 has real reads for the session memory to amortize
    w = (433.0, 417.0, 981.0, 993.0)
    reads = []
    for _ in range(repeats):
        r = eng.heatmap(w, "a0", bins=bins, phi=phi)
        reads.append(r.objects_read)
    # stateless baseline: the pre-session surrogate, rebuilt per call
    step = make_heatmap_step(mesh, cfg, bins)
    sl = [float(step(eng.xs, eng.ys, eng.vals["a0"], eng.domain, w,
                     phi)["objects_read"]) for _ in range(2)]
    # φ_b budgets: floor calibrated off the hottest bin seen, under the
    # same spec as the host φ_b sessions
    hot = float(np.abs(r.values[np.isfinite(r.values)]).max())
    pol = AccuracyPolicy(eps_abs=max(1.0, floor_frac * hot),
                         salience=None if salience == "none"
                         else salience)
    rp = eng.heatmap(w, "a0", bins=bins, phi=phi, policy=pol)
    tot = eng.trace.totals()
    met = bool(rp.bin_met.all())
    emit("heatmap_distributed_session",
         tot["total_time_s"] * 1e6 / max(tot["queries"], 1),
         mixed_io_summary(tot, extra=[
             f"devices={shards}",
             f"reads_q1={reads[0]:.0f}",
             f"reads_q2={reads[1]:.0f}",
             f"reads_last={reads[-1]:.0f}",
             f"reads_stateless_repeat={sl[1]:.0f}",
             f"session_repeat_frac="
             f"{reads[1] / max(reads[0], 1):.3f}",
             f"phi_b_bins_met={met}",
             f"active_tiles={list(eng.n_active.values())[0]}"]),
         time_s=tot["total_time_s"], devices=shards, reads=reads,
         reads_stateless=sl, phi_b_bins_met=met)
    require(reads[1] <= reads[0],
            f"B6 distributed: the repeat read {reads[1]} > {reads[0]}")
    require(met, "B6 distributed: the phi_b query left a bin over its "
            "budget")
    return {"reads": reads, "stateless": sl, "engine": eng}


def main(floor_frac=FLOOR_FRAC, salience=SALIENCE, device="cuda",
         backend=None, distributed=False, shards=1):
    out = {}
    for name, phi in (("exact", 0.0), ("phi1", 0.01), ("phi5", 0.05)):
        eng, tot = run_session(phi, device=device, backend=backend)
        half = len(eng.trace.results) // 2
        early = sum(r.objects_read for r in eng.trace.results[:half])
        late = sum(r.objects_read for r in eng.trace.results[half:])
        # speculative_rows: rows read past the stopping point — 0 under
        # predictive grouped round sizing (sum/mean), so any nonzero
        # value here is a regression in the per-bin sizing bound
        emit(f"heatmap_{name}", tot["total_time_s"] * 1e6 / tot["queries"],
             f"{mixed_io_summary(tot)};"
             f"batch_rounds={tot['total_batch_rounds']};"
             f"tiles_processed={tot['total_tiles_processed']};"
             f"rows_early_half={early};rows_late_half={late};"
             f"active_tiles={eng.index.n_active}",
             time_s=tot["total_time_s"], rows_read=tot["total_objects_read"],
             read_calls=tot["total_read_calls"],
             speculative_rows=tot["total_speculative_rows"],
             active_tiles=eng.index.n_active)
        require(tot["total_speculative_rows"] == 0,
                f"B6 {name}: {tot['total_speculative_rows']} speculative "
                "rows")
        out[name] = tot
        del eng
    s5 = out["exact"]["total_time_s"] / max(out["phi5"]["total_time_s"],
                                            1e-9)
    emit("heatmap_speedup", 0.0,
         f"exact_vs_phi5={s5:.2f}x;"
         f"reads_exact={out['exact']['total_objects_read']};"
         f"reads_phi5={out['phi5']['total_objects_read']};"
         f"speculative_phi5={out['phi5']['total_speculative_rows']}",
         exact_vs_phi5=s5)
    out["phi_b"] = phi_b_comparison(floor_frac, salience, device, backend)
    if distributed or common.SMOKE:
        # the sharded-session acceptance numbers ride the smoke lane, as
        # in the reference; full size via --distributed
        out["distributed"] = distributed_session(
            floor_frac=floor_frac, salience=salience, device=device,
            backend=backend, shards=shards)
    out["sequential_parity"] = sequential_parity(device, backend)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phi-floor", type=float, default=FLOOR_FRAC,
                    help="eps_abs floor as a fraction of the hottest "
                         "bin's |oracle| (default 0.02)")
    ap.add_argument("--salience", choices=["center", "none"],
                    default=SALIENCE)
    ap.add_argument("--distributed", action="store_true",
                    help="run the repeated-window sharded-session "
                         "comparison (persistent state vs stateless)")
    ap.add_argument("--shards", type=int, default=1,
                    help="shards of the distributed arm's mesh")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny-n smoke sizing (same code paths)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    if a.smoke:
        common.configure_smoke()
    print("name,us_per_call,derived")
    main(floor_frac=a.phi_floor, salience=a.salience, device=a.device,
         distributed=a.distributed, shards=a.shards)
