"""B9 — predictive pre-cracking vs reactive exploration at EQUAL I/O
(port of ``benchmarks/predictive_exploration.py``).

Scripted pan/zoom sessions compare two engines over identical data and
identical per-step row budgets:

- **reactive** — answers each step, then spends the step's prefetch
  budget re-cracking the CURRENT viewport (the best a predictor-free
  engine can do with the same spare I/O);
- **predictive** — answers each step, then spends the SAME budget
  cracking the PREDICTED next viewport (``AQPEngine.prefetch``).

Both arms therefore run at the same total I/O (query reads + budgeted
pre-crack reads, each pre-crack hard-capped at the same ``budget``);
what differs is WHERE the spare rows go. The claim this bench gates: on
an extrapolable linear pan, predicted pre-cracking cuts the p99 of
QUERY-TIME reads — the reads the user actually waits on — versus the
same budget spent reactively. Emitted per script (linear_pan,
random_walk): p50/p99 query-time ``objects_read`` per arm, total I/O per
arm, and the predictor's candidate hit-rates. Under ``--smoke`` the
linear-pan p99 claim is a hard assert, as is φ=0 answer equality
between the arms (prefetch never alters an answer).

The engines run the hand-written kernels (``"cuda"``) on the card;
``main(device="cpu")`` runs them under ``"torch"`` on CPU tensors, and
``backend="np"`` runs the float64 host mirrors on host data (the
reference's own arithmetic, so its counters compare exactly). Reads are
counters and do not depend on the device.
"""
from __future__ import annotations

import numpy as np

from ..core import AQPEngine
from ..core.predict import prefetch_crack
from . import common
from .common import bench_config, emit, resolve

BINS = (4, 4)
PHI = 0.05
# steps before any prediction exists (the predictor needs 2 windows);
# both arms pay the identical cold start there, so the percentile
# comparison covers the steady-state steps the budget can influence
WARMUP = 2


def _linear_pan(n, domain=1000.0):
    """Constant-velocity pan of a fixed window across the domain."""
    w = 0.30 * domain
    lo, hi = 0.05 * domain, 0.95 * domain - w
    xs = np.linspace(lo, hi, n)
    ys = np.linspace(hi, lo, n)
    return [(x, y, x + w, y + w) for x, y in zip(xs, ys)]


def _random_walk(n, domain=1000.0, seed=13):
    """Unpredictable jumps — the predictor's worst case."""
    rng = np.random.default_rng(seed)
    w = 0.30 * domain
    out = []
    for _ in range(n):
        x, y = rng.uniform(0.05 * domain, 0.95 * domain - w, 2)
        out.append((x, y, x + w, y + w))
    return out


def _run_arm(make_engine, wins, budget, predictive: bool):
    """One arm of the comparison; returns (per-query reads, results,
    total prefetch rows, engine). The reactive arm spends the identical
    budget re-cracking the viewport it just answered."""
    eng = make_engine()
    reads, results, spent = [], [], 0
    for w in wins:
        r = eng.heatmap(w, "mean", "a0", bins=BINS, phi=PHI)
        reads.append(r.objects_read)
        results.append(r)
        if predictive:
            rec = eng.prefetch(budget)
        else:
            rec = prefetch_crack(eng.index, w, "a0", BINS, budget,
                                 alpha=eng.alpha)
        spent += rec["rows_read"]
    return np.asarray(reads, np.float64), results, spent, eng


def _script(name, wins, budget, make_engine):
    q_react, r_react, pre_react, _ = _run_arm(make_engine, wins, budget,
                                              False)
    q_pred, r_pred, pre_pred, eng = _run_arm(make_engine, wins, budget,
                                             True)
    p50r, p99r = np.percentile(q_react[WARMUP:], [50, 99])
    p50p, p99p = np.percentile(q_pred[WARMUP:], [50, 99])
    tot_react = int(q_react.sum()) + pre_react
    tot_pred = int(q_pred.sum()) + pre_pred
    hit_l = eng.predictor.hit_rate("linear")
    hit_m = eng.predictor.hit_rate("model")
    emit(f"predictive_{name}_reactive", 0.0,
         f"p50_reads={p50r:.0f};p99_reads={p99r:.0f}"
         f";total_io={tot_react};budget={budget}",
         p50_reads=float(p50r), p99_reads=float(p99r), total_io=tot_react,
         budget=budget)
    emit(f"predictive_{name}_predicted", 0.0,
         f"p50_reads={p50p:.0f};p99_reads={p99p:.0f}"
         f";total_io={tot_pred};budget={budget}"
         f";hit_linear={hit_l:.2f};hit_model={hit_m:.2f}",
         p50_reads=float(p50p), p99_reads=float(p99p), total_io=tot_pred,
         budget=budget, hit_linear=hit_l, hit_model=hit_m)
    return p99r, p99p, r_react, r_pred


def main(device: str = "cuda", backend=None):
    """B9 on ``device`` (the card by default); ``backend`` defaults to
    ``"cuda"`` on the card and ``"torch"`` elsewhere, and ``"np"`` runs
    the host mirrors on host data."""
    backend, data_device = resolve(device, backend)

    def make_engine():
        # one dataset (the bench dataset's array form) for every engine;
        # each engine's reads are counted as deltas of its own
        return AQPEngine(common.dataset(7, data_device, storage="array"),
                         bench_config(backend))

    n_q = common.N_QUERIES
    # spare-I/O budget per step, sized to a typical query's reads so
    # the pre-crack can actually cover the next viewport — the arms
    # stay comparable because BOTH spend the same cap per step
    budget = 6 * common.TARGET_OBJECTS

    p99r, p99p, _, _ = _script("linear_pan", _linear_pan(n_q), budget,
                               make_engine)
    if common.SMOKE:
        # the B9 acceptance gate: at equal total I/O, predicted
        # pre-cracking must cut the tail of query-time reads on the
        # extrapolable script
        assert p99p < p99r, (
            f"predictive p99 reads {p99p:.0f} not below reactive "
            f"{p99r:.0f} on the linear pan at equal I/O budget")

    _script("random_walk", _random_walk(n_q), budget, make_engine)

    # answer-neutrality, in-bench: φ=0 exact answers from a prefetching
    # engine equal a fresh reactive engine's — bit for bit on the host
    # mirrors; float64 sums in another atomic order on the card, so there
    # within 1e-12·Σ|v| a bin
    wins = _linear_pan(max(4, n_q // 3))
    eng_p, eng_r = make_engine(), make_engine()
    exact = backend == "np"
    for w in wins:
        eng_p.prefetch(budget)
        a = eng_p.heatmap(w, "mean", "a0", bins=BINS, phi=0.0)
        b = eng_r.heatmap(w, "mean", "a0", bins=BINS, phi=0.0)
        assert a.exact and b.exact, "a φ=0 answer is not exact"
        if exact:
            assert np.array_equal(a.values, b.values), \
                "prefetch altered a φ=0 answer"
        else:
            np.testing.assert_allclose(a.values, b.values, rtol=1e-12,
                                       err_msg="prefetch altered a φ=0 "
                                       "answer")
    emit("predictive_answer_neutrality", 0.0,
         f"checked={len(wins)};bit_identical={exact}", checked=len(wins))
    return None
