"""The randomized differential harness's sessions on any backend, held
against the port's ``"np"`` mirror by the parity contract (the card
variant of the property sweep, ``tests/test_torch_properties_sweep.py``).

A session is the reference harness's (``tests/test_properties.py``
``run_session``): ``N_OPS`` scalar or heatmap queries drawn from an op
seed — random windows, aggregates, φ, attributes, bin grids and, with
policies, random per-bin ``AccuracyPolicy`` allocations. The generators
are copies of the harness's (``random_window``, ``random_policy``), with
the same rng calls in the same order, so a seed draws the same
operations on any dataset of the same domain.

:func:`run_parity` runs one session's operations on two fresh engines
over the same data, batched: ``"np"`` on host columns and ``backend``
(``"cuda"`` on the card, ``"torch"``) on device columns, and holds them
to the parity contract (ROADMAP): every integer field and the ``exact``
flag equal; counts and extrema equal (the answers of ``count``, ``min``
and ``max`` and every tile's ``meta_min`` / ``meta_max``); a sum within
``SUM_ATOL`` · Σ|v| (an answer's value and interval ends under ``sum``
and ``mean``, every tile's ``meta_sum``); relative bounds within
``BOUND_RTOL``; ``perm``, the tile table, the reads and the splits
equal. It raises ``AssertionError`` naming the first difference.

``CARD_SESSIONS`` are the sweep's sessions that the card runs: the first
two of each of its uniform and φ_b lists.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from ..core import AccuracyPolicy, AQPEngine, IndexConfig
from ..data import RawDataset, make_synthetic_dataset

AGGS = ["count", "sum", "mean", "min", "max"]
PHIS = [0.0, 0.02, 0.1]
ATTRS = ["a0", "a1", "a2"]
N_OPS = 5
SUM_ATOL = 1e-12        # a float64 sum, of Σ|v| over the attribute
BOUND_RTOL = 1e-9       # a relative bound, as the CPU tests hold it
# (op seed, with φ_b policies): tests/test_torch_properties_sweep.py's
CARD_SESSIONS = [(980008, False), (52478, False), (241074, True),
                 (544456, True)]
EXACT_AGGS = ("count", "min", "max")
INT_FIELDS = ("exact", "tiles_full", "tiles_partial", "tiles_processed",
              "objects_read", "read_calls", "batch_rounds",
              "speculative_rows")
SUM_FIELDS = ("value", "lo", "hi", "values")
BOUND_FIELDS = ("bound", "bin_bound")
TABLE = ("bbox", "offset", "count", "active")


def random_window(rng, ds):
    x0d, y0d, x1d, y1d = ds.domain()
    wx = rng.uniform(0.05, 0.5) * (x1d - x0d)
    wy = rng.uniform(0.05, 0.5) * (y1d - y0d)
    x0 = rng.uniform(x0d, x1d - wx)
    y0 = rng.uniform(y0d, y1d - wy)
    return (float(x0), float(y0), float(x0 + wx), float(y0 + wy))


def random_policy(rng, bins):
    """A random φ_b strategy: weights × floors × salience, or None."""
    kind = int(rng.integers(0, 5))
    if kind == 0:
        return None
    weights = eps_abs = salience = None
    if kind in (1, 4):
        weights = np.exp(rng.uniform(-1.5, 1.5, bins[0] * bins[1]))
        if kind == 4 and rng.random() < 0.5:
            weights[rng.integers(len(weights))] = np.inf  # don't-care bin
    if kind in (2, 4):
        eps_abs = float(rng.uniform(0.1, 200.0))
    if kind == 3 or rng.random() < 0.25:
        salience = "center" if rng.random() < 0.5 else \
            rng.uniform(0.2, 1.0, bins[0] * bins[1])
    return AccuracyPolicy(weights=weights,
                          eps_abs=0.0 if eps_abs is None else eps_abs,
                          salience=salience)


def draw_ops(op_seed: int, ds, with_policies: bool, n_ops: int = N_OPS):
    """A session's operations: ``(kind, window, agg, attr, phi, bins,
    policy)`` each, ``kind`` ``"query"`` or ``"heatmap"``."""
    rng = np.random.default_rng(op_seed)
    ops = []
    for _ in range(n_ops):
        w = random_window(rng, ds)
        agg = AGGS[rng.integers(len(AGGS))]
        phi = PHIS[rng.integers(len(PHIS))]
        attr = ATTRS[rng.integers(len(ATTRS))]
        if rng.random() < 0.5:
            ops.append(("query", w, agg, attr, phi, None, None))
        else:
            bins = (int(rng.integers(2, 5)), int(rng.integers(2, 5)))
            policy = random_policy(rng, bins) if with_policies else None
            ops.append(("heatmap", w, agg, attr, phi, bins, policy))
    return ops


def datasets(n: int, device, seed: int = 101) -> Tuple[Any, Any]:
    """The harness's dataset (3 columns, seed 101) at ``n`` rows: host
    columns for ``"np"``, and the same columns on ``device``."""
    host = make_synthetic_dataset(n=n, n_columns=3, seed=seed, device=None)
    dev = RawDataset(host.x, host.y,
                     {a: host.read_all_unaccounted(a)
                      for a in host.attributes}, device=device)
    return host, dev


def engine(ds, backend: str):
    return AQPEngine(ds, IndexConfig(grid0=(6, 6), min_split_count=64,
                                     init_metadata_attrs=("a0",),
                                     backend=backend))


def _run(eng, op):
    kind, w, agg, attr, phi, bins, policy = op
    if kind == "query":
        return eng.query(w, agg, attr, phi=phi)
    return eng.heatmap(w, agg, attr, bins=bins, phi=phi, policy=policy)


def _host(a):
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def _equal(what, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.array_equal(
        got, want, equal_nan=got.dtype.kind == "f"), (what, got, want)


def _within(what, got, want, atol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    fin = np.isfinite(want)
    assert got.shape == want.shape and np.array_equal(
        fin, np.isfinite(got)), (what, got, want)
    _equal(what, got[~fin], want[~fin])
    err = np.abs(got[fin] - want[fin])
    assert (err <= atol).all(), (what, float(err.max()), atol)


def _same_result(i, r, want, agg, abs_sum):
    for f in INT_FIELDS:
        assert getattr(r, f) == getattr(want, f), (i, f, getattr(r, f),
                                                   getattr(want, f))
    for f in SUM_FIELDS:
        if not hasattr(want, f):
            continue
        if agg in EXACT_AGGS:
            _equal(f"op {i}.{f}", getattr(r, f), getattr(want, f))
        else:
            _within(f"op {i}.{f}", getattr(r, f), getattr(want, f),
                    SUM_ATOL * abs_sum)
    for f in BOUND_FIELDS:
        if hasattr(want, f):
            got, ref = (np.asarray(getattr(x, f), np.float64)
                        for x in (r, want))
            fin = np.isfinite(ref)
            assert np.array_equal(fin, np.isfinite(got)) and np.allclose(
                got[fin], ref[fin], rtol=BOUND_RTOL, atol=1e-12), \
                (i, f, got, ref)


def _same_index(ia, ib, attrs, abs_sums):
    n = ia.n_tiles
    assert ib.n_tiles == n, ("n_tiles", ib.n_tiles, n)
    _equal("perm", _host(ib.perm), _host(ia.perm))
    for k in TABLE:
        _equal(k, _host(getattr(ib, k))[:n], _host(getattr(ia, k))[:n])
    for a in attrs:
        for k in ("meta_valid", "meta_min", "meta_max"):
            _equal(f"{k}.{a}", _host(getattr(ib, k)[a])[:n],
                   _host(getattr(ia, k)[a])[:n])
        _within(f"meta_sum.{a}", _host(ib.meta_sum[a])[:n],
                _host(ia.meta_sum[a])[:n], SUM_ATOL * abs_sums[a])


def run_parity(host, dev, backend: str, op_seed: int,
               with_policies: bool) -> Dict[str, Any]:
    """One session on ``"np"`` over ``host`` and on ``backend`` over
    ``dev`` (the same rows), batched, held to the parity contract after
    every operation and at the end. Returns the session's counters."""
    ops = draw_ops(op_seed, host, with_policies)
    e_np, e_dev = engine(host, "np"), engine(dev, backend)
    abs_sums = {a: float(np.abs(host.read_all_unaccounted(a).astype(
        np.float64)).sum()) for a in ATTRS}
    attrs, kinds = {"a0"}, []
    reads = 0
    for i, op in enumerate(ops):
        attrs.add(op[3])
        want, got = _run(e_np, op), _run(e_dev, op)
        _same_result(i, got, want, op[2], abs_sums[op[3]])
        kinds.append(f"{op[0]} {op[2]} phi={op[4]}"
                     + (f" bins={op[5]}" if op[5] else "")
                     + (" policy" if op[6] is not None else ""))
        reads += want.objects_read
    _same_index(e_np.index, e_dev.index, sorted(attrs), abs_sums)
    return {"op_seed": op_seed, "policies": with_policies, "ops": kinds,
            "objects_read": reads, "tiles": int(e_np.index.n_tiles)}


def sessions(which: List[Tuple[int, bool]] = None, n: int = 10 ** 6,
             device="cuda", backend: str = "cuda"):
    """``run_parity`` of each of ``which`` (default ``CARD_SESSIONS``)
    on the harness's dataset at ``n`` rows; returns their counters."""
    host, dev = datasets(n, device)
    return [run_parity(host, dev, backend, seed, pol)
            for seed, pol in (which or CARD_SESSIONS)]
