"""The port's main path — ``AQPEngine.query`` on one ``TileIndex`` —
against the reference package, on the seeds and sizes of
``tests/test_batched_refinement.py`` and ``tests/test_core_aqp.py``
(n = 60 000, grid0 (8, 8), ``min_split_count=64``).

- Port ``"np"`` ≡ reference, bit for bit: every ``QueryResult`` field
  but the wall time, the ``IOStats`` and ``AdaptStats`` deltas of each
  query, and the index fingerprint (``tests/test_serving.py:77``).
- Port ``"torch"`` on CPU tensors runs the device code path with the
  plain kernels. Its sums are float64 in another order, so answers agree
  with the reference to ``VALUE_RTOL``; counts, reads, splits and the
  permutation are equal, every answer contains the oracle, and the
  invariants hold.
- Batched ≡ sequential inside the port, on both backends.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import AQPEngine as RefEngine, IndexConfig as RefConfig
from repro.data import make_synthetic_dataset as ref_dataset
from repro.data.synthetic import exploration_path as ref_path
from repro.kernels import ref as ref_kernels
from repro_torch.core import AQPEngine, IndexConfig, index_to_numpy
from repro_torch.core import index as index_mod
from repro_torch.data import exploration_path, make_synthetic_dataset
from repro_torch.kernels.segment_agg import EVERYWHERE, MAX_SEGMENTS

AGGS = ["count", "sum", "mean", "min", "max"]
PHIS = [0.0, 0.01, 0.05]
# float64 sums in another order: relative agreement of answers and
# interval ends (their magnitudes are far above the summation error)
VALUE_RTOL = 1e-9


def ref_engine(seed, n=60_000):
    ds = ref_dataset(n=n, seed=seed)
    return RefEngine(ds, RefConfig(grid0=(8, 8), min_split_count=64,
                                   init_metadata_attrs=("a0",)))


def port_engine(seed, backend, n=60_000):
    ds = make_synthetic_dataset(n=n, seed=seed, device="cpu")
    return AQPEngine(ds, IndexConfig(grid0=(8, 8), min_split_count=64,
                                     init_metadata_attrs=("a0",),
                                     backend=backend))


def fields(r):
    d = dataclasses.asdict(r)
    d.pop("eval_time_s")
    return d


def fingerprint(index):
    a = index_to_numpy(index)
    n = a["n_tiles"]
    return (n, int(a["active"].sum()), a["count"][:n], a["perm"],
            {k: (a["meta_sum"][k][:n], a["meta_min"][k][:n],
                 a["meta_max"][k][:n], a["meta_valid"][k][:n])
             for k in a["meta_sum"]})


def assert_fingerprints_equal(fa, fb):
    assert fa[:2] == fb[:2]
    np.testing.assert_array_equal(fa[2], fb[2])
    np.testing.assert_array_equal(fa[3], fb[3])
    assert fa[4].keys() == fb[4].keys()
    for k in fa[4]:
        for x, y in zip(fa[4][k], fb[4][k]):
            np.testing.assert_array_equal(x, y)


def run_both(e_ref, e_port, windows, agg, phi, sequential):
    """Yield (window, reference result, port result, reference I/O +
    adapt deltas, port deltas) per window."""
    for w in windows:
        before = [(e.io_stats.snapshot(), e.adapt_stats.snapshot())
                  for e in (e_ref, e_port)]
        ra = e_ref.query(w, agg, "a0", phi=phi, sequential=sequential)
        rb = e_port.query(w, agg, "a0", phi=phi, sequential=sequential)
        deltas = [(dataclasses.asdict(e.io_stats.delta(io)),
                   dataclasses.asdict(e.adapt_stats.delta(ad)))
                  for e, (io, ad) in zip((e_ref, e_port), before)]
        yield w, ra, rb, deltas[0], deltas[1]


def test_windows_match_reference():
    e_ref = ref_engine(5)
    ds = make_synthetic_dataset(n=60_000, seed=5, device="cpu")
    np.testing.assert_array_equal(ds.x.numpy(), e_ref.dataset.x)
    np.testing.assert_array_equal(ds.read_all_unaccounted("a3").numpy(),
                                  e_ref.dataset.read_all_unaccounted("a3"))
    assert ds.domain() == e_ref.dataset.domain()
    assert (exploration_path(ds, n_queries=6, target_objects=4000)
            == ref_path(e_ref.dataset, n_queries=6, target_objects=4000))


@pytest.mark.parametrize("sequential", [False, True],
                         ids=["batched", "sequential"])
@pytest.mark.parametrize("phi", PHIS)
@pytest.mark.parametrize("agg", AGGS)
def test_port_np_equals_reference(agg, phi, sequential):
    e_ref, e_port = ref_engine(5), port_engine(5, "np")
    wins = ref_path(e_ref.dataset, n_queries=4, target_objects=4000)
    for _, ra, rb, da, db in run_both(e_ref, e_port, wins, agg, phi,
                                      sequential):
        assert fields(ra) == fields(rb)
        assert da == db
    assert_fingerprints_equal(fingerprint(e_ref.index),
                              fingerprint(e_port.index))


@pytest.mark.parametrize("sequential", [False, True],
                         ids=["batched", "sequential"])
@pytest.mark.parametrize("phi", PHIS)
@pytest.mark.parametrize("agg", AGGS)
def test_port_torch_matches_reference(agg, phi, sequential):
    e_ref, e_port = ref_engine(5), port_engine(5, "torch")
    wins = ref_path(e_ref.dataset, n_queries=4, target_objects=4000)
    for w, ra, rb, da, db in run_both(e_ref, e_port, wins, agg, phi,
                                      sequential):
        truth = e_port.oracle(w, agg, "a0")
        assert truth == pytest.approx(e_ref.oracle(w, agg, "a0"),
                                      rel=VALUE_RTOL)
        tol = VALUE_RTOL * max(1.0, abs(truth))
        assert rb.lo - tol <= truth <= rb.hi + tol
        assert rb.exact or rb.bound <= phi + 1e-12
        for f in ("value", "lo", "hi"):
            assert getattr(rb, f) == pytest.approx(getattr(ra, f),
                                                   rel=VALUE_RTOL,
                                                   abs=VALUE_RTOL)
        for f in ("exact", "tiles_full", "tiles_partial", "tiles_processed",
                  "objects_read", "read_calls", "batch_rounds",
                  "speculative_rows"):
            assert getattr(rb, f) == getattr(ra, f), f
        assert da == db
    ia, ib = index_to_numpy(e_ref.index), index_to_numpy(e_port.index)
    assert ia["n_tiles"] == ib["n_tiles"]
    np.testing.assert_array_equal(ia["perm"], ib["perm"])
    np.testing.assert_array_equal(ia["count"], ib["count"])
    np.testing.assert_array_equal(ia["meta_min"]["a0"], ib["meta_min"]["a0"])
    np.testing.assert_array_equal(ia["meta_max"]["a0"], ib["meta_max"]["a0"])
    np.testing.assert_allclose(ib["meta_sum"]["a0"], ia["meta_sum"]["a0"],
                               rtol=VALUE_RTOL, atol=VALUE_RTOL)
    e_port.index.check_invariants("a0")


@pytest.mark.parametrize("backend", ["np", "torch"])
@pytest.mark.parametrize("agg", AGGS)
def test_port_batched_equals_sequential(agg, backend):
    e_seq, e_bat = port_engine(5, backend), port_engine(5, backend)
    wins = exploration_path(e_seq.dataset, n_queries=4, target_objects=4000)
    for phi in (0.0, 0.05):
        for w in wins:
            rs = e_seq.query(w, agg, "a0", phi=phi, sequential=True)
            rb = e_bat.query(w, agg, "a0", phi=phi)
            for f in ("exact", "tiles_full", "tiles_partial",
                      "tiles_processed"):
                assert getattr(rb, f) == getattr(rs, f), f
            for f in ("value", "lo", "hi", "bound"):
                assert getattr(rb, f) == pytest.approx(
                    getattr(rs, f), rel=1e-12, abs=1e-9)
    fs, fb = fingerprint(e_seq.index), fingerprint(e_bat.index)
    assert fs[:2] == fb[:2]
    np.testing.assert_array_equal(fs[2], fb[2])
    np.testing.assert_array_equal(fs[3], fb[3])
    for x, y in zip(fs[4]["a0"], fb[4]["a0"]):
        np.testing.assert_allclose(x, y, rtol=1e-12)
    e_bat.index.check_invariants("a0")


@pytest.mark.parametrize("backend", ["np", "torch"])
@pytest.mark.parametrize("agg", AGGS)
def test_port_exact_equals_oracle(agg, backend):
    """``tests/test_core_aqp.py`` P1 on the port: φ=0 is exact."""
    eng = port_engine(11, backend)
    for w in exploration_path(eng.dataset, n_queries=5,
                              target_objects=5000):
        r = eng.query(w, agg, "a0", phi=0.0)
        assert r.exact
        np.testing.assert_allclose(r.value, eng.oracle(w, agg, "a0"),
                                   rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("case", ["finite", "inf_values", "nan_values"])
def test_segment_stats_runs_of_max_segments(monkeypatch, case):
    """The index's whole-segment enrichment over 200 segments (some
    empty) goes through ``ops.segment_window_agg`` in runs of at most
    ``MAX_SEGMENTS`` (the kernel's boundary table) and equals the
    reference's ``segment_window_agg_np`` under the ±inf window: counts
    and extrema equal, sums within 1e-12·Σ|v|. ±inf values count, as
    they do in the reference; so do NaN values, which make their
    segment's sum, min and max NaN."""
    import torch

    from repro_torch.kernels import ops

    rng = np.random.default_rng(7)
    counts = rng.integers(0, 400, 200)
    counts[[0, 63, 64, 65, 127, 199]] = 0
    b = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    vals = rng.normal(5.0, 30.0, int(b[-1])).astype(np.float32)
    if case == "inf_values":
        vals[b[3]] = np.inf
        vals[b[70] + 1] = -np.inf
        vals[b[140]:b[141]] = np.inf
    elif case == "nan_values":
        vals[b[3]] = np.nan
        vals[b[70] + 1] = np.nan
        vals[b[140]:b[141]] = np.nan
    calls = []
    real = ops.segment_window_agg

    def spy(xs, ys, vs, boundaries, window, *, backend=None):
        calls.append((len(boundaries) - 1, backend))
        return real(xs, ys, vs, boundaries, window, backend=backend)

    monkeypatch.setattr(ops, "segment_window_agg", spy)
    got = index_mod._segment_stats(torch.from_numpy(vals), b, "torch")
    assert calls == [(MAX_SEGMENTS, "torch")] * 3 + [(200 - 3 * MAX_SEGMENTS,
                                                      "torch")]
    want = ref_kernels.segment_window_agg_np(vals, vals, vals, b, EVERYWHERE)
    absv = ref_kernels.segment_window_agg_np(
        vals, vals, np.abs(np.nan_to_num(vals)), b, EVERYWHERE)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_array_equal(got[:, 2:], want[:, 2:])   # NaN = NaN
    fin = np.isfinite(want[:, 1])
    np.testing.assert_array_equal(got[~fin, 1], want[~fin, 1])
    assert (np.abs(got[fin, 1] - want[fin, 1]) <= 1e-12 * absv[fin, 1]).all()
    assert fin.all() == (case == "finite")
    if case == "nan_values":
        assert np.isnan(want[[3, 70, 140], 1:]).all()


@pytest.mark.parametrize("backend", ["np", "torch"])
def test_nan_value_tile_metadata_matches_reference(backend):
    """A NaN in the attribute column of a ``RawDataset``: the init
    enrichment and one ``read_batch`` round over the NaN's tile (its
    in-window contribution, then ``apply_batch``'s enrichment and split)
    give the reference's tile metadata — NaN sum, min and max on every
    tile that holds the object. Port "np" ≡ reference bit for bit; port
    "torch" with equal counts and extrema (NaN equal to NaN) and float64
    sums within 1e-12 relative."""
    from repro.core import TileIndex as RefIndex
    from repro.data import RawDataset as RefRaw
    from repro_torch.core import TileIndex
    from repro_torch.data import RawDataset

    rng = np.random.default_rng(12)
    n, k = 20_000, 1234
    x = rng.uniform(0, 1000, n).astype(np.float32)
    y = rng.uniform(0, 1000, n).astype(np.float32)
    a0 = rng.normal(5.0, 30.0, n).astype(np.float32)
    a0[k] = np.nan
    cfg = dict(grid0=(4, 4), min_split_count=64, init_metadata_attrs=("a0",))
    ref = RefIndex(RefRaw(x, y, {"a0": a0.copy()}), RefConfig(**cfg))
    port = TileIndex(RawDataset(x, y, {"a0": a0.copy()},
                                device=None if backend == "np" else "cpu"),
                     IndexConfig(backend=backend, **cfg))
    slot = int(np.flatnonzero(ref.perm == k)[0])
    nt = ref.n_tiles
    tile = int(np.flatnonzero(
        ref.active[:nt] & (ref.offset[:nt] <= slot)
        & (slot < ref.offset[:nt] + ref.count[:nt]))[0])
    window = tuple(float(v) for v in ref.bbox[tile])
    contribs = []
    for ix in (ref, port):
        c, payload = ix.read_batch(np.array([tile], np.int64), window, "a0")
        ix.apply_batch(payload, 1, [True])
        contribs.append(np.array(c, np.float64))
    assert port.n_tiles == ref.n_tiles > nt          # the tile split
    nt = ref.n_tiles
    np.testing.assert_array_equal(port.count[:nt], ref.count[:nt])
    np.testing.assert_array_equal(port.active[:nt], ref.active[:nt])
    slot = int(np.flatnonzero(ref.perm == k)[0])   # after the split
    holds = np.flatnonzero((ref.offset[:nt] <= slot)
                           & (slot < ref.offset[:nt] + ref.count[:nt]))
    assert len(holds) >= 2                    # the tile and its child
    assert np.isnan(ref.meta_sum["a0"][holds]).all()
    assert np.isnan(ref.meta_min["a0"][holds]).all()
    assert np.isnan(ref.meta_max["a0"][holds]).all()
    assert np.isnan(contribs[0][0, 1:]).all()
    got = (port.meta_sum["a0"][:nt], port.meta_min["a0"][:nt],
           port.meta_max["a0"][:nt], port.meta_valid["a0"][:nt])
    want = (ref.meta_sum["a0"][:nt], ref.meta_min["a0"][:nt],
            ref.meta_max["a0"][:nt], ref.meta_valid["a0"][:nt])
    if backend == "np":
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(contribs[1], contribs[0])
        return
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12, equal_nan=True)
    np.testing.assert_array_equal(contribs[1][:, [0, 2, 3]],
                                  contribs[0][:, [0, 2, 3]])
    np.testing.assert_array_equal(np.isnan(contribs[1][:, 1]),
                                  np.isnan(contribs[0][:, 1]))
