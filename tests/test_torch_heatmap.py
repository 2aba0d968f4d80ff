"""The port's heatmap path — ``AQPEngine.heatmap`` on one ``TileIndex`` —
against the reference package, on the sizes and seeds of
``tests/test_heatmap.py``, ``tests/test_accuracy_policy.py`` and
``tests/test_refine_driver.py`` (n = 40 000, grid0 (8, 8),
``min_split_count=64``, bin-aligned splits and session memory on).

- Port ``"np"`` ≡ reference, bit for bit: every ``HeatmapResult`` field
  but the wall time, the ``IOStats`` and ``AdaptStats`` deltas of each
  query, and the index fingerprint (tile table, permutation, metadata).
- Port ``"torch"`` on CPU tensors runs the device code path with the
  plain kernels: counts, reads, splits and the permutation equal the
  reference's; values and interval ends agree to ``VALUE_RTOL`` (float64
  sums in another order); every bin's interval contains the oracle; the
  invariants hold.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import (AccuracyPolicy as RefPolicy, AQPEngine as RefEngine,
                        IndexConfig as RefConfig)
from repro.data import make_synthetic_dataset as ref_dataset
from repro.data.synthetic import exploration_path as ref_path
from repro_torch.core import (AccuracyPolicy, AQPEngine, HeatmapResult,
                              IndexConfig, index_to_numpy)
from repro_torch.data import make_synthetic_dataset

AGGS = ["count", "sum", "mean", "min", "max"]
PHIS = [0.0, 0.01, 0.05]
BINS = (4, 4)
# float64 sums in another order: relative agreement of values and
# interval ends (their magnitudes are far above the summation error)
VALUE_RTOL = 1e-9
KW = dict(grid0=(8, 8), min_split_count=64, init_metadata_attrs=("a0",))


def engines(seed, backend, n=40_000, **kw):
    kw = {**KW, **kw}
    ref = RefEngine(ref_dataset(n=n, seed=seed), RefConfig(**kw))
    port = AQPEngine(make_synthetic_dataset(n=n, seed=seed, device="cpu"),
                     IndexConfig(backend=backend, **kw))
    return ref, port


def fields(r):
    d = dataclasses.asdict(r)
    d.pop("eval_time_s")
    return d


def assert_fields_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray) or isinstance(b[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], (k, a[k], b[k])


def fingerprint(index):
    a = index_to_numpy(index)
    n = a["n_tiles"]
    return (n, int(a["active"].sum()), a["count"][:n], a["bbox"][:n],
            a["perm"], {k: (a["meta_sum"][k][:n], a["meta_min"][k][:n],
                            a["meta_max"][k][:n], a["meta_valid"][k][:n])
                        for k in a["meta_sum"]})


def assert_fingerprints_equal(fa, fb):
    assert fa[:2] == fb[:2]
    for x, y in zip(fa[2:5], fb[2:5]):
        np.testing.assert_array_equal(x, y)
    assert fa[5].keys() == fb[5].keys()
    for k in fa[5]:
        for x, y in zip(fa[5][k], fb[5][k]):
            np.testing.assert_array_equal(x, y)


def step(e, w, agg, **kw):
    """One heatmap on engine ``e``: (result, IOStats delta, AdaptStats
    delta)."""
    io, ad = e.io_stats.snapshot(), e.adapt_stats.snapshot()
    r = e.heatmap(w, agg, "a0", **kw)
    return (r, dataclasses.asdict(e.io_stats.delta(io)),
            dataclasses.asdict(e.adapt_stats.delta(ad)))


def assert_np_session_equal(e_ref, e_port, calls):
    """``calls``: (kind, window, agg, kwargs) run on both engines; the
    port ("np") must match bit for bit, query by query, and end with the
    same index."""
    for kind, w, agg, kw in calls:
        if kind == "heatmap":
            ra, ia, aa = step(e_ref, w, agg, **kw)
            rb, ib, ab = step(e_port, w, agg, **kw)
        else:
            ra, rb = (e.query(w, agg, "a0", **kw) for e in (e_ref, e_port))
            ia = ib = aa = ab = None
        assert_fields_equal(fields(ra), fields(rb))
        assert (ia, aa) == (ib, ab)
    assert_fingerprints_equal(fingerprint(e_ref.index),
                              fingerprint(e_port.index))


@pytest.mark.parametrize("sequential", [False, True],
                         ids=["batched", "sequential"])
@pytest.mark.parametrize("phi", PHIS)
@pytest.mark.parametrize("agg", AGGS)
def test_port_np_equals_reference(agg, phi, sequential):
    e_ref, e_port = engines(5, "np")
    wins = ref_path(e_ref.dataset, n_queries=3, target_objects=4000)
    assert_np_session_equal(e_ref, e_port, [
        ("heatmap", w, agg, dict(bins=BINS, phi=phi, sequential=sequential))
        for w in wins])


@pytest.mark.parametrize("sequential", [False, True],
                         ids=["batched", "sequential"])
@pytest.mark.parametrize("phi", PHIS)
@pytest.mark.parametrize("agg", AGGS)
def test_port_torch_matches_reference(agg, phi, sequential):
    e_ref, e_port = engines(5, "torch")
    wins = ref_path(e_ref.dataset, n_queries=3, target_objects=4000)
    for w in wins:
        ra, ia, aa = step(e_ref, w, agg, bins=BINS, phi=phi,
                          sequential=sequential)
        rb, ib, ab = step(e_port, w, agg, bins=BINS, phi=phi,
                          sequential=sequential)
        assert (ia, aa) == (ib, ab)
        for f in ("exact", "tiles_full", "tiles_partial", "tiles_processed",
                  "objects_read", "read_calls", "batch_rounds",
                  "speculative_rows"):
            assert getattr(rb, f) == getattr(ra, f), f
        for f in ("values", "lo", "hi"):
            np.testing.assert_allclose(getattr(rb, f), getattr(ra, f),
                                       rtol=VALUE_RTOL, atol=VALUE_RTOL)
        truth = e_port.heatmap_oracle(w, agg, "a0", bins=BINS)
        np.testing.assert_allclose(
            truth, e_ref.heatmap_oracle(w, agg, "a0", bins=BINS),
            rtol=VALUE_RTOL, atol=VALUE_RTOL)
        fin = np.isfinite(truth)
        tol = VALUE_RTOL * np.maximum(1.0, np.abs(truth[fin]))
        assert (rb.lo[fin] - tol <= truth[fin]).all()
        assert (truth[fin] <= rb.hi[fin] + tol).all()
        assert rb.exact or rb.bound <= phi + 1e-12
    ia, ib = index_to_numpy(e_ref.index), index_to_numpy(e_port.index)
    assert ia["n_tiles"] == ib["n_tiles"]
    for k in ("perm", "count", "bbox"):
        np.testing.assert_array_equal(ia[k], ib[k])
    for k in ("meta_min", "meta_max"):
        np.testing.assert_array_equal(ia[k]["a0"], ib[k]["a0"])
    np.testing.assert_allclose(ib["meta_sum"]["a0"], ia["meta_sum"]["a0"],
                               rtol=VALUE_RTOL, atol=VALUE_RTOL)
    e_port.index.check_invariants("a0")


POLICIES = {
    "floored": dict(weights=np.linspace(0.5, 2.0, 16), eps_abs=0.5),
    "salience": dict(salience="center", salience_floor=0.3),
}


@pytest.mark.parametrize("backend", ["np", "torch"])
@pytest.mark.parametrize("policy", list(POLICIES))
def test_policy_heatmaps_match_reference(policy, backend):
    """A floored and a salience ``AccuracyPolicy`` (seeds of
    ``tests/test_accuracy_policy.py``): "np" bit for bit, "torch" with
    equal reads, equal per-bin verdicts and every budget met."""
    e_ref, e_port = engines(13, backend)
    wins = ref_path(e_ref.dataset, n_queries=3, target_objects=6000)
    kw = dict(bins=BINS, phi=0.05, sequential=False)
    if backend == "np":
        for w in wins:
            ra, ia, aa = step(e_ref, w, "mean",
                              policy=RefPolicy(**POLICIES[policy]), **kw)
            rb, ib, ab = step(e_port, w, "mean",
                              policy=AccuracyPolicy(**POLICIES[policy]),
                              **kw)
            assert_fields_equal(fields(ra), fields(rb))
            assert (ia, aa) == (ib, ab)
        assert_fingerprints_equal(fingerprint(e_ref.index),
                                  fingerprint(e_port.index))
        return
    for w in wins:
        ra = e_ref.heatmap(w, "mean", "a0",
                           policy=RefPolicy(**POLICIES[policy]), **kw)
        rb = e_port.heatmap(w, "mean", "a0",
                            policy=AccuracyPolicy(**POLICIES[policy]), **kw)
        assert (rb.objects_read, rb.tiles_processed) == \
            (ra.objects_read, ra.tiles_processed)
        np.testing.assert_array_equal(rb.phi_b, ra.phi_b)
        np.testing.assert_array_equal(rb.bin_met, ra.bin_met)
        assert rb.bin_met.all()
    e_port.index.check_invariants("a0")


@pytest.mark.parametrize("slots", [1, 4])
@pytest.mark.parametrize("backend", ["np", "torch"])
def test_repeated_viewport_reads_nothing(backend, slots):
    """Session bin-grid memory, on the setup of ``tests/test_chunked.py``
    (splitting exhausted): a repeated viewport answers with zero reads,
    and so does a return to it after an interleaved second viewport when
    the LRU holds more than one registry — as in the reference."""
    e_ref, e_port = engines(9, backend, n=10_000, min_split_count=100_000,
                            bin_memory_slots=slots)
    wa = (200.0, 200.0, 700.0, 700.0)
    wb = (210.0, 200.0, 710.0, 700.0)
    reads = []
    for w in (wa, wa, wb, wa):
        ra = e_ref.heatmap(w, "mean", "a0", bins=BINS, phi=0.0)
        rb = e_port.heatmap(w, "mean", "a0", bins=BINS, phi=0.0)
        if backend == "np":
            assert_fields_equal(fields(ra), fields(rb))
        else:
            np.testing.assert_allclose(rb.values, ra.values,
                                       rtol=VALUE_RTOL)
        assert (rb.objects_read, rb.read_calls) == \
            (ra.objects_read, ra.read_calls)
        reads.append(rb.objects_read)
    assert reads[0] > 0 and reads[1] == 0 and reads[2] > 0
    assert (reads[3] == 0) == (slots > 1)
    regs = index_to_numpy(e_port.index)["hm_regs"]
    assert [k for k, _ in regs] == [
        k for k, _ in index_to_numpy(e_ref.index)["hm_regs"]]


def test_mixed_scalar_and_heatmap_session():
    """Scalar queries and heatmaps share one index and one trace; the
    trace's per-type totals equal the reference's."""
    e_ref, e_port = engines(29, "np")
    wins = ref_path(e_ref.dataset, n_queries=3, target_objects=6000)
    calls = []
    for w in wins:
        calls += [("query", w, "sum", dict(phi=0.05)),
                  ("heatmap", w, "mean", dict(bins=BINS, phi=0.05)),
                  ("query", w, "max", dict(phi=0.0))]
    assert_np_session_equal(e_ref, e_port, calls)
    ta, tb = e_ref.trace.totals(), e_port.trace.totals()
    assert ta.keys() == tb.keys()
    for k in ta:
        if not k.endswith("time_s"):
            assert ta[k] == tb[k], k
    assert tb["heatmap_queries"] == 3 and tb["scalar_queries"] == 6
    assert isinstance(e_port.trace.results[1], HeatmapResult)
    assert e_port.trace.trajectory[1].bins == BINS


@pytest.mark.parametrize("agg", AGGS)
def test_oracle_on_device_path_matches_reference(agg):
    """``heatmap_oracle`` off tensors (the keyed float64 reduction the
    chip smoke uses at 10⁸ rows) against the reference's per-bin loop."""
    e_ref, e_port = engines(11, "torch")
    for w in ref_path(e_ref.dataset, n_queries=2, target_objects=5000):
        got = e_port.heatmap_oracle(w, agg, "a0", bins=(5, 3))
        want = e_ref.heatmap_oracle(w, agg, "a0", bins=(5, 3))
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), fin)
        np.testing.assert_allclose(got[fin], want[fin], rtol=VALUE_RTOL)


@pytest.mark.parametrize("backend", ["np", "torch"])
def test_learned_salience_matches_reference(backend):
    """Heatmaps under ``salience="learned"`` (resolved from the session's
    dwell histogram before each evaluation): "np" every field bit for
    bit, "torch" counts, reads and φ_b equal, values to
    ``VALUE_RTOL``."""
    e_ref, e_port = engines(5, backend, n=5_000)
    wins = ref_path(e_ref.dataset, n_queries=5, target_objects=1500, seed=3)
    for i, w in enumerate(wins):
        kw = dict(bins=BINS, phi=0.05, dwell_s=1.0 + i % 2)
        ra = e_ref.heatmap(w, "sum", "a0",
                           policy=RefPolicy(salience="learned"), **kw)
        rb = e_port.heatmap(w, "sum", "a0",
                            policy=AccuracyPolicy(salience="learned"), **kw)
        a, b = fields(ra), fields(rb)
        np.testing.assert_array_equal(b.pop("phi_b"), a.pop("phi_b"))
        if backend == "np":
            assert_fields_equal(a, b)
            continue
        for k in ("values", "lo", "hi", "bin_bound", "bound"):
            np.testing.assert_allclose(b.pop(k), a.pop(k), rtol=VALUE_RTOL)
        assert_fields_equal(a, b)


@pytest.mark.parametrize("backend", ["np", "torch"])
def test_repeat_after_policy_session_matches_reference(backend):
    """The chip smoke's heatmap session at a small size, splitting on: an
    exploration path at φ = 0.05 and φ = 0, policy heatmaps on other
    viewports (enough to push the last viewport's registry out of the
    4-slot LRU), then the last viewport repeated. The first repeat reads
    again — evicted registry, and children of later splits have no entry
    — and each repeat reads only the children the one before split, down
    to zero; the reference gives the same sequence."""
    e_ref, e_port = engines(9, backend, n=100_000, min_split_count=128)
    wins = ref_path(e_ref.dataset, n_queries=8, target_objects=5000, seed=11)
    seqs = []
    for e, policy in ((e_ref, RefPolicy), (e_port, AccuracyPolicy)):
        for phi in (0.05, 0.0):
            for w in wins:
                e.heatmap(w, "mean", "a0", bins=(8, 8), phi=phi)
        for w in wins[:6]:
            e.heatmap(w, "mean", "a0", bins=(8, 8), phi=0.05,
                      policy=policy(eps_abs=0.5))
        reads = []
        for _ in range(16):
            reads.append(e.heatmap(wins[-1], "mean", "a0", bins=(8, 8),
                                   phi=0.0).objects_read)
            if reads[-1] == 0:
                break
        seqs.append(reads)
    assert seqs[0] == seqs[1]
    assert seqs[1][0] > 0 and seqs[1][-1] == 0
    assert all(a >= b for a, b in zip(seqs[1], seqs[1][1:]))
