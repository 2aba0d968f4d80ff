"""The port's viewport prediction and predictive pre-cracking —
``ViewportPredictor``, ``prefetch_crack``, learned salience and their
hooks in ``AQPEngine`` and ``ServingEngine`` — against the reference
package, on the scenarios of ``tests/test_predict.py`` (n = 60 000,
grid0 (8, 8), ``min_split_count=256``) and the prefetch cases of
``tests/test_serving.py``, and the port's B9 against the reference's.

- The predictor's host code (trajectory, the linear candidate, features,
  hit-rates, the salience map) is the reference's float64 numpy: bit for
  bit. Its MLP starts from the reference's weights bit for bit and is
  float32 on its own device; after every observation from the same
  weights its parameters agree to ``rtol=1e-5, atol=1e-6`` (tanh and
  products round differently). Over a whole session the hits, sources
  and ``n_trained`` are equal, and so are the parameters to that
  tolerance on a pan and a zoom; on the random walk they drift further
  (ROADMAP C.10).
- Port ``"np"`` ≡ reference, bit for bit: every result field but the
  wall time, the prefetch reports, the ``IOStats`` and ``AdaptStats``
  deltas, and the index fingerprint.
- Port ``"torch"`` on CPU tensors: every record equal but values,
  interval ends, bounds and sums, which agree to ``VALUE_RTOL`` (float64
  sums in another order); reads, splits and ``perm`` are equal.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import AccuracyPolicy as RefPolicy
from repro.core import ServingEngine as RefServing
from repro.core import query as ref_query
from repro.core.predict import ViewportPredictor as RefPredictor
from repro.core.predict import _mlp_init as ref_mlp_init
from repro.core.predict import resolve_learned_salience as ref_resolve
from repro.data.chunked import ChunkedDataset as RefChunked
from repro.data.rawfile import RawDataset as RefDataset
from repro_torch.benchmarks import common
from repro_torch.benchmarks import predictive_exploration as port_b9
from repro_torch.core import (AccuracyPolicy, ServingEngine,
                              ViewportPredictor, predictor_from_numpy,
                              predictor_to_numpy)
from repro_torch.core import query as port_query
from repro_torch.core.predict import _mlp_init, _params_on
from repro_torch.core.predict import resolve_learned_salience
from repro_torch.data import ChunkedDataset
from repro_torch.data.rawfile import RawDataset
from test_torch_chunked import VALUE_RTOL, Pkg, Rec, same

PHI = 0.05
# the MLP's float32 parameters after an observation from equal weights
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-6
KW = dict(grid0=(8, 8), min_split_count=256, init_metadata_attrs=("a0",))


def policy(P, **kw):
    return (RefPolicy if P.ref else AccuracyPolicy)(**kw)


def resolver(P):
    return ref_resolve if P.ref else resolve_learned_salience


def engine(P, n=60_000, seed=3):
    """tests/test_predict.py:31."""
    return P.engine(P.synthetic(n=n, seed=seed), P.cfg(**KW))


def linear_pan(n_steps, step=(40.0, 30.0), start=(100.0, 120.0),
               size=(300.0, 300.0)):
    """tests/test_predict.py:38."""
    sx, sy = step
    x0, y0 = start
    w, h = size
    return [(x0 + sx * i, y0 + sy * i, x0 + sx * i + w, y0 + sy * i + h)
            for i in range(n_steps)]


def zoom():
    """tests/test_predict.py:73."""
    return [(100.0 + 10 * i, 100.0 + 10 * i, 900.0 - 10 * i, 900.0 - 10 * i)
            for i in range(8)]


def random_walk():
    """tests/test_predict.py:87."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(25):
        x, y = rng.uniform(100, 800, 2)
        out.append((x, y, x + 150.0, y + 150.0))
    return out


SCRIPTS = {"linear_pan": lambda: linear_pan(10), "zoom": zoom,
           "random_walk": random_walk}


def host_params(p):
    return predictor_to_numpy(p)["params"]


def assert_params_close(ref, port, what):
    a, b = host_params(ref), host_params(port)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=f"{what} {k}")


def assert_host_state_equal(ref, port, probe):
    """Everything of the two predictors that is host float64 numpy, bit
    for bit, and the candidates' bookkeeping."""
    assert [dataclasses.astuple(s) for s in port.trajectory] == \
        [dataclasses.astuple(s) for s in ref.trajectory]
    assert port._linear_pred() == ref._linear_pred()
    fa, fb = ref._features(), port._features()
    assert (fa is None and fb is None) or np.array_equal(fa, fb)
    for k in ("linear", "model"):
        assert list(port._hits[k]) == list(ref._hits[k]), k
        assert port.hit_rate(k) == ref.hit_rate(k)
    assert port.n_trained == ref.n_trained
    np.testing.assert_array_equal(port.salience_map(probe, (4, 3)),
                                  ref.salience_map(probe, (4, 3)))


# --------------------------------------------------------------------- #
# the predictor
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("history", [1, 3, 5])
def test_mlp_init_matches_reference(history):
    """The seeded host draws, cast to float32: bit for bit."""
    want = ref_mlp_init(history)
    got = _mlp_init(history, "cpu")
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].detach().numpy(),
                                      np.asarray(want[k]))
        assert got[k].dtype.itemsize == 4 and got[k].requires_grad


@pytest.mark.parametrize("script", SCRIPTS)
def test_observation_matches_reference(script):
    """Each observation from the reference's weights: the port's SGD
    steps land within float32 rounding of the reference's."""
    ref, port = RefPredictor(), ViewportPredictor(device="cpu")
    for i, w in enumerate(SCRIPTS[script]()):
        port._params = _params_on(host_params(ref), port.device)
        ref.observe(w, bins=(4, 4))
        port.observe(w, bins=(4, 4))
        assert_params_close(ref, port, f"observation {i}")


@pytest.mark.parametrize("script", SCRIPTS)
def test_session_matches_reference(script):
    """A whole session on both predictors: the host state bit for bit
    after every observation, the same predictions, sources, hits and
    ``n_trained``; the parameters within float32 rounding on the pan and
    the zoom (on the random walk they drift, ROADMAP C.10)."""
    ref, port = RefPredictor(), ViewportPredictor(device="cpu")
    probe = (50.0, 80.0, 700.0, 650.0)
    for i, w in enumerate(SCRIPTS[script]()):
        ref.observe(w, bins=(4, 4), dwell_s=1.0 + i % 3)
        port.observe(w, bins=(4, 4), dwell_s=1.0 + i % 3)
        assert_host_state_equal(ref, port, probe)
        if script != "random_walk":
            assert_params_close(ref, port, f"observation {i}")
        pa, pb = ref.predict(), port.predict()
        assert port.source == ref.source
        if ref.source == "model":
            np.testing.assert_allclose(pb, pa, rtol=1e-5)
        else:
            assert pb == pa


def test_predictor_carried_from_reference_continues():
    """Five pan steps in the reference, carried into the port by
    ``predictor_from_numpy``; five more steps in both agree as in a
    session, and the carried state reads back unchanged."""
    wins = linear_pan(10)
    ref = RefPredictor(roll=8)
    for w in wins[:5]:
        ref.observe(w, bins=(4, 4), dwell_s=2.0)
    state = predictor_to_numpy(ref)
    port = predictor_from_numpy(state, device="cpu")
    back = predictor_to_numpy(port)
    for k in ("history", "hit_iou", "lr", "train_steps", "trajectory",
              "hits", "source", "n_trained"):
        assert back[k] == state[k], k
    for k in state["params"]:
        np.testing.assert_array_equal(back["params"][k], state["params"][k])
    assert port._hits["model"].maxlen == 8
    for w in wins[5:]:
        ref.observe(w, bins=(4, 4), dwell_s=2.0)
        port.observe(w, bins=(4, 4), dwell_s=2.0)
        assert_host_state_equal(ref, port, (100.0, 100.0, 800.0, 800.0))
        assert_params_close(ref, port, "carried")
        assert port.predict() == ref.predict()
        assert port.source == ref.source


# --------------------------------------------------------------------- #
# the scenarios of tests/test_predict.py, on either package
# --------------------------------------------------------------------- #

def s_linear_pan_extrapolation_exact(P, rec):
    p = engine(P, n=1_000).predictor
    wins = linear_pan(10)
    for i, w in enumerate(wins[:-1]):
        p.observe(w, bins=(4, 4))
        pred = p.predict()
        rec.append((f"pred {i}", (pred, p.source)))
        if i == 0:
            assert pred is None
        else:
            assert p.source == "linear"
            assert pred == wins[i + 1]
    assert p.hit_rate("linear") == 1.0


def s_zoom_is_linear_in_window_coordinates(P, rec):
    p = engine(P, n=1_000).predictor
    wins = zoom()
    for w in wins[:-1]:
        p.observe(w)
    rec.append(("pred", p.predict()))
    assert rec[-1][1] == wins[-1] and p.source == "linear"


def s_model_fallback_on_random_walk(P, rec):
    p = engine(P, n=1_000).predictor
    for i, w in enumerate(random_walk()):
        p.observe(w)
        if p.predict() is not None:
            assert p.source == "linear"
        rec.append((f"step {i}", (p.source, list(p._hits["linear"]),
                                  list(p._hits["model"]))))
    assert len(p.trajectory) == 25
    assert p.hit_rate("model") <= p.hit_rate("linear")


def s_observe_records_trajectory_and_trains_online(P, rec):
    p = engine(P, n=1_000).predictor
    for w in linear_pan(6):
        p.observe(w, bins=(8, 8), dwell_s=2.0)
    assert len(p.trajectory) == 6
    assert all(s.bins == (8, 8) and s.dwell_s == 2.0 for s in p.trajectory)
    assert p.n_trained == 6 - (3 + 1)
    rec.append(("trajectory", [dataclasses.astuple(s)
                               for s in p.trajectory]))


def s_salience_map_dwell_histogram_properties(P, rec):
    p = engine(P, n=1_000).predictor
    q = (0.0, 0.0, 400.0, 400.0)
    np.testing.assert_array_equal(p.salience_map(q, (4, 4)), np.ones(16))
    p.observe((0.0, 0.0, 200.0, 200.0), dwell_s=5.0)
    p.observe((600.0, 600.0, 900.0, 900.0), dwell_s=1.0)
    s = p.salience_map(q, (2, 2), floor=0.25)
    assert s.shape == (4,)
    assert ((s >= 0.25) & (s <= 1.0)).all()
    assert s[0] == 1.0
    np.testing.assert_allclose(s[1:], 0.25)
    rec.append(("map", s))


def s_prefetch_exact_answers_bit_identical(P, rec):
    reactive, pred = engine(P), engine(P)
    wins = linear_pan(8)
    ra, rb = [], []
    for i, w in enumerate(wins):
        ra.append(rec.step(f"reactive {i}", reactive, lambda: reactive
                           .heatmap(w, "mean", "a0", bins=(4, 4), phi=0.0)))
        rec.append((f"prefetch {i}", pred.prefetch(5_000)))
        rb.append(rec.step(f"pred {i}", pred, lambda: pred.heatmap(
            w, "mean", "a0", bins=(4, 4), phi=0.0)))
    for a, b in zip(ra, rb):
        np.testing.assert_array_equal(a.values, b.values)
        np.testing.assert_array_equal(a.lo, b.lo)
        np.testing.assert_array_equal(a.hi, b.hi)
        assert a.exact and b.exact
    assert (sum(r.objects_read for r in rb)
            < sum(r.objects_read for r in ra))
    qa = rec.step("qa", reactive, lambda: reactive.query(wins[-1], "sum",
                                                         "a0", phi=0.0))
    qb = rec.step("qb", pred, lambda: pred.query(wins[-1], "sum", "a0",
                                                 phi=0.0))
    assert qa.value == qb.value and qa.lo == qb.lo and qa.hi == qb.hi
    rec.append(("fingerprint", index_state(pred.index)))


def s_prefetch_approximate_answers_stay_contained(P, rec):
    eng = engine(P)
    for i, w in enumerate(linear_pan(8)):
        rec.append((f"prefetch {i}", eng.prefetch(4_000)))
        h = rec.step(f"h {i}", eng, lambda: eng.heatmap(
            w, "mean", "a0", bins=(4, 4), phi=PHI))
        assert h.exact or h.bound <= PHI + 1e-12
        truth = eng.heatmap_oracle(w, "mean", "a0", bins=(4, 4))
        occ = eng.heatmap_oracle(w, "count", "a0", bins=(4, 4)) > 0
        assert (h.lo[occ] - 1e-9 <= truth[occ]).all()
        assert (truth[occ] <= h.hi[occ] + 1e-9).all()
    rec.append(("fingerprint", index_state(eng.index)))


def s_prefetch_budget_is_hard_and_speculation_free(P, rec):
    eng = engine(P)
    wins = linear_pan(6)
    for i, w in enumerate(wins[:3]):
        rec.step(f"h {i}", eng, lambda: eng.heatmap(w, "mean", "a0",
                                                    bins=(4, 4), phi=PHI))
    spec_before = eng.adapt_stats.speculative_rows
    r = eng.prefetch(2_500)
    rec.append(("prefetch", r))
    assert r["source"] in ("linear", "model")
    assert 0 < r["rows_read"] <= 2_500
    assert r["tiles_cracked"] > 0
    assert eng.adapt_stats.speculative_rows == spec_before
    assert eng.trace.prefetches[-1] is r
    assert eng.trace.totals()["prefetch_rows"] == r["rows_read"]
    rec.append(("fingerprint", index_state(eng.index)))


def s_prefetch_without_trajectory_is_a_no_op(P, rec):
    eng = engine(P)
    r = eng.prefetch(10_000)
    assert r["predicted"] is None and r["rows_read"] == 0
    eng.heatmap((100, 100, 400, 400), "mean", "a0", bins=(4, 4))
    r2 = eng.prefetch(10_000)
    assert r2["predicted"] is None and r2["rows_read"] == 0
    rec.append(("prefetches", [r, r2]))


def s_prefetch_warms_bin_grid_memory_for_predicted_viewport(P, rec):
    reactive, pred = engine(P), engine(P)
    wins = linear_pan(6)
    for w in wins[:-1]:
        reactive.heatmap(w, "mean", "a0", bins=(4, 4), phi=0.0)
        pred.heatmap(w, "mean", "a0", bins=(4, 4), phi=0.0)
    rec.append(("prefetch", pred.prefetch(60_000)))
    r_react = rec.step("reactive", reactive, lambda: reactive.heatmap(
        wins[-1], "mean", "a0", bins=(4, 4), phi=0.0))
    r_pred = rec.step("pred", pred, lambda: pred.heatmap(
        wins[-1], "mean", "a0", bins=(4, 4), phi=0.0))
    np.testing.assert_array_equal(r_react.values, r_pred.values)
    assert r_pred.objects_read < r_react.objects_read
    rec.append(("fingerprint", index_state(pred.index)))


def s_learned_salience_budgets_met_zero_speculation(P, rec):
    eng = engine(P)
    pol = policy(P, salience="learned", eps_abs=1e-3)
    for i, w in enumerate(linear_pan(5)):
        h = rec.step(f"h {i}", eng, lambda: eng.heatmap(
            w, "mean", "a0", bins=(4, 4), phi=0.1, policy=pol, dwell_s=1.5))
        assert h.speculative_rows == 0
        assert h.phi_b is not None and h.bin_met is not None
        occ = np.asarray(h.values) != 0
        assert np.asarray(h.bin_met)[occ].all()


def s_learned_salience_resolves_from_dwell_history(P, rec):
    eng = engine(P)
    stay = (100.0, 100.0, 300.0, 300.0)
    for i in range(3):
        rec.step(f"h {i}", eng, lambda: eng.heatmap(stay, "mean", "a0",
                                                    bins=(4, 4), phi=PHI))
    pol = policy(P, salience="learned")
    q = (100.0, 100.0, 500.0, 500.0)
    resolve = resolver(P)
    resolved = resolve(pol, eng.predictor, q, (2, 2))
    assert isinstance(resolved.salience, np.ndarray)
    phi_b = resolved.phi_b(PHI, (2, 2))
    assert phi_b[0] == pytest.approx(PHI)
    assert phi_b[3] == pytest.approx(PHI / pol.salience_floor)
    rec.append(("resolved", (resolved.salience, phi_b)))
    assert resolve(None, eng.predictor, q, (2, 2)) is None
    keep = policy(P, salience="center")
    assert resolve(keep, eng.predictor, q, (2, 2)) is keep


def s_unresolved_learned_salience_rejected_off_engine(P, rec):
    eng = engine(P, n=10_000)
    pol = policy(P, salience="learned")
    mod = ref_query if P.ref else port_query
    with pytest.raises(ValueError, match="resolved") as e:
        mod.evaluate_heatmap(eng.index, (100, 100, 400, 400), "mean", "a0",
                             bins=(4, 4), phi=PHI, policy=pol)
    rec.append(("message", str(e.value).replace("repro_torch.", "repro.")))


def index_state(index):
    """The index fingerprint of tests/test_serving.py:77 (tile table,
    permutation, metadata), a live forest's chunk by chunk."""
    from repro_torch.core import forest_to_numpy, index_to_numpy
    if hasattr(index, "_indexes"):
        return forest_to_numpy(index)
    return index_to_numpy(index)


SCENARIOS = {
    "linear_pan_extrapolation_exact": s_linear_pan_extrapolation_exact,
    "zoom_is_linear_in_window_coordinates":
        s_zoom_is_linear_in_window_coordinates,
    "model_fallback_on_random_walk": s_model_fallback_on_random_walk,
    "observe_records_trajectory_and_trains_online":
        s_observe_records_trajectory_and_trains_online,
    "salience_map_dwell_histogram_properties":
        s_salience_map_dwell_histogram_properties,
    "prefetch_exact_answers_bit_identical":
        s_prefetch_exact_answers_bit_identical,
    "prefetch_approximate_answers_stay_contained":
        s_prefetch_approximate_answers_stay_contained,
    "prefetch_budget_is_hard_and_speculation_free":
        s_prefetch_budget_is_hard_and_speculation_free,
    "prefetch_without_trajectory_is_a_no_op":
        s_prefetch_without_trajectory_is_a_no_op,
    "prefetch_warms_bin_grid_memory_for_predicted_viewport":
        s_prefetch_warms_bin_grid_memory_for_predicted_viewport,
    "learned_salience_budgets_met_zero_speculation":
        s_learned_salience_budgets_met_zero_speculation,
    "learned_salience_resolves_from_dwell_history":
        s_learned_salience_resolves_from_dwell_history,
    "unresolved_learned_salience_rejected_off_engine":
        s_unresolved_learned_salience_rejected_off_engine,
}
# the predictor-only scenarios touch no index: "np" alone
HOST_ONLY = {"linear_pan_extrapolation_exact",
             "zoom_is_linear_in_window_coordinates",
             "model_fallback_on_random_walk",
             "observe_records_trajectory_and_trains_online",
             "salience_map_dwell_histogram_properties"}
CASES = [(name, b) for name in SCENARIOS
         for b in (["np"] if name in HOST_ONLY else ["np", "torch"])]


def compare(ra, rb, backend):
    assert [lab for lab, _ in ra] == [lab for lab, _ in rb]
    rtol = 0.0 if backend == "np" else VALUE_RTOL
    for (label, a), (_, b) in zip(ra, rb):
        same(a, b, rtol, label)


def run_both(fn, backend):
    got = []
    for P in (Pkg(), Pkg(backend)):
        rec = Rec()
        fn(P, rec)
        got.append(rec)
    return got


@pytest.mark.parametrize("scenario,backend", CASES,
                         ids=[f"{n}-{b}" for n, b in CASES])
def test_port_matches_reference(scenario, backend):
    """Each scenario with its own assertions on both packages, every
    record compared ("np" exactly; "torch" sums to ``VALUE_RTOL``)."""
    compare(*run_both(SCENARIOS[scenario], backend), backend)


# --------------------------------------------------------------------- #
# predictive pre-cracking over a chunk forest
# --------------------------------------------------------------------- #

def s_chunk_prefetch(P, rec, close_chunk):
    """Heatmaps pan across three x-slab chunks; each step prefetches the
    predicted viewport. With ``close_chunk`` the first chunk's storage
    closes before the last prefetch: its tiles are dropped mid-prefetch
    (the chunk retired under it) and the live chunks still crack."""
    cds, _ = P.streaming(n_chunks=3, rows=12_000, ingest=3, seed=5)
    eng = P.engine(cds, P.cfg(grid0=(6, 6), min_split_count=64,
                              init_metadata_attrs=("a0",)))
    wins = linear_pan(5, step=(60.0, 20.0), start=(100.0, 200.0),
                      size=(420.0, 380.0))
    for i, w in enumerate(wins):
        rec.step(f"h {i}", eng, lambda: eng.heatmap(w, "mean", "a0",
                                                    bins=(4, 4), phi=PHI))
        if close_chunk and i == len(wins) - 1:
            cds.chunk(0).data.close()
        spec = eng.adapt_stats.speculative_rows
        r = eng.prefetch(3_000)
        rec.append((f"prefetch {i}", r))
        assert r["rows_read"] <= 3_000
        assert eng.adapt_stats.speculative_rows == spec
    last = eng.trace.prefetches[-1]
    assert last["rows_read"] > 0
    if close_chunk:
        assert last["tiles_cracked"] < last["tiles_pending"]
    rec.forest("end", eng.index)


@pytest.mark.parametrize("close_chunk", [False, True],
                         ids=["live", "retired_mid_prefetch"])
@pytest.mark.parametrize("backend", ["np", "torch"])
def test_chunk_forest_prefetch_matches_reference(backend, close_chunk):
    compare(*run_both(lambda P, rec: s_chunk_prefetch(P, rec, close_chunk),
                      backend), backend)


# --------------------------------------------------------------------- #
# serving with prefetch (tests/test_serving.py:343-418)
# --------------------------------------------------------------------- #

def serving_data(n=60_000, seed=0):
    """tests/test_serving.py:21."""
    rng = np.random.default_rng(seed)
    xs = rng.uniform(0, 1000, n)
    ys = rng.uniform(0, 1000, n)
    a0 = (xs / 10 + rng.normal(0, 5, n) + 100).astype(np.float64)
    return xs, ys, a0


def server(P, *, chunked=False, **kw):
    """tests/test_serving.py:29 on either package."""
    xs, ys, a0 = serving_data()
    if P.ref:
        ds = RefDataset(xs, ys, {"a0": a0})
        ds = RefChunked.from_dataset(ds) if chunked else ds
        return RefServing(P.engine(ds, P.cfg(**KW)), **kw)
    ds = RawDataset(xs, ys, {"a0": a0}, device=P.device)
    ds = ChunkedDataset.from_dataset(ds) if chunked else ds
    return ServingEngine(P.engine(ds, P.cfg(**KW)), **kw)


def pan_script(sv, rec, tag, n_ticks=4, phi=PHI):
    """tests/test_serving.py:343: two sessions' heatmaps panning."""
    a = sv.open_session("A")
    b = sv.open_session("B")
    out = []
    for i in range(n_ticks):
        wa = (100 + 40 * i, 100 + 30 * i, 380 + 40 * i, 380 + 30 * i)
        wb = (500 - 20 * i, 500 + 10 * i, 800 - 20 * i, 800 + 10 * i)
        a.heatmap(wa, "mean", "a0", bins=(4, 4), phi=phi)
        b.heatmap(wb, "mean", "a0", bins=(4, 4), phi=phi)
        rs = sv.tick()
        for j, r in enumerate(rs):
            rec.result(f"{tag} tick {i} answer {j}", r)
        rec.append((f"{tag} tick {i} prefetch", sv.last_prefetch))
        rec.append((f"{tag} tick {i} publish", dict(sv.last_publish)))
        out.extend(rs)
    rec.append((f"{tag} fingerprint", index_state(sv.index)))
    return out


def s_prefetch_keeps_batched_sequential_parity(P, rec, chunked):
    sa = server(P, chunked=chunked, mode="batched", crack_budget=8,
                prefetch_rows=3_000)
    sb = server(P, chunked=chunked, mode="sequential", crack_budget=8,
                prefetch_rows=3_000)
    ra = pan_script(sa, rec, "batched")
    rb = pan_script(sb, rec, "sequential")
    for x, y in zip(ra, rb):
        np.testing.assert_array_equal(x.values, y.values)
        np.testing.assert_array_equal(x.bin_bound, y.bin_bound)
        assert x.tiles_processed == y.tiles_processed
    assert sa.last_publish == sb.last_publish
    assert [p["session"] for p in sa.last_prefetch] == ["A", "B"]
    assert sa.last_prefetch == sb.last_prefetch


def s_prefetch_never_alters_served_answers(P, rec):
    s_on = server(P, mode="batched", prefetch_rows=4_000)
    s_off = server(P, mode="batched", prefetch_rows=None)
    r_on = pan_script(s_on, rec, "on", phi=0.0)
    r_off = pan_script(s_off, rec, "off", phi=0.0)
    assert any(p["rows_read"] > 0 for p in s_on.last_prefetch)
    for x, y in zip(r_on, r_off):
        np.testing.assert_array_equal(x.values, y.values)
        np.testing.assert_array_equal(x.lo, y.lo)
        np.testing.assert_array_equal(x.hi, y.hi)
        assert x.exact and y.exact
    assert (sum(r.objects_read for r in r_on)
            < sum(r.objects_read for r in r_off))


def s_prefetch_consumes_only_leftover_budget(P, rec):
    sv = server(P, mode="batched", crack_budget=2, prefetch_rows=4_000)
    pan_script(sv, rec, "budget 2")
    assert sv.last_prefetch == []


SERVING = {
    "parity_legacy": lambda P, rec:
        s_prefetch_keeps_batched_sequential_parity(P, rec, False),
    "parity_chunked": lambda P, rec:
        s_prefetch_keeps_batched_sequential_parity(P, rec, True),
    "never_alters_served_answers": s_prefetch_never_alters_served_answers,
    "consumes_only_leftover_budget":
        s_prefetch_consumes_only_leftover_budget,
}


@pytest.mark.parametrize("backend", ["np", "torch"])
@pytest.mark.parametrize("case", SERVING)
def test_serving_prefetch_matches_reference(case, backend):
    """The reference test's assertions on both packages; "np" bit for
    bit with the reference (answers, prefetch reports, publication,
    index), "torch" with sums to ``VALUE_RTOL`` — on the host the float64
    sums of both tick modes are equal, so the port's batched ≡
    sequential holds exactly under either backend."""
    compare(*run_both(SERVING[case], backend), backend)


def test_learned_salience_serving_resolves_before_observing():
    """A learned-salience ticket is resolved from the session's PAST
    viewports at submit time, then observed: its φ_b is the one
    ``resolve_learned_salience`` gives over the trajectory before it,
    and the reference serves the same answers ("np")."""
    got = []
    for P in (Pkg(), Pkg("np")):
        sv = server(P)
        s = sv.open_session("A")
        pol = policy(P, salience="learned", eps_abs=1e-3)
        wins = linear_pan(4)
        rec = Rec()
        for i, w in enumerate(wins):
            want = resolver(P)(pol, s.predictor, w, (4, 4))
            tk = s.heatmap(w, "mean", "a0", bins=(4, 4), phi=0.1,
                           policy=pol, dwell_s=1.0 + i)
            np.testing.assert_array_equal(tk.policy.salience, want.salience)
            assert len(s.predictor.trajectory) == i + 1
            sv.tick()
            rec.result(f"h {i}", tk.result)
            assert tk.result.bin_met.all()
        got.append(rec)
    compare(*got, "np")


# --------------------------------------------------------------------- #
# B9: the port's bench against the reference's
# --------------------------------------------------------------------- #

@pytest.fixture
def smoke(monkeypatch):
    monkeypatch.setattr(common, "EMITTED", [])
    for k in ("SMOKE", "N_ROWS", "N_QUERIES", "TARGET_OBJECTS"):
        monkeypatch.setattr(common, k, getattr(common, k))
    common.configure_smoke()
    return common


def baseline_counters():
    """``experiments/BENCH_baseline.json``'s B9 rows: name -> derived
    fields."""
    import json
    import pathlib
    path = (pathlib.Path(__file__).resolve().parents[1] / "experiments"
            / "BENCH_baseline.json")
    rows = json.loads(path.read_text())["rows"]
    return {r["name"]: dict(kv.split("=") for kv in r["derived"].split(";"))
            for r in rows if r["name"].startswith("predictive_")}


@pytest.mark.parametrize("backend", ["np", "torch"])
def test_b9_smoke_reproduces_reference_counters(smoke, backend, monkeypatch):
    """The port's B9 at smoke size (its gate and neutrality check
    included) emits the reference's counters: the reference bench's
    ``_script`` run here, and ``BENCH_baseline.json``'s rows."""
    import benchmarks.common as ref_common
    import benchmarks.predictive_exploration as ref_b9
    for k in ("SMOKE", "N_ROWS", "N_QUERIES", "TARGET_OBJECTS"):
        monkeypatch.setattr(ref_common, k, getattr(smoke, k))
    port_b9.main(device="cpu", backend=backend)
    got = {r["name"]: dict(kv.split("=") for kv in r["derived"].split(";"))
           for r in smoke.EMITTED}
    budget = 6 * smoke.TARGET_OBJECTS
    ref_rows = {}
    monkeypatch.setattr(ref_b9, "emit", lambda name, us, derived:
                        ref_rows.__setitem__(name, dict(
                            kv.split("=") for kv in derived.split(";"))))
    ref_b9._script("linear_pan", ref_b9._linear_pan(smoke.N_QUERIES), budget)
    ref_b9._script("random_walk", ref_b9._random_walk(smoke.N_QUERIES),
                   budget)
    assert {k: got[k] for k in ref_rows} == ref_rows
    base = baseline_counters()
    for name, row in base.items():
        if name == "predictive_answer_neutrality":
            assert got[name]["checked"] == row["checked"]
            continue
        assert got[name] == row, name
    assert got["predictive_answer_neutrality"]["bit_identical"] == \
        str(backend == "np")
    # the recorded numbers of a row, unrounded
    pred = next(r for r in smoke.EMITTED
                if r["name"] == "predictive_linear_pan_predicted")
    assert pred["hit_linear"] == 1.0 and pred["p99_reads"] < next(
        r["p99_reads"] for r in smoke.EMITTED
        if r["name"] == "predictive_linear_pan_reactive")
