"""The port's serving tick — ``AQPEngine.serve()`` → ``ServingEngine.tick``
on one ``TileIndex`` or a chunk forest — against the reference package,
on the dataset, config and scripts of ``tests/test_serving.py`` (n =
60 000 uniform points, grid0 (8, 8), ``min_split_count=256``; prefetch
off). Chunked, the dataset is one chunk (``from_dataset``, as the
reference tests) or three x-slabs, whose windows straddle chunks.

- Port ``"np"`` ≡ reference, bit for bit, in each serving mode: every
  result field but the wall time, the ``IOStats`` and ``AdaptStats``
  deltas of each tick, ``last_publish``, ``last_grants`` and the index
  fingerprint (tile table, permutation, metadata).
- Port ``"torch"`` on CPU tensors runs the device code path with the
  plain kernels: reads, rounds, splits, the permutation and the
  publication counters equal the reference's; counts and extrema equal;
  values, interval ends and sums agree to ``VALUE_RTOL`` (float64 sums in
  another order); the invariants hold.
- Port batched ≡ port sequential on both backends, including objects at
  ``float32(e) < e`` on a window edge (ROADMAP C.6), where the
  reference's batched tick fails.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import AccuracyPolicy as RefPolicy
from repro.core import (AQPEngine as RefEngine, IndexConfig as RefConfig,
                        ServingEngine as RefServing)
from repro.core.index import EpochStage as RefStage
from repro.data.chunked import ChunkedDataset as RefChunked
from repro.data.rawfile import RawDataset as RefDataset
from repro.kernels import ops as rops
from repro_torch.core import (AccuracyPolicy, AQPEngine, ChunkIndexSet,
                              EpochStage, IndexConfig, NullStage,
                              ServingEngine, forest_to_numpy,
                              index_from_numpy, index_to_numpy)
from repro_torch.data import ChunkedDataset
from repro_torch.data.rawfile import RawDataset

PHI = 0.05
VALUE_RTOL = 1e-9
KW = dict(grid0=(8, 8), min_split_count=256, init_metadata_attrs=("a0",))
# answer fields equal across serving modes (tests/test_serving.py:14);
# objects_read / read_calls / batch_rounds are cost attribution
ANSWER_FIELDS = ("value", "lo", "hi", "bound", "exact", "tiles_full",
                 "tiles_partial", "tiles_processed", "speculative_rows",
                 "retired_during_query", "values", "bin_bound")


def columns(n=60_000, seed=0):
    """The reference serving tests' dataset (tests/test_serving.py:21)."""
    rng = np.random.default_rng(seed)
    xs = rng.uniform(0, 1000, n)
    ys = rng.uniform(0, 1000, n)
    a0 = (xs / 10 + rng.normal(0, 5, n) + 100).astype(np.float64)
    return xs, ys, a0


def ref_server(cols, **kw):
    xs, ys, a0 = cols
    return RefServing(RefEngine(RefDataset(xs, ys, {"a0": a0}),
                                RefConfig(**KW)), **kw)


def port_engine(cols, backend):
    xs, ys, a0 = cols
    ds = RawDataset(xs, ys, {"a0": a0},
                    device=None if backend == "np" else "cpu")
    return AQPEngine(ds, IndexConfig(backend=backend, **KW))


def port_server(cols, backend, **kw):
    return ServingEngine(port_engine(cols, backend), **kw)


# --------------------------------------------------------------------- #
# scripts: per tick, (session, kind, window, agg, kwargs) in arrival order
# --------------------------------------------------------------------- #

def two_session_script(seed=7):
    """tests/test_serving.py:44 — two sessions' queries, and session 1's
    heatmap over session 0's region (same-tile contention)."""
    rng = np.random.default_rng(seed)
    ticks = []
    for _ in range(3):
        subs = []
        for sid in range(2):
            cx, cy = rng.uniform(150, 850, 2)
            w = rng.uniform(60, 200)
            subs.append((sid, "query", (cx - w, cy - w, cx + w, cy + w),
                         "mean", {"phi": PHI}))
        subs.append((1, "heatmap", subs[0][2], "mean",
                     {"bins": (4, 4), "phi": PHI}))
        ticks.append(subs)
    return ticks


def containment_script():
    """tests/test_serving.py:139 — 4 ticks of two sessions panning."""
    rng = np.random.default_rng(11)
    ticks = []
    for _ in range(4):
        subs = []
        for sid in range(2):
            cx, cy = rng.uniform(200, 800, 2)
            w = rng.uniform(80, 250)
            subs.append((sid, "query", (cx - w, cy - w, cx + w, cy + w),
                         "mean", {"phi": PHI}))
        ticks.append(subs)
    return ticks


WIN = (200, 200, 700, 700)
SCENARIOS = {
    # name: (server kwargs, number of sessions, ticks)
    "batched_budget_none": (dict(mode="batched"), 2, two_session_script()),
    "batched_budget_1": (dict(mode="batched", crack_budget=1), 2,
                         two_session_script()),
    "sequential_budget_none": (dict(mode="sequential"), 2,
                               two_session_script()),
    "sequential_budget_1": (dict(mode="sequential", crack_budget=1), 2,
                            two_session_script()),
    "containment": (dict(), 2, containment_script()),
    # tests/test_serving.py:195: two identical same-tick queries, then
    # a repeat after publication
    "frozen_epoch": (dict(mode="sequential"), 2, [
        [(0, "query", WIN, "mean", {"phi": PHI}),
         (1, "query", WIN, "mean", {"phi": PHI})],
        [(0, "query", WIN, "mean", {"phi": PHI})]]),
    # tests/test_serving.py:210
    "split_contention": (dict(), 2, [
        [(0, "query", WIN, "mean", {"phi": PHI}),
         (1, "query", WIN, "sum", {"phi": PHI})]]),
    # tests/test_serving.py:224
    "budget_skip": (dict(crack_budget=1), 3, [
        [(s, "query", (150, 150, 800, 800), "mean", {"phi": PHI})
         for s in range(3)]]),
    "budget_free": (dict(), 3, [
        [(s, "query", (150, 150, 800, 800), "mean", {"phi": PHI})
         for s in range(3)]]),
    # tests/test_serving.py:247
    "metadata_fast_path": (dict(), 1, [
        [(0, "query", (-1e9, -1e9, 1e9, 1e9), "count", {"phi": 0.5})]]),
    # tests/test_serving.py:278 (bins (2, 2) heatmap included)
    "traces": (dict(), 2, [
        [(0, "query", (100, 100, 500, 500), "mean", {"phi": PHI}),
         (1, "query", (300, 300, 700, 700), "mean", {"phi": PHI}),
         (1, "heatmap", (300, 300, 700, 700), "mean",
          {"bins": (2, 2), "phi": PHI})]]),
}
# ten sessions' exact queries: a round's scalar pass carries more than
# MAX_SEGMENTS = 64 segments (hazard 4: "np" makes one pass of them, the
# device backends chunk it)
SCENARIOS["wide_tick"] = (dict(), 10, [
    [(s, "query", (60.0 * s, 100.0, 60.0 * s + 400.0, 700.0), "sum",
      {"phi": 0.0}) for s in range(10)]])
for _mode in ("batched", "sequential"):
    # tests/test_serving.py:322: a chatty session's three tickets before
    # a quiet one's, budget 2, then the quiet repeat
    SCENARIOS[f"round_robin_{_mode}"] = (
        dict(mode=_mode, crack_budget=2), 2,
        [[(0, "query", (100 + d, 100 + d, 400 + d, 400 + d), "mean",
           {"phi": PHI}) for d in (0.0, 15.0, 30.0)]
         + [(1, "query", (600.0, 600.0, 900.0, 900.0), "mean",
             {"phi": 0.005})],
         [(1, "query", (600.0, 600.0, 900.0, 900.0), "mean",
           {"phi": 0.005})]])


def play(server, n_sessions, ticks):
    """Drive ``server``; per tick: (results, last_publish, last_grants,
    IOStats delta, AdaptStats delta)."""
    sessions = [server.open_session() for _ in range(n_sessions)]
    out = []
    for subs in ticks:
        for sid, kind, w, agg, kw in subs:
            getattr(sessions[sid], kind)(w, agg, "a0", **kw)
        eng = server.engine
        io, ad = eng.io_stats.snapshot(), eng.adapt_stats.snapshot()
        rs = server.tick()
        out.append((rs, dict(server.last_publish), list(server.last_grants),
                    dataclasses.asdict(eng.io_stats.delta(io)),
                    dataclasses.asdict(eng.adapt_stats.delta(ad))))
    return out, sessions


def fields(r):
    d = dataclasses.asdict(r)
    d.pop("eval_time_s")
    return d


def fingerprint(index):
    a = index_to_numpy(index)
    n = a["n_tiles"]
    return (n, int(a["active"].sum()), a["count"][:n], a["bbox"][:n],
            a["perm"], {k: (a["meta_sum"][k][:n], a["meta_min"][k][:n],
                            a["meta_max"][k][:n], a["meta_valid"][k][:n])
                        for k in a["meta_sum"]})


def assert_same(a, b, rtol=0.0, what=""):
    """Equal, or within ``rtol`` for floats (``rtol=0``: bit for bit)."""
    if isinstance(a, (np.ndarray, float)) and rtol:
        np.testing.assert_allclose(a, b, rtol=rtol, atol=0, err_msg=what)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, (what, a, b)


def assert_results_equal(ra, rb, rtol=0.0):
    assert type(ra).__name__ == type(rb).__name__
    fa, fb = fields(ra), fields(rb)
    assert fa.keys() == fb.keys()
    for k in fa:
        float_field = k in ("value", "lo", "hi", "bound", "values",
                            "bin_bound")
        assert_same(fa[k], fb[k], rtol if float_field else 0.0, k)


def assert_fingerprints_equal(fa, fb, rtol=0.0):
    assert fa[:2] == fb[:2]
    for x, y in zip(fa[2:5], fb[2:5]):
        np.testing.assert_array_equal(x, y)
    assert fa[5].keys() == fb[5].keys()
    for k in fa[5]:
        s_a, mn_a, mx_a, v_a = fa[5][k]
        s_b, mn_b, mx_b, v_b = fb[5][k]
        np.testing.assert_array_equal(mn_a, mn_b)
        np.testing.assert_array_equal(mx_a, mx_b)
        np.testing.assert_array_equal(v_a, v_b)
        assert_same(s_a[v_a], s_b[v_b], rtol, "meta_sum")


def assert_plays_equal(pa, pb, rtol=0.0, chunked=False):
    """``chunked``: ``pb`` ran on a device backend, whose passes split at
    ``MAX_SEGMENTS`` segments — it may count more kernel calls."""
    assert len(pa) == len(pb)
    for (ra, pub_a, gr_a, io_a, ad_a), (rb, pub_b, gr_b, io_b, ad_b) in zip(
            pa, pb):
        assert len(ra) == len(rb)
        for x, y in zip(ra, rb):
            assert_results_equal(x, y, rtol)
        if chunked:
            ad_a, ad_b = dict(ad_a), dict(ad_b)
            assert ad_b.pop("kernel_calls") >= ad_a.pop("kernel_calls")
        assert (pub_a, gr_a, io_a, ad_a) == (pub_b, gr_b, io_b, ad_b)


# --------------------------------------------------------------------- #
# port ≡ reference
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_port_np_equals_reference(scenario):
    kw, n_sessions, ticks = SCENARIOS[scenario]
    cols = columns()
    ref, port = ref_server(cols, **kw), port_server(cols, "np", **kw)
    pa, _ = play(ref, n_sessions, ticks)
    pb, _ = play(port, n_sessions, ticks)
    assert_plays_equal(pa, pb)
    fa, fb = fingerprint(ref.index), fingerprint(port.index)
    assert_fingerprints_equal(fa, fb)
    a, b = index_to_numpy(ref.index), index_to_numpy(port.index)
    assert [k for k, _ in a["hm_regs"]] == [k for k, _ in b["hm_regs"]]
    assert ref.epoch == port.epoch == len(ticks)


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_port_torch_matches_reference(scenario):
    kw, n_sessions, ticks = SCENARIOS[scenario]
    cols = columns()
    ref, port = ref_server(cols, **kw), port_server(cols, "torch", **kw)
    pa, _ = play(ref, n_sessions, ticks)
    pb, _ = play(port, n_sessions, ticks)
    assert_plays_equal(pa, pb, rtol=VALUE_RTOL, chunked=True)
    assert_fingerprints_equal(fingerprint(ref.index),
                              fingerprint(port.index), rtol=VALUE_RTOL)
    port.index.check_invariants("a0")
    if scenario == "wide_tick":      # hazard 4: only the device chunks
        calls = [p[4]["kernel_calls"] for p in (pa[0], pb[0])]
        assert calls[1] > calls[0]


# --------------------------------------------------------------------- #
# the scenarios' own properties, on the port
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("backend", ["np", "torch"])
@pytest.mark.parametrize("crack_budget", [None, 1])
def test_batched_tick_equals_sequential(backend, crack_budget):
    cols = columns()
    plays, fps = [], []
    for mode in ("batched", "sequential"):
        sv = port_server(cols, backend, mode=mode, crack_budget=crack_budget)
        p, _ = play(sv, 2, two_session_script())
        plays.append(p)
        fps.append(fingerprint(sv.index))
        if backend == "torch":
            sv.index.check_invariants("a0")
    for (ra, pub_a, gr_a, _, _), (rb, pub_b, gr_b, _, _) in zip(*plays):
        for x, y in zip(ra, rb):
            for f in ANSWER_FIELDS:
                if hasattr(x, f):
                    assert_same(getattr(x, f), getattr(y, f), what=f)
        assert (pub_a, gr_a) == (pub_b, gr_b)
    assert_fingerprints_equal(*fps)


@pytest.mark.parametrize("backend", ["np", "torch"])
def test_oracle_containment_while_cracking(backend):
    sv = port_server(columns(), backend)
    p, _ = play(sv, 2, containment_script())
    assert sv.epoch == 4
    for (rs, *_), subs in zip(p, containment_script()):
        for r, (_, _, w, agg, _) in zip(rs, subs):
            assert r.exact or r.bound <= PHI + 1e-12
            truth = sv.engine.oracle(w, agg, "a0")
            assert r.lo - 1e-9 <= truth <= r.hi + 1e-9


def test_no_reader_observes_half_applied_split(monkeypatch):
    """Epoch isolation: the index is unchanged up to publication."""
    sv = port_server(columns(), "torch")
    pre, seen = {}, []
    orig = EpochStage.publish

    def checked(self):
        assert_fingerprints_equal(fingerprint(sv.index), pre["fp"])
        seen.append(1)
        return orig(self)

    monkeypatch.setattr(EpochStage, "publish", checked)
    s0, s1 = sv.open_session(), sv.open_session()
    for _ in range(2):
        s0.query((100, 100, 600, 600), "mean", "a0", phi=PHI)
        s1.query((150, 150, 700, 700), "sum", "a0", phi=PHI)
        s1.heatmap((100, 100, 600, 600), "mean", "a0", bins=(4, 4),
                   phi=PHI)
        pre["fp"] = fingerprint(sv.index)
        sv.tick()
    assert len(seen) == 2
    assert fingerprint(sv.index)[0] > pre["fp"][0]


@pytest.mark.parametrize("backend", ["np", "torch"])
def test_scenario_properties(backend):
    """The reference scenarios' own assertions (tests/test_serving.py),
    on the port."""
    cols = columns()
    # same-tick queries read the frozen epoch; the repeat costs less
    p, _ = play(port_server(cols, backend, mode="sequential"),
                *SCENARIOS["frozen_epoch"][1:])
    (ta, tb), (tc,) = p[0][0], p[1][0]
    assert ta.objects_read == tb.objects_read > 0
    assert ta.value == tb.value and tc.objects_read < ta.objects_read
    # the later same-tile split request is masked and counted
    p, _ = play(port_server(cols, backend), *SCENARIOS["split_contention"][1:])
    assert p[0][1]["rounds_published"] > 0 and p[0][1]["splits_masked"] > 0
    # past the crack budget a query still meets φ; fewer rounds publish
    sv = port_server(cols, backend, crack_budget=1)
    p, _ = play(sv, *SCENARIOS["budget_skip"][1:])
    free, _ = play(port_server(cols, backend), *SCENARIOS["budget_free"][1:])
    truth = sv.engine.oracle((150, 150, 800, 800), "mean", "a0")
    for r in p[0][0]:
        assert r.exact or r.bound <= PHI + 1e-12
        assert r.lo - 1e-9 <= truth <= r.hi + 1e-9
    assert free[0][1]["rounds_published"] > p[0][1]["rounds_published"]
    # the metadata fast path reads nothing and stages nothing
    p, _ = play(port_server(cols, backend),
                *SCENARIOS["metadata_fast_path"][1:])
    assert p[0][0][0].objects_read == 0
    assert p[0][1]["rounds_published"] == 0
    # round-robin grants: the quiet session takes the second slot
    for mode in ("batched", "sequential"):
        p, _ = play(port_server(cols, backend, mode=mode, crack_budget=2),
                    *SCENARIOS[f"round_robin_{mode}"][1:])
        assert p[0][2] == [True, False, False, True]
        quiet, again = p[0][0][3], p[1][0][0]
        assert 0 < again.objects_read < quiet.objects_read


def test_per_session_traces_and_lifecycle():
    sv = port_server(columns(), "torch")
    sa, sb = sv.open_session("alice"), sv.open_session("bob")
    sa.query((100, 100, 500, 500), "mean", "a0", phi=PHI)
    sb.query((300, 300, 700, 700), "mean", "a0", phi=PHI)
    sb.heatmap((300, 300, 700, 700), "mean", "a0", bins=(2, 2), phi=PHI)
    sv.tick()
    assert sa.trace.totals()["queries"] == 1
    tb = sb.trace.totals()
    assert tb["queries"] == 2
    assert tb["scalar_queries"] == 1 and tb["heatmap_queries"] == 1
    assert [s.bins for s in sb.trace.trajectory] == [None, (2, 2)]
    sb.query((0, 0, 100, 100), "mean", "a0", phi=PHI)
    sb.close()
    assert sv.n_queued == 0
    with pytest.raises(RuntimeError):
        sb.query((0, 0, 100, 100), "mean", "a0", phi=PHI)
    assert sv.tick() == []
    assert sa.trace.totals()["queries"] == 1


@pytest.mark.parametrize("backend", ["np", "torch"])
def test_engine_serve_shares_index(backend):
    """tests/test_serving.py:298, on both packages: a serving tick's
    published splits are visible to the engine's own queries."""
    cols = columns()
    xs, ys, a0 = cols
    e_ref = RefEngine(RefDataset(xs, ys, {"a0": a0}), RefConfig(**KW))
    e_port = port_engine(cols, backend)
    got = []
    for eng in (e_ref, e_port):
        server = eng.serve()
        assert server.engine is eng and server.index is eng.index
        t = server.open_session().query((200, 200, 800, 800), "mean", "a0",
                                        phi=0.01)
        server.tick()
        r = eng.query((200, 200, 800, 800), "mean", "a0", phi=0.01)
        assert t.result.objects_read > 0
        assert r.exact or r.bound <= 0.01 + 1e-12
        assert r.objects_read < t.result.objects_read
        got.append((t.result, r))
    for x, y in zip(got[0], got[1]):
        assert_results_equal(x, y, 0.0 if backend == "np" else VALUE_RTOL)
    assert_fingerprints_equal(fingerprint(e_ref.index),
                              fingerprint(e_port.index),
                              0.0 if backend == "np" else VALUE_RTOL)


@pytest.mark.parametrize("backend", ["np", "torch"])
def test_closed_dataset_degrades_like_the_reference(backend):
    """A dataset closed between submission and tick: every read degrades,
    the pending tiles drop out of the answers, ``retired_during_query``
    is set — in both modes, as in the reference."""
    cols = columns()
    got = {}
    for mode in ("batched", "sequential"):
        for name, sv in (("ref", ref_server(cols, mode=mode)),
                         ("port", port_server(cols, backend, mode=mode))):
            s = sv.open_session()
            s.query((100, 100, 600, 600), "mean", "a0", phi=PHI)
            sv.tick()
            tickets = [s.query((150, 150, 900, 900), "mean", "a0", phi=0.0),
                       s.heatmap((150, 150, 900, 900), "mean", "a0",
                                 bins=(4, 4), phi=0.0)]
            sv.engine.dataset.close()
            sv.tick()
            assert all(tk.result.retired_during_query for tk in tickets)
            assert sv.last_publish["rounds_published"] == 0
            got[name, mode] = [tk.result for tk in tickets]
    rtol = 0.0 if backend == "np" else VALUE_RTOL
    for mode in ("batched", "sequential"):
        for x, y in zip(got["ref", mode], got["port", mode]):
            assert_results_equal(x, y, rtol)


# --------------------------------------------------------------------- #
# hazard 1 (ROADMAP C.6): the multi-window compare follows the ticket
# --------------------------------------------------------------------- #

def edge_columns(e=300.3):
    """60 000 uniform points and 500 objects at ``x = float32(e)`` (below
    e), inside the window on the other axis."""
    xs, ys, a0 = columns()
    rng = np.random.default_rng(3)
    idx = rng.choice(len(xs), 500, replace=False)
    xs[idx] = np.float32(e)
    ys[idx] = rng.uniform(300, 500, 500)
    return xs, ys, a0


def test_reference_multi_compare_is_float64():
    """The reference's batched scalar pass hands its multi mirror a
    float64 window row; the ticket's own read compares Python floats in
    float32. On objects at ``float32(e) < e`` they disagree."""
    xs, ys, _ = edge_columns()
    x32, y32 = xs.astype(np.float32), ys.astype(np.float32)
    v = np.ones(len(xs), np.float32)
    b = np.array([0, len(xs)], np.int64)
    window = (300.3, 300.0, 500.0, 500.0)
    row = np.broadcast_to(np.asarray(window, np.float64), (1, 4))
    single = rops.segment_window_agg(x32, y32, v, b, window, backend="np")
    multi = rops.segment_window_agg_multi(x32, y32, v, b, row, backend="np")
    assert single[0, 0] - multi[0, 0] == 500


@pytest.mark.parametrize("backend", ["np", "torch"])
def test_batched_compare_follows_the_ticket(backend):
    """Port batched ≡ port sequential ≡ oracle where the reference's
    batched tick dies in ``fold_exact`` (count of the axis index against
    the float64 kernel count)."""
    cols = edge_columns()
    window = (300.3, 300.0, 500.0, 500.0)
    got = {}
    for mode in ("batched", "sequential"):
        sv = port_server(cols, backend, mode=mode)
        s = sv.open_session()
        tickets = [s.query(window, agg, "a0", phi=0.0)
                   for agg in ("count", "sum", "min")]
        s.heatmap(window, "mean", "a0", bins=(4, 4), phi=0.0)
        sv.tick()
        got[mode] = [tk.result for tk in tickets]
        for tk in tickets:
            assert tk.result.exact
            truth = sv.engine.oracle(window, tk.agg, "a0")
            assert abs(tk.result.value - truth) <= 1e-9 * abs(truth)
        assert_same(got[mode][0].value,
                    float(rops.window_mask_np(
                        cols[0].astype(np.float32), cols[1].astype(
                            np.float32), window).sum()))
    for x, y in zip(got["batched"], got["sequential"]):
        for f in ANSWER_FIELDS:
            if hasattr(x, f):
                assert_same(getattr(x, f), getattr(y, f), what=f)


# --------------------------------------------------------------------- #
# chunked storage: the tick over a chunk forest
# --------------------------------------------------------------------- #

SLABS = (0.0, 333.0, 667.0)


def chunked_dataset(cols, layout, backend=None):
    """The serving dataset as one chunk or three x-slabs, in the reference
    (``backend=None``) or the port."""
    xs, ys, a0 = cols
    if backend is None:
        cds = RefChunked()
        single = lambda: RefChunked.from_dataset(  # noqa: E731
            RefDataset(xs, ys, {"a0": a0}))
    else:
        dev = None if backend == "np" else "cpu"
        cds = ChunkedDataset(device=dev)
        single = lambda: ChunkedDataset.from_dataset(  # noqa: E731
            RawDataset(xs, ys, {"a0": a0}, device=dev))
    if layout == "single":
        return single()
    edges = SLABS + (np.inf,)
    for lo, hi in zip(edges[:-1], edges[1:]):
        m = (xs >= lo) & (xs < hi)
        cds.ingest(xs[m], ys[m], {"a0": a0[m]})
    return cds


def chunked_server(cols, layout, backend=None, **kw):
    ds = chunked_dataset(cols, layout, backend)
    if backend is None:
        return RefServing(RefEngine(ds, RefConfig(**KW)), **kw)
    return ServingEngine(AQPEngine(ds, IndexConfig(backend=backend, **KW)),
                         **kw)


def forest_fingerprint(index):
    """Per live chunk, in build order: the fingerprint of its forest."""
    out = []
    for cid, a in forest_to_numpy(index).items():
        n = a["n_tiles"]
        out.append((cid, (n, int(a["active"].sum()), a["count"][:n],
                          a["bbox"][:n], a["perm"],
                          {k: (a["meta_sum"][k][:n], a["meta_min"][k][:n],
                               a["meta_max"][k][:n], a["meta_valid"][k][:n])
                           for k in a["meta_sum"]})))
    return out


def assert_forests_equal(fa, fb, rtol=0.0):
    assert [c for c, _ in fa] == [c for c, _ in fb]
    for (_, a), (_, b) in zip(fa, fb):
        assert_fingerprints_equal(a, b, rtol)


@pytest.mark.parametrize("backend", ["np", "torch"])
@pytest.mark.parametrize("crack_budget", [None, 1])
@pytest.mark.parametrize("layout", ["single", "multi"])
def test_chunked_tick_matches_reference(layout, crack_budget, backend):
    """tests/test_serving.py:115's chunked cases, and the same over three
    chunks: the port's batched tick against the reference's (``"np"``
    bit for bit: results, deltas, publication, grants and each chunk's
    index), and the port's batched tick ≡ its sequential tick."""
    cols = columns()
    ticks = two_session_script()
    rtol = 0.0 if backend == "np" else VALUE_RTOL
    ref = chunked_server(cols, layout, mode="batched",
                         crack_budget=crack_budget)
    pa, _ = play(ref, 2, ticks)
    plays, forests = [], []
    for mode in ("batched", "sequential"):
        sv = chunked_server(cols, layout, backend, mode=mode,
                            crack_budget=crack_budget)
        assert isinstance(sv.index, ChunkIndexSet)
        p, _ = play(sv, 2, ticks)
        plays.append(p)
        forests.append(forest_fingerprint(sv.index))
        sv.index.check_invariants("a0")
    assert_plays_equal(pa, plays[0], rtol, chunked=backend != "np")
    assert_forests_equal(forest_fingerprint(ref.index), forests[0], rtol)
    for (ra, pub_a, gr_a, _, _), (rb, pub_b, gr_b, _, _) in zip(*plays):
        for x, y in zip(ra, rb):
            for f in ANSWER_FIELDS:
                if hasattr(x, f):
                    assert_same(getattr(x, f), getattr(y, f), what=f)
        assert (pub_a, gr_a) == (pub_b, gr_b)
    assert_forests_equal(*forests)
    if layout == "multi":
        # windows straddle chunks: a round reads one run per chunk
        io = sum(t[3]["read_calls"] for t in plays[0])
        rounds = sum(t[4]["batch_rounds"] for t in plays[0])
        assert len(forests[0]) == 3 and io >= rounds > 0


@pytest.mark.parametrize("backend", ["np", "torch"])
@pytest.mark.parametrize("layout", ["single", "multi"])
def test_chunked_retired_during_query_matches_reference(layout, backend):
    """tests/test_serving.py:257: a chunk's storage closes between ticks;
    the next tick's reads of it degrade, ``retired_during_query`` is set,
    in both modes, as in the reference. Over three chunks the closed
    part is one run of a composite round; the others still read."""
    cols = columns()
    rtol = 0.0 if backend == "np" else VALUE_RTOL
    got = {}
    for mode in ("batched", "sequential"):
        for side in (None, backend):
            sv = chunked_server(cols, layout, side, mode=mode)
            s = sv.open_session()
            win = (100, 100, 900, 900)
            s.query(win, "mean", "a0", phi=PHI)
            sv.tick()
            ds = sv.engine.dataset
            ds.chunk(ds.live_ids[0]).data.close()
            tickets = [s.query(win, "mean", "a0", phi=0.0),
                       s.heatmap(win, "sum", "a0", bins=(4, 4), phi=0.0)]
            sv.tick()
            assert all(tk.result.retired_during_query for tk in tickets)
            if layout == "multi":
                assert all(tk.result.objects_read > 0 for tk in tickets)
            got[side, mode] = ([tk.result for tk in tickets],
                               dict(sv.last_publish))
    for mode in ("batched", "sequential"):
        (ra, pa), (rb, pb) = got[None, mode], got[backend, mode]
        assert pa == pb
        for x, y in zip(ra, rb):
            assert y.batch_rounds >= 0
            if layout == "multi" and mode == "sequential":
                # ROADMAP C.9: the reference's forest subtracts a round
                # for each dead run of a composite round
                assert x.batch_rounds < y.batch_rounds
                x = dataclasses.replace(x, batch_rounds=y.batch_rounds)
            assert_results_equal(x, y, rtol)
    (ra, pa), (rb, pb) = got[backend, "batched"], got[backend, "sequential"]
    assert pa == pb
    for x, y in zip(ra, rb):
        for f in ANSWER_FIELDS:
            if hasattr(x, f):
                assert_same(getattr(x, f), getattr(y, f), what=f)


def test_composite_payload_stages_per_run():
    """``EpochStage.stage_apply`` splits a chunk forest's composite
    payload into its runs, the global folded prefix routed per run, as
    the reference's stage does."""
    runs = [("ti0", {"tile_ids": np.arange(3)}, 0, 3),
            ("ti1", {"tile_ids": np.arange(2)}, 3, 5),
            ("ti2", {"tile_ids": np.arange(4)}, 5, 9)]
    flags = [True, False, True, True, False, True, False, True, True]
    entries = []
    for stage in (RefStage(), EpochStage()):
        stage.set_owner(2)
        for n_used in (0, 4, 9):
            stage.stage_apply("forest", {"runs": runs, "tile_ids":
                                         np.arange(9)}, n_used, flags)
        stage.stage_apply("ti3", {"tile_ids": np.arange(2)}, 1, [True])
        entries.append([(o, q, ti, used, fl) for o, q, ti, _, used, fl
                        in stage._entries])
    assert entries[0] == entries[1]
    assert entries[1][3:6] == [(2, 3, "ti0", 3, [True, False, True]),
                               (2, 4, "ti1", 1, [True]),
                               (2, 5, "ti2", 0, [])]


@pytest.mark.parametrize("backend", ["np", "torch"])
def test_serving_engine_over_a_chunked_dataset(backend):
    """``ServingEngine`` given a chunked dataset builds its own engine
    over a lazy forest, as the reference's does, and serves it."""
    cols = columns()
    servers = []
    for side in (None, backend):
        ds = chunked_dataset(cols, "multi", side)
        if side is None:
            sv = RefServing(ds, RefConfig(**KW))
        else:
            sv = ServingEngine(ds, IndexConfig(backend=backend, **KW))
        assert sv.engine.index.built_ids() == ()
        servers.append(sv)
    pa, _ = play(servers[0], 2, containment_script()[:2])
    pb, _ = play(servers[1], 2, containment_script()[:2])
    assert_plays_equal(pa, pb, 0.0 if backend == "np" else VALUE_RTOL,
                       chunked=backend != "np")
    assert servers[1].engine.index.built_ids() == \
        servers[0].engine.index.built_ids()


# --------------------------------------------------------------------- #
# state carried across packages, and what is not ported yet
# --------------------------------------------------------------------- #

def test_carried_index_serves_a_third_tick():
    """Two ticks in the reference; its index carried into the port; a
    third tick in both gives equal answers and indexes ("np")."""
    cols = columns()
    ticks = two_session_script()
    ref = ref_server(cols)
    sessions = [ref.open_session() for _ in range(2)]
    for subs in ticks[:2]:
        for sid, kind, w, agg, kw in subs:
            getattr(sessions[sid], kind)(w, agg, "a0", **kw)
        ref.tick()
    eng = port_engine(cols, "np")
    eng.index = index_from_numpy(eng.dataset, eng.index.cfg,
                                 index_to_numpy(ref.index))
    port = eng.serve()
    pa, _ = play(ref, 2, ticks[2:])
    pb, _ = play(port, 2, ticks[2:])
    assert_plays_equal(pa, pb)
    assert_fingerprints_equal(fingerprint(ref.index), fingerprint(port.index))


def test_null_stage_discards():
    ns = NullStage()
    ns.set_owner(3)
    ns.stage_apply(None, {}, 1, [True])
    assert ns.publish() == {"rounds_published": 0, "splits_masked": 0}


def test_serving_prediction_options_match_reference():
    """``prefetch_rows`` and learned-salience tickets on the two-session
    script, port "np" against the reference: every tick's answers,
    publication, grants, deltas and prefetch reports bit for bit, and
    the same index; an unknown mode still raises."""
    cols = columns()
    learned = {"phi": PHI, "bins": (4, 4), "policy": None}
    ticks = [[(sid, kind, w, agg, ({**learned} if kind == "heatmap"
                                   else kw))
              for sid, kind, w, agg, kw in subs]
             for subs in two_session_script()]
    got = []
    for sv, pol in ((ref_server(cols, crack_budget=4, prefetch_rows=2000),
                     RefPolicy(salience="learned", eps_abs=0.5)),
                    (port_server(cols, "np", crack_budget=4,
                                 prefetch_rows=2000),
                     AccuracyPolicy(salience="learned", eps_abs=0.5))):
        for subs in ticks:
            for sub in subs:
                if sub[1] == "heatmap":
                    sub[4]["policy"] = pol
        p, _ = play(sv, 2, ticks)
        got.append((p, [s.trace.prefetches for s in sv._sessions.values()],
                    fingerprint(sv.index)))
    (pa, fa, ia), (pb, fb, ib) = got
    assert_plays_equal(pa, pb)
    assert fa == fb and any(r["rows_read"] > 0 for f in fb for r in f)
    assert_fingerprints_equal(ia, ib)
    with pytest.raises(ValueError):
        port_engine(columns(n=2000), "np").serve(mode="parallel")


def test_torch_tick_copies_one_table_per_pass(monkeypatch):
    """Hazard 3: a device family pass moves its table (with the suffix
    widths) to the host in one copy, however many items it carries."""
    import repro_torch.core.serving as serving_mod
    copies, passes = [], []
    orig_host = serving_mod._host

    def counted(a):
        if isinstance(a, torch.Tensor):
            copies.append(tuple(a.shape))
        return orig_host(a)

    monkeypatch.setattr(serving_mod, "_host", counted)
    for name in ("_scalar_multi", "_heatmap_multi"):
        orig = getattr(ServingEngine, name)

        def wrapped(self, *a, _orig=orig, **k):
            passes.append(len(a[4]) - 1)         # segments in the pass
            return _orig(self, *a, **k)

        monkeypatch.setattr(ServingEngine, name, wrapped)
    sv = port_server(columns(), "torch")
    p, _ = play(sv, 2, two_session_script()[:1])
    assert p[0][4]["batch_rounds"] > 0
    assert len(copies) == len(passes) > 0
    assert [c[0] for c in copies] == passes


def test_kernel_heatmap_pass_crosses_to_the_host_in_one_copy(monkeypatch):
    """The multi select kernel returns its table and suffix widths as
    adjacent views of one buffer: a single-chunk heatmap pass copies that
    buffer to the host as it lies, in one copy and with no join on the
    device, and the tick answers as with the plain version's separate
    tensors."""
    import repro_torch.core.index as index_mod
    import repro_torch.core.serving as serving_mod

    script = two_session_script()[:1]
    plain, _ = play(port_server(columns(), "torch"), 2, script)
    real = serving_mod.ops.segment_window_bin_select_multi
    real_cat = torch.cat

    def kernel_like(*a, **k):
        agg, suf = real(*a, **k)
        buf = real_cat([agg.reshape(-1), suf.reshape(-1)])
        return (buf[:agg.numel()].view(agg.shape),
                buf[agg.numel():].view(suf.shape))

    copies, passes, cats = [], [], []
    in_pass = [False]
    for mod in (index_mod, serving_mod):
        def counted(a, _orig=mod._host):
            if in_pass[0] and isinstance(a, torch.Tensor):
                copies.append(tuple(a.shape))
            return _orig(a)
        monkeypatch.setattr(mod, "_host", counted)
    orig_pass = ServingEngine._heatmap_multi

    def wrapped(self, *a, **k):
        in_pass[0] = True
        try:
            agg, suf = orig_pass(self, *a, **k)
        finally:
            in_pass[0] = False
        passes.append(agg.size + suf.size)
        return agg, suf

    def counted_cat(*a, **k):
        if in_pass[0]:
            cats.append(1)
        return real_cat(*a, **k)

    monkeypatch.setattr(serving_mod.ops, "segment_window_bin_select_multi",
                        kernel_like)
    monkeypatch.setattr(ServingEngine, "_heatmap_multi", wrapped)
    monkeypatch.setattr(serving_mod.torch, "cat", counted_cat)
    got, _ = play(port_server(columns(), "torch"), 2, script)
    assert passes and copies == [(n,) for n in passes] and not cats
    for (rg, *sg), (rp, *sp) in zip(got, plain):
        assert sg == sp
        for x, y in zip(rg, rp):
            for f, v in fields(x).items():
                assert_same(v, fields(y)[f], what=f)
