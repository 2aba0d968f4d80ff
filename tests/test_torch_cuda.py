"""The CUDA kernels on the card (marked ``cuda``; skipped without one).

Run on a machine with an NVIDIA Hopper GPU and ``nvcc``:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

The kernels build at first use. Each kernel is held against its plain
PyTorch version on the same CUDA tensors (counts and extrema equal,
float64 sums within 1e-12 · Σ|v|, the select op's suffix widths equal
bit for bit), and the main path, the heatmap path, the serving tick,
the chunked path (a forest and a tick over chunks) and prediction
(prefetch, learned salience, a tick with ``prefetch_rows``) on the
``"cuda"`` backend against the same paths on ``"torch"``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import AQPEngine, IndexConfig
from repro_torch.data import exploration_path, make_synthetic_dataset
from repro_torch.kernels import build, ops
from repro_torch.kernels.segment_agg import EVERYWHERE

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    try:
        build.nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernels")
    return torch.device("cuda")


def _case(seed, n_seg=8, rows=20_000):
    rng = np.random.default_rng(seed)
    b = np.arange(0, n_seg * rows + 1, rows, dtype=np.int64)
    x0 = rng.uniform(0, 500, (n_seg, 2))
    bb = np.concatenate([x0, x0 + rng.uniform(10, 300, (n_seg, 2))], 1)
    sid = np.repeat(np.arange(n_seg), rows)
    xs = rng.uniform(bb[sid, 0], bb[sid, 2]).astype(np.float32)
    ys = rng.uniform(bb[sid, 1], bb[sid, 3]).astype(np.float32)
    vals = rng.normal(0, 30, len(xs)).astype(np.float32)
    return xs, ys, vals, b, bb


def _assert_equal_rows(got, want, absv):
    g = got.cpu().numpy().reshape(-1, 4)
    w = want.cpu().numpy().reshape(-1, 4)
    a = absv.cpu().numpy().reshape(-1)
    np.testing.assert_array_equal(g[:, 0], w[:, 0])
    assert (g[:, 2] == w[:, 2]).all() and (g[:, 3] == w[:, 3]).all()
    assert (np.abs(g[:, 1] - w[:, 1]) <= 1e-12 * a).all()


def _edges(bb, g, seed):
    """Per-segment split edges of ``g`` cells inside each bbox."""
    rng = np.random.default_rng(seed)
    inner = np.sort(rng.uniform(bb[:, :1], bb[:, 2:3], (len(bb), g - 1)), 1)
    xe = np.concatenate([bb[:, :1], inner, bb[:, 2:3]], 1)
    inner = np.sort(rng.uniform(bb[:, 1:2], bb[:, 3:4], (len(bb), g - 1)), 1)
    ye = np.concatenate([bb[:, 1:2], inner, bb[:, 3:4]], 1)
    return xe, ye


@pytest.mark.parametrize("op", [
    "segment_window_agg", "segment_bin_agg", "bin_agg",
    "segment_bin_agg_edges", "segment_window_bin_agg",
    "segment_window_bin_select", "segment_window_bin_select_16x16",
    "segment_window_agg_multi", "segment_window_bin_agg_multi",
    "segment_window_bin_select_multi",
    "segment_window_bin_select_multi_16x16", "window_agg", "window_count"])
def test_kernel_matches_plain_version(card, op):
    n_seg = 32 if op.endswith("16x16") else 8
    xs, ys, vals, b, bb = _case(1, n_seg=n_seg)
    xs, ys, vals = (torch.from_numpy(a).to(card) for a in (xs, ys, vals))
    w = (100.0, 100.0, 400.0, 400.0)
    xe, ye = _edges(bb, 4, 2)
    vmin = np.full(n_seg, -200.0)
    vmax = np.linspace(50.0, 300.0, n_seg)
    # one window per segment, crossing its bbox; spans of 1, 3 and the
    # rest of the segments
    wins = [tuple(float(v) + 0.3 for v in (
        r[0] + 0.25 * (r[2] - r[0]), r[1] + 0.25 * (r[3] - r[1]),
        r[0] + 0.75 * (r[2] - r[0]), r[1] + 0.75 * (r[3] - r[1])))
        for r in bb]
    qb = np.array([0, 1, 4, n_seg], np.int64)
    calls = {
        "segment_window_agg": lambda v, be: ops.segment_window_agg(
            xs, ys, v, b, w, backend=be),
        "segment_bin_agg": lambda v, be: ops.segment_bin_agg(
            xs, ys, v, b, bb, gx=4, gy=4, backend=be),
        "bin_agg": lambda v, be: ops.bin_agg(
            xs[:b[1]], ys[:b[1]], v[:b[1]], bb[0], gx=2, gy=2, backend=be),
        "segment_bin_agg_edges": lambda v, be: ops.segment_bin_agg_edges(
            xs, ys, v, b, xe, ye, backend=be),
        "segment_window_bin_agg": lambda v, be: ops.segment_window_bin_agg(
            xs, ys, v, b, w, bx=8, by=8, backend=be),
        "segment_window_bin_select":
            lambda v, be: ops.segment_window_bin_select(
                xs, ys, v, b, w, vmin, vmax, bx=8, by=8, backend=be),
        # 32 segments x 256 bins: a table too large for shared memory
        "segment_window_bin_select_16x16":
            lambda v, be: ops.segment_window_bin_select(
                xs, ys, v, b, w, vmin, vmax, bx=16, by=16, backend=be),
        "segment_window_agg_multi":
            lambda v, be: ops.segment_window_agg_multi(
                xs, ys, v, b, wins, backend=be),
        "segment_window_bin_agg_multi":
            lambda v, be: ops.segment_window_bin_agg_multi(
                xs, ys, v, b, wins, bx=4, by=4, backend=be),
        "segment_window_bin_select_multi":
            lambda v, be: ops.segment_window_bin_select_multi(
                xs, ys, v, b, wins, vmin, vmax, qb, bx=4, by=4, backend=be),
        "segment_window_bin_select_multi_16x16":
            lambda v, be: ops.segment_window_bin_select_multi(
                xs, ys, v, b, wins, vmin, vmax, qb, bx=16, by=16,
                backend=be),
        # an unaligned view, n short of the planes
        "window_agg": lambda v, be: ops.window_agg(
            xs[1:], ys[1:], v[1:], w, n=len(xs) - 7, backend=be),
        "window_count": lambda v, be: ops.window_count(
            xs[1:], ys[1:], w, n=len(xs) - 7, backend=be).reshape(1, 1)
            .expand(1, 4),
    }
    counter = "window_agg" if op == "window_count" else op.replace(
        "_16x16", "")
    before = build.LAUNCHES[counter]
    got = calls[op](vals, "cuda")
    torch.cuda.synchronize()
    assert build.LAUNCHES[counter] == before + 1
    want = calls[op](vals, "torch")
    absv = calls[op](vals.abs(), "torch")
    if isinstance(got, tuple):
        assert torch.equal(got[1], want[1])       # suffix_w, bit for bit
        got, want, absv = got[0], want[0], absv[0]
    _assert_equal_rows(got, want, absv[..., 1])


@pytest.mark.parametrize("cut", ["values", "count"])
def test_window_agg_raises_on_planes_at_different_offsets(card, cut):
    xs, ys, vals, _, _ = _case(4, n_seg=1)
    xs, ys, vals = (torch.from_numpy(a).to(card) for a in (xs, ys, vals))
    before = build.LAUNCHES["window_agg"]
    with pytest.raises(ValueError, match="mod 16"):
        if cut == "values":
            ops.window_agg(xs[:-1], ys[:-1], vals[1:], (0, 0, 900, 900),
                           backend="cuda")
        else:
            ops.window_count(xs[1:-1], ys[2:], (0, 0, 900, 900),
                             backend="cuda")
    assert build.LAUNCHES["window_agg"] == before


def test_heatmap_cuda_matches_torch(card):
    engines = {}
    for backend in ("torch", "cuda"):
        ds = make_synthetic_dataset(n=200_000, seed=3, device=card)
        engines[backend] = AQPEngine(ds, IndexConfig(
            init_metadata_attrs=("a0",), backend=backend))
    wins = exploration_path(engines["cuda"].dataset, n_queries=6,
                            target_objects=10_000)
    before = dict(build.LAUNCHES)
    for phi, seq in ((0.05, False), (0.0, False), (0.05, True)):
        for w in wins:
            rt = engines["torch"].heatmap(w, "mean", "a0", bins=(8, 8),
                                          phi=phi, sequential=seq)
            rc = engines["cuda"].heatmap(w, "mean", "a0", bins=(8, 8),
                                         phi=phi, sequential=seq)
            np.testing.assert_allclose(rc.values, rt.values, rtol=1e-12)
            assert (rc.objects_read, rc.tiles_processed) == \
                (rt.objects_read, rt.tiles_processed)
    for k in ("segment_bin_agg_edges", "segment_window_bin_agg",
              "segment_window_bin_select"):
        assert build.LAUNCHES[k] > before.get(k, 0), k
    assert torch.equal(engines["cuda"].index.perm, engines["torch"].index.perm)
    engines["cuda"].index.check_invariants("a0")


def test_main_path_cuda_matches_torch(card):
    engines = {}
    for backend in ("torch", "cuda"):
        ds = make_synthetic_dataset(n=200_000, seed=3, device=card)
        engines[backend] = AQPEngine(ds, IndexConfig(
            init_metadata_attrs=("a0",), backend=backend))
    wins = exploration_path(engines["cuda"].dataset, n_queries=6,
                            target_objects=10_000)
    for phi in (0.05, 0.0):
        for w in wins:
            rt = engines["torch"].query(w, "mean", "a0", phi=phi)
            rc = engines["cuda"].query(w, "mean", "a0", phi=phi)
            assert rc.value == pytest.approx(rt.value, rel=1e-12)
            assert (rc.objects_read, rc.tiles_processed) == \
                (rt.objects_read, rt.tiles_processed)
    assert torch.equal(engines["cuda"].index.perm, engines["torch"].index.perm)
    engines["cuda"].index.check_invariants("a0")


def test_serving_tick_cuda_matches_torch(card):
    """Four sessions, two ticks of scalar queries and 4x4 heatmaps, on
    the "cuda" and "torch" backends over one dataset: equal reads,
    splits, permutation and publication; values to float64 order."""
    from repro_torch.core import ServingEngine

    ds = make_synthetic_dataset(n=200_000, seed=5, device=card)
    wins = exploration_path(ds, n_queries=8, target_objects=10_000)
    out = {}
    before = dict(build.LAUNCHES)
    for backend in ("torch", "cuda"):
        sv = ServingEngine(AQPEngine(ds, IndexConfig(
            init_metadata_attrs=("a0",), backend=backend)))
        sessions = [sv.open_session() for _ in range(4)]
        res = []
        for tick in range(2):
            for i, s in enumerate(sessions):
                w = wins[4 * tick + i]
                if i % 2:
                    s.heatmap(w, "mean", "a0", bins=(4, 4), phi=0.05)
                else:
                    s.query(w, "mean", "a0", phi=0.05)
            res.append((sv.tick(), dict(sv.last_publish)))
        out[backend] = (res, sv.index)
    for (rt, pt), (rc, pc) in zip(out["torch"][0], out["cuda"][0]):
        assert pt == pc
        for a, c in zip(rt, rc):
            assert (a.objects_read, a.tiles_processed, a.exact) == \
                (c.objects_read, c.tiles_processed, c.exact)
            f = "values" if hasattr(a, "values") else "value"
            np.testing.assert_allclose(np.atleast_1d(getattr(c, f)),
                                       np.atleast_1d(getattr(a, f)),
                                       rtol=1e-12)
    assert torch.equal(out["cuda"][1].perm, out["torch"][1].perm)
    out["cuda"][1].check_invariants("a0")
    for k in ("segment_window_agg_multi", "segment_window_bin_select_multi"):
        assert build.LAUNCHES[k] > before.get(k, 0), k


def _pan(n, start=(150.0, 200.0), step=(35.0, 25.0), size=300.0):
    return [(start[0] + step[0] * i, start[1] + step[1] * i,
             start[0] + step[0] * i + size, start[1] + step[1] * i + size)
            for i in range(n)]


def test_prefetch_and_learned_salience_cuda_match_torch(card):
    """Prefetching along a pan and learned-salience heatmaps, "cuda"
    against "torch" on one dataset: equal prefetch reports, reads, splits
    and permutation, values to float64 order; each predictor's weights
    on the card."""
    from repro_torch.core import AccuracyPolicy
    ds = make_synthetic_dataset(n=200_000, seed=4, device=card)
    pol = AccuracyPolicy(salience="learned", eps_abs=0.5)
    out = {}
    for backend in ("torch", "cuda"):
        eng = AQPEngine(ds, IndexConfig(grid0=(8, 8), min_split_count=512,
                                        init_metadata_attrs=("a0",),
                                        backend=backend))
        assert all(t.device.type == card.type
                   for t in eng.predictor._params.values())
        res, recs = [], []
        for i, w in enumerate(_pan(8)):
            res.append(eng.heatmap(w, "mean", "a0", bins=(4, 4), phi=0.05,
                                   policy=pol if i % 2 else None,
                                   dwell_s=1.0 + i % 3))
            spec = eng.adapt_stats.speculative_rows
            recs.append(eng.prefetch(20_000))
            assert recs[-1]["rows_read"] <= 20_000
            assert eng.adapt_stats.speculative_rows == spec
        out[backend] = (res, recs, eng)
    (rt, pt, et), (rc, pc, ec) = out["torch"], out["cuda"]
    assert pt == pc and any(p["rows_read"] > 0 for p in pc)
    for a, c in zip(rt, rc):
        assert (a.objects_read, a.tiles_processed, a.exact) == \
            (c.objects_read, c.tiles_processed, c.exact)
        np.testing.assert_array_equal(c.phi_b, a.phi_b)
        np.testing.assert_allclose(c.values, a.values, rtol=1e-12)
    assert torch.equal(ec.index.perm, et.index.perm)
    ec.index.check_invariants("a0")
    assert ec.predictor.source == et.predictor.source == "linear"


def test_serving_prefetch_batched_equals_sequential_on_the_card(card):
    """A tick with ``prefetch_rows`` and leftover crack-budget slots on
    the card, batched against sequential: equal answers (values to
    float64 order), prefetch reports, publication and permutation."""
    from repro_torch.core import ServingEngine
    ds = make_synthetic_dataset(n=200_000, seed=6, device=card)
    out = {}
    before = dict(build.LAUNCHES)
    for mode in ("batched", "sequential"):
        sv = ServingEngine(AQPEngine(ds, IndexConfig(
            grid0=(8, 8), min_split_count=512, init_metadata_attrs=("a0",))),
            mode=mode, crack_budget=3, prefetch_rows=20_000)
        sessions = [sv.open_session(f"s{i}") for i in range(2)]
        res = []
        for tick in range(3):
            for i, s in enumerate(sessions):
                w = _pan(3, start=(100.0 + 400 * i, 150.0))[tick]
                if (tick + i) % 2:
                    s.heatmap(w, "mean", "a0", bins=(4, 4), phi=0.05)
                else:
                    s.query(w, "mean", "a0", phi=0.05)
            res.append((sv.tick(), dict(sv.last_publish),
                        [dict(p) for p in sv.last_prefetch]))
        out[mode] = (res, sv.index)
    for (ra, pa, fa), (rb, pb, fb) in zip(out["batched"][0],
                                          out["sequential"][0]):
        assert pa == pb and fa == fb
        for a, b in zip(ra, rb):
            assert (a.tiles_processed, a.exact, a.speculative_rows) == \
                (b.tiles_processed, b.exact, b.speculative_rows)
            f = "values" if hasattr(a, "values") else "value"
            np.testing.assert_allclose(np.atleast_1d(getattr(a, f)),
                                       np.atleast_1d(getattr(b, f)),
                                       rtol=1e-12)
    assert any(p["rows_read"] > 0 for _, _, f in out["batched"][0] for p in f)
    assert torch.equal(out["batched"][1].perm, out["sequential"][1].perm)
    for k in ("segment_window_agg_multi", "segment_window_bin_select_multi"):
        assert build.LAUNCHES[k] > before.get(k, 0), k


def _stream(device, n_chunks=4, rows=50_000, ingest=3):
    from repro_torch.data import ChunkedDataset, make_streaming_chunks
    src = make_streaming_chunks(n_chunks=n_chunks, rows_per_chunk=rows,
                                n_columns=2, seed=31)
    cds = ChunkedDataset(device=device)
    for x, y, cols in src[:ingest]:
        cds.ingest(x, y, cols)
    return cds, src


def test_chunked_path_cuda_matches_torch(card):
    """A chunk forest on the card, "cuda" against "torch": windows across
    chunk edges (composite rounds), a min query over value-pruned chunks,
    an ingest and a retire; equal reads, splits, pruning and each
    forest's permutation, values to float64 order."""
    from repro_torch.core import ChunkIndexSet
    wins = [(230.0, 100.0, 520.0, 800.0), (240.0, 0.0, 560.0, 1000.0),
            (100.0, 300.0, 700.0, 600.0)]
    out = {}
    for backend in ("torch", "cuda"):
        cds, src = _stream(card)
        eng = AQPEngine(cds, IndexConfig(grid0=(8, 8), min_split_count=512,
                                         init_metadata_attrs=("a0",),
                                         backend=backend))
        assert isinstance(eng.index, ChunkIndexSet)
        res = []
        for step in range(2):
            for w in wins:
                res.append(eng.query(w, "mean", "a0", phi=0.05))
                res.append(eng.heatmap(w, "sum", "a0", bins=(4, 4),
                                       phi=0.05))
                res.append(eng.query(w, "min", "a0", phi=0.0))
            cds.ingest(*src[3])
            cds.retire(cds.live_ids[0])
        out[backend] = (res, eng)
    for a, c in zip(out["torch"][0], out["cuda"][0]):
        assert (a.objects_read, a.read_calls, a.batch_rounds,
                a.tiles_processed, a.pruned_chunks) == \
            (c.objects_read, c.read_calls, c.batch_rounds,
             c.tiles_processed, c.pruned_chunks)
        f = "values" if hasattr(a, "values") else "value"
        np.testing.assert_allclose(np.atleast_1d(getattr(c, f)),
                                   np.atleast_1d(getattr(a, f)), rtol=1e-12)
    it, ic = out["torch"][1].index, out["cuda"][1].index
    assert it.built_ids() == ic.built_ids()
    for cid in ic.built_ids():
        assert torch.equal(it._indexes[cid].perm, ic._indexes[cid].perm)
    ic.check_invariants("a0")


def test_chunked_tick_cuda_matches_torch(card):
    """The serving tick over three chunks on the card, "cuda" against
    "torch", the first chunk's storage closed before the second tick:
    equal degradation, reads and publication."""
    from repro_torch.core import ServingEngine
    out = {}
    for backend in ("torch", "cuda"):
        cds, _ = _stream(card)
        sv = ServingEngine(AQPEngine(cds, IndexConfig(
            grid0=(8, 8), min_split_count=512, init_metadata_attrs=("a0",),
            backend=backend)))
        sessions = [sv.open_session() for _ in range(3)]
        res = []
        for tick in range(2):
            if tick:
                cds.chunk(cds.live_ids[0]).data.close()
            for i, s in enumerate(sessions):
                w = (200.0 + 50 * i + 10 * tick, 100.0, 560.0, 900.0)
                s.query(w, "mean", "a0", phi=0.05 * (1 - tick))
                s.heatmap(w, "mean", "a0", bins=(4, 4), phi=0.05)
            res.append((sv.tick(), dict(sv.last_publish)))
        out[backend] = res
    for (rt, pt), (rc, pc) in zip(out["torch"], out["cuda"]):
        assert pt == pc
        for a, c in zip(rt, rc):
            assert (a.objects_read, a.tiles_processed, a.exact,
                    a.retired_during_query) == \
                (c.objects_read, c.tiles_processed, c.exact,
                 c.retired_during_query)
            f = "values" if hasattr(a, "values") else "value"
            np.testing.assert_allclose(np.atleast_1d(getattr(c, f)),
                                       np.atleast_1d(getattr(a, f)),
                                       rtol=1e-12)
    assert any(r.retired_during_query for r in out["cuda"][1][0])


def test_zone_map_on_the_card(card):
    """A device chunk's zone map equals numpy's float32 min/max as Python
    floats, a NaN included."""
    from repro_torch.data import ChunkedDataset
    rng = np.random.default_rng(8)
    x, y = rng.uniform(0, 10, (2, 100_000)).astype(np.float32)
    a0 = rng.normal(0, 1, 100_000).astype(np.float32)
    a1 = a0.copy()
    a1[777] = np.nan
    cds = ChunkedDataset(device=card)
    cds.ingest(x, y, {"a0": a0, "a1": a1})
    vr = cds.chunk(0).val_range
    assert vr["a0"] == (float(np.min(a0)), float(np.max(a0)))
    assert np.isnan(vr["a1"][0]) and np.isnan(vr["a1"][1])


# --- the one-launch kernels (rows 1-4 and 6-10 of PERF.md's kernel
# table; segment_window_agg twice: one window, and the all-covering window
# the index's enrichment passes with the value plane as x, y and v; the
# even split of rows 2 and 3 twice: 2x2 cells, kept in registers, as the
# main path splits, and 4x4, folded per lane; the multi-window heatmap
# ops of rows 9 and 10 twice: as given, and as 64 segments of 16x16 bins,
# 16 384 cells that fold into the global workspace)

ONE_LAUNCH = ("segment_window_agg", "segment_window_agg_everywhere",
              "segment_window_agg_multi", "segment_bin_agg",
              "segment_bin_agg_2x2", "bin_agg", "bin_agg_2x2",
              "segment_bin_agg_edges", "segment_window_bin_agg",
              "segment_window_bin_select", "segment_window_bin_agg_multi",
              "segment_window_bin_select_multi",
              "segment_window_bin_agg_multi_s64",
              "segment_window_bin_select_multi_s64")


def _counter(op):
    """The launch counter of a ``ONE_LAUNCH`` entry."""
    return op.removesuffix("_2x2").removesuffix("_s64")


def _one_launch_call(op, xs, ys, vals, b, bb, bins=(8, 8), g=None):
    """``call(v, backend)`` for one of the one-launch ops on these
    planes: a 300 x 300 window (one per segment, crossing its bbox, for
    the multi ops), ``bins``, ``g x g`` split cells (by default 2 for the
    ``_2x2`` entries, else 4); query spans with an empty one for the
    multi select. The ``_s64`` entries cut each segment into 64 // S
    pieces (decreasing boundaries stay decreasing) and take 16x16
    bins."""
    if g is None:
        g = 2 if op.endswith("_2x2") else 4
    if op.endswith("_s64"):
        k = max(1, 64 // (len(b) - 1))
        bb = np.repeat(bb[:len(b) - 1], k, axis=0)
        b = np.append(np.concatenate(
            [np.linspace(lo, hi, k, endpoint=False)
             for lo, hi in zip(b[:-1], b[1:])]), b[-1]).astype(np.int64)
        bins = (16, 16)
    op = _counter(op)
    n_seg = len(b) - 1
    w = (100.3, 100.7, 400.1, 400.9)
    wins = [tuple(float(v) + 0.3 for v in (
        r[0] + 0.25 * (r[2] - r[0]), r[1] + 0.25 * (r[3] - r[1]),
        r[0] + 0.75 * (r[2] - r[0]), r[1] + 0.75 * (r[3] - r[1])))
        for r in bb[:n_seg]]
    xe, ye = _edges(bb, g, 2)
    vmin = np.full(n_seg, -200.0)
    vmax = np.linspace(50.0, 300.0, n_seg)
    qb = np.array([0, n_seg // 4, n_seg // 4, n_seg // 2, n_seg])
    n0 = int(b[1])
    calls = {
        "segment_window_agg": lambda v, be: ops.segment_window_agg(
            xs, ys, v, b, w, backend=be),
        "segment_window_agg_everywhere":
            lambda v, be: ops.segment_window_agg(v, v, v, b, EVERYWHERE,
                                                 backend=be),
        "segment_window_agg_multi":
            lambda v, be: ops.segment_window_agg_multi(xs, ys, v, b, wins,
                                                       backend=be),
        "segment_bin_agg": lambda v, be: ops.segment_bin_agg(
            xs, ys, v, b, bb[:n_seg], gx=g, gy=g, backend=be),
        "bin_agg": lambda v, be: ops.bin_agg(
            xs[:n0], ys[:n0], v[:n0], bb[0], gx=g, gy=g, backend=be),
        "segment_bin_agg_edges": lambda v, be: ops.segment_bin_agg_edges(
            xs, ys, v, b, xe, ye, backend=be),
        "segment_window_bin_agg": lambda v, be: ops.segment_window_bin_agg(
            xs, ys, v, b, w, bx=bins[0], by=bins[1], backend=be),
        "segment_window_bin_select":
            lambda v, be: ops.segment_window_bin_select(
                xs, ys, v, b, w, vmin, vmax, bx=bins[0], by=bins[1],
                backend=be),
        "segment_window_bin_agg_multi":
            lambda v, be: ops.segment_window_bin_agg_multi(
                xs, ys, v, b, wins, bx=bins[0], by=bins[1], backend=be),
        "segment_window_bin_select_multi":
            lambda v, be: ops.segment_window_bin_select_multi(
                xs, ys, v, b, wins, vmin, vmax, qb, bx=bins[0], by=bins[1],
                backend=be),
    }
    return calls[op]


def _check_one_launch(call, vals):
    got = call(vals, "cuda")
    torch.cuda.synchronize()
    want = call(vals, "torch")
    absv = call(vals.abs(), "torch")
    if isinstance(got, tuple):
        assert torch.equal(got[1], want[1])       # suffix_w, bit for bit
        if len(got[1]) == len(got[0]) + 1:
            # the one-window select's zero row S (the multi select's
            # suffix has one row a segment, and no zero row)
            assert (got[1][-1] == 0).all()
        got, want, absv = got[0], want[0], absv[0]
    _assert_equal_rows(got, want, absv[..., 1])


def _planes(card, seed, n_seg=8, rows=20_000, empty=()):
    xs, ys, vals, b, bb = _case(seed, n_seg=n_seg, rows=rows)
    counts = np.diff(b)
    counts[list(empty)] = 0
    b = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return (*(torch.from_numpy(a).to(card) for a in (xs, ys, vals)), b, bb)


@pytest.mark.parametrize("op", ONE_LAUNCH)
def test_one_launch_back_to_back_calls_agree(card, op):
    """Two calls in a row, each against the plain version: the first
    call's last block left the workspace and the ticket as it found
    them."""
    xs, ys, vals, b, bb = _planes(card, 11)
    call = _one_launch_call(op, xs, ys, vals, b, bb)
    _check_one_launch(call, vals)
    _check_one_launch(call, vals)


def test_one_launch_tables_of_different_sizes_interleave(card):
    """Calls whose tables differ in size (S·nb from 1 to 512 cells, and
    the split's S·k) share one workspace in turns."""
    xs, ys, vals, b, bb = _planes(card, 12)
    b1 = b[[0, 1]]
    for op in ONE_LAUNCH * 2:
        for args, kw in (((xs, ys, vals, b, bb), {}),
                         ((xs, ys, vals, b1, bb[:1]), {"bins": (1, 1),
                                                       "g": 1}),
                         ((xs, ys, vals, b, bb), {"bins": (2, 2), "g": 2})):
            _check_one_launch(_one_launch_call(op, *args, **kw), vals)


@pytest.mark.parametrize("op", ONE_LAUNCH)
@pytest.mark.parametrize("shift", [(0, 1, 2), (1, 1, 1), (3, 3, 0)],
                         ids=["apart", "together", "v_apart"])
def test_one_launch_planes_at_any_offset(card, op, shift):
    """x, y and v as views starting ``shift`` floats into their buffers:
    at different offsets mod 16 (the scalar walk), all at one offset (a
    scalar head, the float4 body, a scalar tail), v alone apart."""
    xs, ys, vals, b, bb = _planes(card, 13)
    L = int(b[-1])
    views = [torch.cat([p[:s], p, p[:3]])[s:s + L]
             for p, s in zip((xs, ys, vals), shift)]
    for p, s in zip(views, shift):
        assert p.data_ptr() % 16 == 4 * s % 16
    _check_one_launch(_one_launch_call(op, *views[:2], views[2], b, bb),
                      views[2])


@pytest.mark.parametrize("op", ONE_LAUNCH)
@pytest.mark.parametrize("case", ["S=64", "empty_stream", "past_2048"])
def test_one_launch_edge_shapes(card, op, case):
    """64 segments; a stream whose segments are all empty (the last
    block still writes the empty rows); 32 segments with 16x16 bins and
    8x8 split cells: the heatmap ops' tables past the 2048 shared cells
    fold into the global workspace, and the even split's 2048 cells (its
    limit) take one table a block."""
    if case == "S=64":
        xs, ys, vals, b, bb = _planes(card, 14, n_seg=64, rows=2000)
        kw = {}
    elif case == "empty_stream":
        xs, ys, vals, b, bb = _planes(card, 15, empty=range(8))
        assert b[-1] == 0
        kw = {}
    else:
        xs, ys, vals, b, bb = _planes(card, 16, n_seg=32, rows=3000)
        kw = {"bins": (16, 16), "g": 8}
    _check_one_launch(_one_launch_call(op, xs, ys, vals, b, bb, **kw), vals)


@pytest.mark.parametrize("op", ONE_LAUNCH)
def test_one_launch_kernels_launch_once_a_call(card, op):
    """``torch.profiler`` sees exactly one kernel a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    xs, ys, vals, b, bb = _planes(card, 17)
    call = _one_launch_call(op, xs, ys, vals, b, bb)
    call(vals, "cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            call(vals, "cuda")
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA and "at::" not in e.name
               and not e.name.lower().startswith(("memset", "memcpy"))]
    assert len(kernels) == 5, kernels


@pytest.mark.parametrize("op", ONE_LAUNCH)
def test_one_launch_refused_launch_leaves_next_call_correct(card, op,
                                                            monkeypatch):
    """Boundaries that decrease, let past the wrapper's own check: the
    library refuses the launch, the wrapper raises and drops its
    workspace, and the next call is right."""
    from repro_torch.kernels import fused_select as fs
    from repro_torch.kernels import segment_agg as sa

    from repro_torch.kernels import bin_agg as ba

    xs, ys, vals, b, bb = _planes(card, 18)
    call = _one_launch_call(op, xs, ys, vals, b, bb)
    _check_one_launch(call, vals)
    bad = b.copy()
    bad[3], bad[4] = bad[4], bad[3]
    before = build.LAUNCHES[_counter(op)]
    with monkeypatch.context() as m:
        for mod in (sa, fs):
            m.setattr(mod, "host_bounds",
                      lambda bnd: np.asarray(bnd, np.int64))
        refused = _one_launch_call(op, xs, ys, vals, bad, bb)
        if _counter(op) == "bin_agg":
            # one segment, so no boundaries to break: a 64 x 64 grid,
            # past the table the library takes, let past the wrappers
            m.setattr(ba, "_check_grid", lambda gx, gy: None)
            m.setattr(sa, "MAX_TABLE_CELLS", 1 << 30)
            refused = _one_launch_call(op, xs, ys, vals, b, bb, g=64)
        with pytest.raises(RuntimeError, match="launch failed"):
            refused(vals, "cuda")
    assert build.LAUNCHES[_counter(op)] == before
    stream = torch.cuda.current_stream(card).cuda_stream
    assert (card.index or 0, stream) not in sa._WORKSPACES \
        and (card.index, stream) not in sa._WORKSPACES
    _check_one_launch(call, vals)


def test_one_launch_streams_keep_their_own_workspace(card):
    """Calls on two streams at once each take their stream's workspace:
    both results are right, and each stream holds its own."""
    from repro_torch.kernels import segment_agg as sa

    xs, ys, vals, b, bb = _planes(card, 19)
    calls = [_one_launch_call(op, xs, ys, vals, b, bb) for op in ONE_LAUNCH]
    want = [call(vals, "torch") for call in calls]
    absv = [call(vals.abs(), "torch") for call in calls]
    streams = [torch.cuda.Stream(card) for _ in range(2)]
    torch.cuda.synchronize()
    got = []
    for _ in range(3):
        for s in streams:
            with torch.cuda.stream(s):
                got.append([call(vals, "cuda") for call in calls])
    torch.cuda.synchronize()
    keys = {(xs.device.index, s.cuda_stream) for s in streams}
    assert keys <= set(sa._WORKSPACES)
    assert len({sa._WORKSPACES[k].data_ptr() for k in keys}) == 2
    for results in got:
        for g, w, a in zip(results, want, absv):
            if isinstance(g, tuple):
                assert torch.equal(g[1], w[1])
                g, w, a = g[0], w[0], a[0]
            _assert_equal_rows(g, w, a[..., 1])


# --- NaN values (PERF.md's NaN rule): every CUDA op against "np"

NAN_OPS = ("segment_window_agg", "segment_window_agg_everywhere",
           "segment_bin_agg", "bin_agg", "segment_bin_agg_edges",
           "window_agg", "segment_window_bin_agg",
           "segment_window_bin_select", "segment_window_agg_multi",
           "segment_window_bin_agg_multi", "segment_window_bin_select_multi")


@pytest.mark.parametrize("op", NAN_OPS)
def test_nan_values_on_the_card(card, op):
    """One NaN value on a folded object (inside the window, or the
    segment's own window, or any object of the split ops' first segment)
    and a whole segment of NaN values: under "cuda" each counts, and
    makes its cell's sum, min and max NaN, as the "np" mirror gives
    them. Counts and extrema equal (NaN equal to NaN); sums NaN where the
    mirror's are, elsewhere within 1e-12 · Σ|v| (the float32 rows of
    ``bin_agg`` and ``window_agg``: within float32 rounding)."""
    xs, ys, vals, b, bb = _case(21)
    n_seg = len(b) - 1
    w = (100.0, 100.0, 400.0, 400.5)
    wins = [tuple(float(np.float32(v)) for v in (
        r[0] + 0.25 * (r[2] - r[0]), r[1] + 0.25 * (r[3] - r[1]),
        r[0] + 0.75 * (r[2] - r[0]), r[1] + 0.75 * (r[3] - r[1])))
        for r in bb]
    xe, ye = _edges(bb, 4, 2)
    vmin = np.full(n_seg, -200.0)
    vmax = np.linspace(50.0, 300.0, n_seg)
    qb = np.array([0, 1, 4, n_seg], np.int64)
    n0 = int(b[1])
    if op.endswith("_multi"):
        sid = np.repeat(np.arange(n_seg), np.diff(b))
        r = np.asarray(wins)[sid]
        fold = (xs >= r[:, 0]) & (xs <= r[:, 2]) & (ys >= r[:, 1]) \
            & (ys <= r[:, 3])
    elif op in ("bin_agg", "segment_bin_agg", "segment_bin_agg_edges",
                "segment_window_agg_everywhere"):
        fold = np.arange(len(xs)) < n0
    else:
        fold = ops.window_mask_np(xs, ys, w)
    idx = np.flatnonzero(fold)
    vals[idx[len(idx) // 2]] = np.nan
    vals[b[5]:b[6]] = np.nan
    calls = {
        "segment_window_agg": lambda x, y, v, be: ops.segment_window_agg(
            x, y, v, b, w, backend=be),
        "segment_window_agg_everywhere":
            lambda x, y, v, be: ops.segment_window_agg(
                v, v, v, b, EVERYWHERE, backend=be),
        "segment_bin_agg": lambda x, y, v, be: ops.segment_bin_agg(
            x, y, v, b, bb, gx=2, gy=2, backend=be),
        "bin_agg": lambda x, y, v, be: ops.bin_agg(
            x[:n0], y[:n0], v[:n0], bb[0], gx=2, gy=2, backend=be),
        "segment_bin_agg_edges": lambda x, y, v, be:
            ops.segment_bin_agg_edges(x, y, v, b, xe, ye, backend=be),
        "window_agg": lambda x, y, v, be: ops.window_agg(
            x, y, v, w, backend=be),
        "segment_window_bin_agg": lambda x, y, v, be:
            ops.segment_window_bin_agg(x, y, v, b, w, bx=8, by=8,
                                       backend=be),
        "segment_window_bin_select": lambda x, y, v, be:
            ops.segment_window_bin_select(x, y, v, b, w, vmin, vmax, bx=8,
                                          by=8, backend=be),
        "segment_window_agg_multi": lambda x, y, v, be:
            ops.segment_window_agg_multi(x, y, v, b, wins, backend=be),
        "segment_window_bin_agg_multi": lambda x, y, v, be:
            ops.segment_window_bin_agg_multi(x, y, v, b, wins, bx=4, by=4,
                                             backend=be),
        "segment_window_bin_select_multi": lambda x, y, v, be:
            ops.segment_window_bin_select_multi(x, y, v, b, wins, vmin,
                                                vmax, qb, bx=4, by=4,
                                                backend=be),
    }
    call = calls[op]
    dx, dy, dv = (torch.from_numpy(a).to(card) for a in (xs, ys, vals))
    before = build.LAUNCHES[_counter(op)]
    got = call(dx, dy, dv, "cuda")
    torch.cuda.synchronize()
    assert build.LAUNCHES[_counter(op)] == before + 1
    want = call(xs, ys, vals, "np")
    absv = call(xs, ys, np.abs(np.nan_to_num(vals)), "np")
    if isinstance(got, tuple):
        np.testing.assert_array_equal(got[1].cpu().numpy(), want[1])
        got, want, absv = got[0], want[0], absv[0]
    g = got.cpu().numpy().reshape(-1, 4)
    w_ = np.asarray(want, np.float64).reshape(-1, 4)
    a = np.asarray(absv, np.float64).reshape(-1, 4)[:, 1]
    assert np.isnan(w_[:, 2]).any()
    np.testing.assert_array_equal(g[:, 0], w_[:, 0])
    np.testing.assert_array_equal(g[:, 2:], w_[:, 2:])
    nan = np.isnan(w_[:, 1])
    np.testing.assert_array_equal(np.isnan(g[:, 1]), nan)
    rtol = 2.0 ** -22 if op in ("bin_agg", "window_agg") else 1e-12
    assert (np.abs(g[~nan, 1] - w_[~nan, 1]) <= rtol * a[~nan]).all()


@pytest.mark.parametrize("op", ["bin_agg", "segment_bin_agg"])
def test_split_ownership_is_float64_on_the_card(card, op):
    """Objects within a few float32 ulps of a split line, where binning
    in float32 (the Pallas split kernels' rule) and in float64 (the
    host's rule) disagree: the kernels of rows 2 and 3 own each one by
    the float64 rule, cell for cell the "np" mirror's."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        x0, y0 = rng.uniform(0, 700, 2)
        wd = rng.uniform(10, 300)
        bbox = np.array([x0, y0, x0 + wd, y0 + wd])
        near = [np.float32(x0 + wd / 2)]
        for _ in range(3):
            near = ([np.nextafter(near[0], np.float32(-np.inf))] + near
                    + [np.nextafter(near[-1], np.float32(np.inf))])
        xs = np.array(near, np.float32)
        c64 = np.floor((xs.astype(np.float64) - x0) / (wd / 2))
        c32 = np.floor((xs - np.float32(x0)) / np.float32(wd / 2))
        if (c64 != c32).any():
            break
    else:
        pytest.fail("no float32/float64 disagreement found")
    # the line objects in the first segment, a plain second segment
    xs = np.concatenate([xs, rng.uniform(x0, x0 + wd, 50).astype(
        np.float32)])
    ys = np.full(len(xs), np.float32(y0 + wd / 4))
    vals = np.arange(len(xs), dtype=np.float32) - 3
    b = np.array([0, len(near), len(xs)], np.int64)
    bbs = np.stack([bbox, bbox])
    dx, dy, dv = (torch.from_numpy(a).to(card) for a in (xs, ys, vals))
    if op == "bin_agg":
        n = len(near)
        got = ops.bin_agg(dx[:n], dy[:n], dv[:n], bbox, gx=2, gy=2,
                          backend="cuda").cpu().numpy()
        want = ops.segment_bin_agg(xs[:n], ys[:n], vals[:n], b[:2], bbs[:1],
                                   gx=2, gy=2, backend="np")[0]
    else:
        got = ops.segment_bin_agg(dx, dy, dv, b, bbs, gx=2, gy=2,
                                  backend="cuda").cpu().numpy()
        want = ops.segment_bin_agg(xs, ys, vals, b, bbs, gx=2, gy=2,
                                   backend="np")
    got, want = got.reshape(-1, 4), np.asarray(want).reshape(-1, 4)
    assert got[0, 0] == (c64 == 0).sum()       # the float64 rule's split
    np.testing.assert_array_equal(got[:, [0, 2, 3]], want[:, [0, 2, 3]])
    np.testing.assert_array_equal(got[:, 1], want[:, 1])   # small integers


def test_nan_value_tile_metadata_on_the_card(card):
    """A NaN in the attribute column: under "cuda" the init enrichment
    and one ``read_batch`` round over the NaN's tile (its contribution,
    then ``apply_batch``'s enrichment and split) give the "np" index's
    tile metadata: NaN sum, min and max on every tile that holds the
    object; counts and extrema equal, float64 sums within 1e-12
    relative."""
    from repro_torch.core import TileIndex
    from repro_torch.data import RawDataset

    rng = np.random.default_rng(12)
    n, k = 200_000, 12_345
    x = rng.uniform(0, 1000, n).astype(np.float32)
    y = rng.uniform(0, 1000, n).astype(np.float32)
    a0 = rng.normal(5.0, 30.0, n).astype(np.float32)
    a0[k] = np.nan
    cfg = dict(grid0=(4, 4), min_split_count=64, init_metadata_attrs=("a0",))
    host = TileIndex(RawDataset(x, y, {"a0": a0.copy()}, device=None),
                     IndexConfig(backend="np", **cfg))
    dev = TileIndex(RawDataset(x, y, {"a0": a0.copy()}, device=card),
                    IndexConfig(backend="cuda", **cfg))
    slot = int(np.flatnonzero(host.perm == k)[0])
    nt = host.n_tiles
    tile = int(np.flatnonzero(
        host.active[:nt] & (host.offset[:nt] <= slot)
        & (slot < host.offset[:nt] + host.count[:nt]))[0])
    window = tuple(float(v) for v in host.bbox[tile])
    counters = ("segment_window_agg", "segment_window_agg_everywhere")
    before = {c: build.LAUNCHES[c] for c in counters}
    contribs = []
    for ix in (host, dev):
        c, payload = ix.read_batch(np.array([tile], np.int64), window, "a0")
        ix.apply_batch(payload, 1, [True])
        contribs.append(np.array(c, np.float64))
    for c in counters:
        assert build.LAUNCHES[c] > before[c], c
    nt = host.n_tiles
    assert dev.n_tiles == nt
    np.testing.assert_array_equal(dev.count[:nt], host.count[:nt])
    slot = int(np.flatnonzero(host.perm == k)[0])   # after the split
    holds = np.flatnonzero((host.offset[:nt] <= slot)
                           & (slot < host.offset[:nt] + host.count[:nt]))
    assert len(holds) >= 2
    for meta in ("meta_sum", "meta_min", "meta_max"):
        assert np.isnan(getattr(host, meta)["a0"][holds]).all()
    for meta in ("meta_min", "meta_max", "meta_valid"):
        np.testing.assert_array_equal(getattr(dev, meta)["a0"][:nt],
                                      getattr(host, meta)["a0"][:nt])
    np.testing.assert_allclose(dev.meta_sum["a0"][:nt],
                               host.meta_sum["a0"][:nt], rtol=1e-12,
                               equal_nan=True)
    np.testing.assert_array_equal(contribs[1][:, [0, 2, 3]],
                                  contribs[0][:, [0, 2, 3]])
    assert np.isnan(contribs[1][0, 1]) and np.isnan(contribs[0][0, 1])
