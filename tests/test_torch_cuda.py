"""The CUDA kernels on the card (marked ``cuda``; skipped without one).

Run on a machine with an NVIDIA Hopper GPU and ``nvcc``:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

The kernels build at first use. Each kernel is held against its plain
PyTorch version on the same CUDA tensors (counts and extrema equal,
float64 sums within 1e-12 · Σ|v|, the select op's suffix widths equal
bit for bit), and the main path, the heatmap path and the serving tick on the
``"cuda"`` backend against the same paths on ``"torch"``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import AQPEngine, IndexConfig
from repro_torch.data import exploration_path, make_synthetic_dataset
from repro_torch.kernels import build, ops

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
    "segment_window_bin_select_multi_16x16"])
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
    }
    counter = op.replace("_16x16", "")
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
