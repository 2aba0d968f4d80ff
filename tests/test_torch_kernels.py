"""The port's three main-path kernel ops against the reference's mirrors.

For ``segment_window_agg``, ``segment_bin_agg`` and ``bin_agg`` the
port's ``"np"`` backend must equal the reference's ``"np"`` mirror bit
for bit, and its ``"torch"`` backend (the plain versions the CUDA
kernels are held against on the card) must give equal counts and equal
extrema (compared with ``==``) and float64 sums within
``SUM_RTOL * sum|v|`` per cell: both sides sum in float64 in different
orders, whose difference is bounded by the magnitudes summed, not by
the (possibly cancelling) result. ``segment_window_agg`` is also held
against the reference's Pallas kernel (interpret mode): counts and
extrema equal (its float32 sums are not compared).

Inputs come from numpy seeds and reach both packages as the same arrays.
"""
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro_torch.kernels import ops as pops

SUM_RTOL = 1e-12


def make_segments(seed, n_seg, rows, empty=(), on_lines=0, gx=2, gy=2,
                  negative=False):
    """Concatenated segments, each in its own float64 bbox. ``on_lines``
    objects per segment sit on the bbox's even split lines (float32
    rounding of the float64 line, and both float32 neighbours)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(rows // 2, rows + 1, n_seg)
    counts[list(empty)] = 0
    b = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    n = int(b[-1])
    bb = np.empty((n_seg, 4))
    xs = np.empty(n, np.float32)
    ys = np.empty(n, np.float32)
    for s in range(n_seg):
        x0, y0 = rng.uniform(0, 700, 2)
        w, h = rng.uniform(10, 300, 2)
        bb[s] = (x0, y0, x0 + w, y0 + h)
        c = int(counts[s])
        xs[b[s]:b[s + 1]] = rng.uniform(x0, x0 + w, c)
        ys[b[s]:b[s + 1]] = rng.uniform(y0, y0 + h, c)
        k = min(on_lines, c)
        if k:
            lx = x0 + (x0 + w - x0) / gx * rng.integers(0, gx + 1, k)
            ly = y0 + (y0 + h - y0) / gy * rng.integers(0, gy + 1, k)
            step = rng.integers(-1, 2, k)
            lx32 = lx.astype(np.float32)
            xs[b[s]:b[s] + k] = np.where(
                step < 0, np.nextafter(lx32, np.float32(-np.inf)),
                np.where(step > 0, np.nextafter(lx32, np.float32(np.inf)),
                         lx32))
            ys[b[s]:b[s] + k] = ly.astype(np.float32)
    vals = rng.normal(5.0, 30.0, n).astype(np.float32)
    if negative:
        vals = -np.abs(vals) - 1.0
    return xs, ys, vals, b, bb


def window_edge_objects(xs, ys, window, rng, k=64):
    """Put ``k`` objects on the window's edges and their float32
    neighbours (the float32 compare rule decides them)."""
    xs, ys = xs.copy(), ys.copy()
    idx = rng.choice(len(xs), size=min(k, len(xs)), replace=False)
    x0, y0, x1, y1 = (np.float32(w) for w in window)
    for j, i in enumerate(idx):
        ex = (x0, x1)[j % 2]
        d = (j // 2) % 3 - 1
        xs[i] = ex if d == 0 else np.nextafter(
            ex, np.float32(np.inf) * d)
        ys[i] = np.float32(0.5) * (y0 + y1)
    return xs, ys


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_matches(got, want, abs_sum):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    g = np.asarray(got, np.float64).reshape(-1, 4)
    w = np.asarray(want, np.float64).reshape(-1, 4)
    assert np.array_equal(g[:, 0], w[:, 0]), "counts"
    assert (g[:, 2] == w[:, 2]).all() and (g[:, 3] == w[:, 3]).all(), \
        "extrema"
    a = np.asarray(abs_sum, np.float64).reshape(-1)
    assert (np.abs(g[:, 1] - w[:, 1]) <= SUM_RTOL * a).all(), "sums"


WINDOWS = {
    "window": (150.0, 120.0, 520.0, 610.7),
    "empty": (-50.0, -50.0, -10.0, -10.0),
    "everywhere": (-np.inf, -np.inf, np.inf, np.inf),
    "edges_0.7": (100.7, 0.7, 600.7, 900.7),
}
SEG_CASES = {
    "S1": dict(n_seg=1, rows=3000),
    "S8": dict(n_seg=8, rows=1500),
    "S64": dict(n_seg=64, rows=200),
    "S8_empty": dict(n_seg=8, rows=1500, empty=(0, 3, 7)),
    "S8_negative": dict(n_seg=8, rows=1500, negative=True),
}


@pytest.mark.parametrize("wname", list(WINDOWS))
@pytest.mark.parametrize("case", list(SEG_CASES))
def test_segment_window_agg(case, wname):
    window = WINDOWS[wname]
    xs, ys, vals, b, _ = make_segments(11, **SEG_CASES[case])
    if np.isfinite(window).all():
        xs, ys = window_edge_objects(xs, ys, window,
                                     np.random.default_rng(3))
    want = rops.segment_window_agg(xs, ys, vals, b, window, backend="np")
    got_np = pops.segment_window_agg(t(xs), t(ys), t(vals), b, window,
                                     backend="np")
    np.testing.assert_array_equal(got_np, want)
    absv = rops.segment_window_agg(xs, ys, np.abs(vals), b, window,
                                   backend="np")[:, 1]
    got = pops.segment_window_agg(t(xs), t(ys), t(vals), b, window,
                                  backend="torch")
    assert got.dtype == torch.float64 and got.shape == want.shape
    assert_matches(got, want, absv)


@pytest.mark.parametrize("case", ["S8", "S8_empty", "S8_negative"])
def test_segment_window_agg_matches_pallas(case):
    window = WINDOWS["edges_0.7"]
    xs, ys, vals, b, _ = make_segments(5, **SEG_CASES[case])
    xs, ys = window_edge_objects(xs, ys, window, np.random.default_rng(4))
    pallas = np.asarray(rops.segment_window_agg(xs, ys, vals, b, window,
                                                backend="pallas"))
    got = pops.segment_window_agg(t(xs), t(ys), t(vals), b, window,
                                  backend="torch").numpy()
    np.testing.assert_array_equal(got[:, 0], pallas[:, 0])
    assert (got[:, 2] == pallas[:, 2]).all()
    assert (got[:, 3] == pallas[:, 3]).all()


@pytest.mark.parametrize("grid", [(2, 2), (4, 4)])
@pytest.mark.parametrize("case", list(SEG_CASES))
def test_segment_bin_agg(case, grid):
    gx, gy = grid
    xs, ys, vals, b, bb = make_segments(
        23, on_lines=40, gx=gx, gy=gy, **SEG_CASES[case])
    want = rops.segment_bin_agg(xs, ys, vals, b, bb, gx=gx, gy=gy,
                                backend="np")
    got_np = pops.segment_bin_agg(t(xs), t(ys), t(vals), b, bb, gx=gx,
                                  gy=gy, backend="np")
    np.testing.assert_array_equal(got_np, want)
    absv = rops.segment_bin_agg(xs, ys, np.abs(vals), b, bb, gx=gx, gy=gy,
                                backend="np")[..., 1]
    got = pops.segment_bin_agg(t(xs), t(ys), t(vals), b, bb, gx=gx, gy=gy,
                               backend="torch")
    assert got.shape == want.shape
    assert_matches(got, want, absv)


@pytest.mark.parametrize("negative", [False, True])
@pytest.mark.parametrize("grid", [(2, 2), (4, 4)])
def test_bin_agg(grid, negative):
    """The reference mirror's rows are float32 (its sums rounded to
    float32): counts and extrema equal, sums within float32 rounding."""
    gx, gy = grid
    xs, ys, vals, b, bb = make_segments(31, 1, 4000, on_lines=300, gx=gx,
                                        gy=gy, negative=negative)
    want = rops.bin_agg(xs, ys, vals, bb[0], gx=gx, gy=gy, backend="np")
    got_np = pops.bin_agg(t(xs), t(ys), t(vals), bb[0], gx=gx, gy=gy,
                          backend="np")
    np.testing.assert_array_equal(got_np, want)
    got = pops.bin_agg(t(xs), t(ys), t(vals), bb[0], gx=gx, gy=gy,
                       backend="torch").numpy()
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    assert (got[:, 2:] == want[:, 2:]).all()
    # the torch sums are float64: against the float64 segment mirror
    exact = rops.segment_bin_agg(xs, ys, vals, b, bb, gx=gx, gy=gy,
                                 backend="np")[0]
    absv = rops.segment_bin_agg(xs, ys, np.abs(vals), b, bb, gx=gx, gy=gy,
                                backend="np")[0, :, 1]
    assert_matches(got, exact, absv)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=2.0 ** -23,
                               atol=0)


def test_split_ownership_is_float64():
    """Objects within a few float32 ulps of a split line, where binning
    in float32 (the Pallas split kernels' rule) and in float64 (the
    host's rule) disagree: the port owns each one by the float64 rule."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        x0, y0 = rng.uniform(0, 700, 2)
        w = rng.uniform(10, 300)
        bbox = np.array([x0, y0, x0 + w, y0 + w])
        near = [np.float32(x0 + w / 2)]
        for _ in range(3):
            near = ([np.nextafter(near[0], np.float32(-np.inf))] + near
                    + [np.nextafter(near[-1], np.float32(np.inf))])
        xs = np.array(near, np.float32)
        c64 = np.floor((xs.astype(np.float64) - x0) / (w / 2))
        c32 = np.floor((xs - np.float32(x0)) / np.float32(w / 2))
        if (c64 != c32).any():
            break
    else:
        pytest.fail("no float32/float64 disagreement found")
    ys = np.full(len(xs), np.float32(y0 + w / 4))
    vals = np.arange(len(xs), dtype=np.float32) - 3
    want = rops.bin_agg(xs, ys, vals, bbox, gx=2, gy=2, backend="np")
    got = pops.bin_agg(t(xs), t(ys), t(vals), bbox, gx=2, gy=2,
                       backend="torch").numpy()
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    assert got[0, 0] == (c64 == 0).sum()       # the float64 rule's split
    assert (got[:, 2:] == want[:, 2:]).all()


def test_backend_placement_rules():
    xs = torch.zeros(4)
    b = np.array([0, 4])
    with pytest.raises(TypeError):
        pops.segment_window_agg(xs, xs, xs, b, WINDOWS["window"],
                                backend="cuda")
    with pytest.raises(TypeError):
        pops.bin_agg(xs, xs, xs, (0, 0, 1, 1), gx=2, gy=2, backend="cuda")
    meta = torch.zeros(4, device="meta")
    with pytest.raises(TypeError):
        pops.segment_bin_agg(meta, meta, meta, b, np.zeros((1, 4)), gx=2,
                             gy=2, backend="np")
    with pytest.raises(ValueError):
        pops.segment_window_agg(xs, xs, xs, b, WINDOWS["window"],
                                backend="jnp")


# --------------------------------------------------------------------- #
# the heatmap slice's ops: segment_bin_agg_edges, segment_window_bin_agg,
# segment_window_bin_select
# --------------------------------------------------------------------- #

def split_edges(bb, g, rng, on_edges=0, xs=None, b=None):
    """Per-segment split edges: each bbox's ends plus ``g[0] - 1`` /
    ``g[1] - 1`` sorted interior cuts. With ``on_edges``, that many
    objects per segment move onto an interior x edge, its float32
    rounding or a float32 neighbour."""
    def axis(lo, hi, n):
        cuts = np.sort(rng.uniform(lo[:, None], hi[:, None],
                                   (len(lo), n - 1)), 1)
        return np.concatenate([lo[:, None], cuts, hi[:, None]], 1)
    xe, ye = axis(bb[:, 0], bb[:, 2], g[0]), axis(bb[:, 1], bb[:, 3], g[1])
    if on_edges and g[0] > 1:
        for s in range(len(bb)):
            k = min(on_edges, int(b[s + 1] - b[s]))
            e = xe[s, rng.integers(1, g[0], k)].astype(np.float32)
            step = rng.integers(-1, 2, k)
            xs[b[s]:b[s] + k] = np.where(
                step < 0, np.nextafter(e, np.float32(-np.inf)),
                np.where(step > 0, np.nextafter(e, np.float32(np.inf)), e))
    return xe, ye


def bin_line_objects(xs, ys, window, bins, rng, k=200):
    """Put ``k`` objects on the window's bin lines (the float32 rounding
    of each float64 line and both float32 neighbours), inside the
    window on the other axis."""
    xs, ys = xs.copy(), ys.copy()
    x0, y0, x1, y1 = window
    idx = rng.choice(len(xs), size=min(k, len(xs)), replace=False)
    for j, i in enumerate(idx):
        bx = bins[0]
        line = np.float32(x0 + (x1 - x0) / bx * rng.integers(0, bx + 1))
        d = j % 3 - 1
        xs[i] = line if d == 0 else np.nextafter(
            line, np.float32(np.inf) * d)
        ys[i] = np.float32(rng.uniform(y0, y1))
    return xs, ys


BIN_WINDOWS = {
    "window": (150.0, 120.0, 520.0, 610.7),
    "edges_0.7": (100.7, 0.7, 600.7, 900.7),
    "zero_area": (300.5, 300.5, 300.5, 300.5),
}


def heatmap_inputs(case, wname, bins, seed=17):
    window = BIN_WINDOWS[wname]
    xs, ys, vals, b, _ = make_segments(seed, **SEG_CASES[case])
    rng = np.random.default_rng(seed)
    if wname == "zero_area":
        # objects on the degenerate window's one point
        idx = rng.choice(len(xs), size=min(50, len(xs)), replace=False)
        xs[idx] = np.float32(window[0])
        ys[idx] = np.float32(window[1])
    else:
        xs, ys = bin_line_objects(xs, ys, window, bins, rng)
        xs, ys = window_edge_objects(xs, ys, window, rng)
    return xs, ys, vals, b, window


@pytest.mark.parametrize("bins", [(8, 8), (3, 5)])
@pytest.mark.parametrize("wname", list(BIN_WINDOWS))
@pytest.mark.parametrize("case", ["S1", "S8", "S64", "S8_empty",
                                  "S8_negative"])
def test_segment_window_bin_agg(case, wname, bins):
    bx, by = bins
    xs, ys, vals, b, window = heatmap_inputs(case, wname, bins)
    want = rops.segment_window_bin_agg(xs, ys, vals, b, window, bx=bx,
                                       by=by, backend="np")
    got_np = pops.segment_window_bin_agg(t(xs), t(ys), t(vals), b, window,
                                         bx=bx, by=by, backend="np")
    np.testing.assert_array_equal(got_np, want)
    absv = rops.segment_window_bin_agg(xs, ys, np.abs(vals), b, window,
                                       bx=bx, by=by, backend="np")[..., 1]
    got = pops.segment_window_bin_agg(t(xs), t(ys), t(vals), b, window,
                                      bx=bx, by=by, backend="torch")
    assert got.dtype == torch.float64 and got.shape == want.shape
    assert_matches(got, want, absv)
    if wname == "zero_area":
        assert want[..., 0].sum() > 0          # the point case ran


@pytest.mark.parametrize("bins", [(8, 8), (16, 16), (1, 1)])
@pytest.mark.parametrize("case", ["S1", "S8", "S64", "S8_empty"])
def test_segment_window_bin_select(case, bins):
    """The fused select op: the table as above, and ``suffix_w`` equal
    to the reference mirror's bit for bit on every port backend (it
    feeds ``round_certain``)."""
    bx, by = bins
    xs, ys, vals, b, window = heatmap_inputs(case, "window", bins)
    n_seg = len(b) - 1
    rng = np.random.default_rng(5)
    vmin = rng.uniform(-100, 0, n_seg)
    vmax = vmin + rng.uniform(0, 200, n_seg)
    want, want_w = rops.segment_window_bin_select(
        xs, ys, vals, b, window, vmin, vmax, bx=bx, by=by, backend="np")
    got_np, got_np_w = pops.segment_window_bin_select(
        t(xs), t(ys), t(vals), b, window, vmin, vmax, bx=bx, by=by,
        backend="np")
    np.testing.assert_array_equal(got_np, want)
    np.testing.assert_array_equal(got_np_w, want_w)
    got, got_w = pops.segment_window_bin_select(
        t(xs), t(ys), t(vals), b, window, vmin, vmax, bx=bx, by=by,
        backend="torch")
    assert got_w.shape == (n_seg + 1, bx * by)
    np.testing.assert_array_equal(got_w.numpy(), want_w)
    assert (got_w[-1] == 0).all()
    absv = rops.segment_window_bin_agg(xs, ys, np.abs(vals), b, window,
                                       bx=bx, by=by, backend="np")[..., 1]
    assert_matches(got, want, absv)


@pytest.mark.parametrize("grid", [(2, 2), (4, 3), (1, 4)])
@pytest.mark.parametrize("case", list(SEG_CASES))
def test_segment_bin_agg_edges(case, grid):
    xs, ys, vals, b, bb = make_segments(29, **SEG_CASES[case])
    xe, ye = split_edges(bb, grid, np.random.default_rng(3), on_edges=60,
                         xs=xs, b=b)
    want = rops.segment_bin_agg_edges(xs, ys, vals, b, xe, ye, backend="np")
    got_np = pops.segment_bin_agg_edges(t(xs), t(ys), t(vals), b, xe, ye,
                                        backend="np")
    np.testing.assert_array_equal(got_np, want)
    absv = rops.segment_bin_agg_edges(xs, ys, np.abs(vals), b, xe, ye,
                                      backend="np")[..., 1]
    got = pops.segment_bin_agg_edges(t(xs), t(ys), t(vals), b, xe, ye,
                                     backend="torch")
    assert got.shape == want.shape
    assert_matches(got, want, absv)


def lattice_segments(seed, lens=(0, 37, 500, 128, 3)):
    """Objects on half-integer coordinates and split edges on integers:
    every coordinate and edge is exact in float32, and no object lies on
    a bin line of ``LATTICE_WINDOW`` (cell size 128) or on a split edge —
    inputs where the Pallas kernels' float32 binning cannot differ from
    the host's."""
    rng = np.random.default_rng(seed)
    b = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    n_seg, n = len(lens), int(b[-1])
    xs = (rng.integers(0, 1000, n) + 0.5).astype(np.float32)
    ys = (rng.integers(0, 1000, n) + 0.5).astype(np.float32)
    vals = rng.normal(5.0, 30.0, n).astype(np.float32)
    cuts = np.sort(rng.choice(np.arange(1, 1000), (n_seg, 4)), 1)
    xe = np.concatenate([np.zeros((n_seg, 1)), cuts[:, :2],
                         np.full((n_seg, 1), 1000.0)], 1)
    ye = np.concatenate([np.zeros((n_seg, 1)), cuts[:, 2:3],
                         np.full((n_seg, 1), 1000.0)], 1)
    return xs, ys, vals, b, xe, ye


LATTICE_WINDOW = (128.0, 64.0, 640.0, 576.0)


@pytest.mark.parametrize("op", ["segment_bin_agg_edges",
                                "segment_window_bin_agg",
                                "segment_window_bin_select"])
def test_heatmap_kernels_match_pallas(op):
    """The port's plain versions against the reference's Pallas kernels
    (interpret mode) away from bin and split lines: counts and extrema
    equal; the Pallas sums are float32, so sums agree to float32
    rounding of Σ|v|."""
    xs, ys, vals, b, xe, ye = lattice_segments(7)
    w = LATTICE_WINDOW
    vmin = np.full(len(b) - 1, -150.0)
    vmax = np.full(len(b) - 1, 160.0)
    calls = {
        "segment_bin_agg_edges": lambda m, x, y, v, be: m.segment_bin_agg_edges(
            x, y, v, b, xe, ye, backend=be),
        "segment_window_bin_agg":
            lambda m, x, y, v, be: m.segment_window_bin_agg(
                x, y, v, b, w, bx=4, by=4, backend=be),
        "segment_window_bin_select":
            lambda m, x, y, v, be: m.segment_window_bin_select(
                x, y, v, b, w, vmin, vmax, bx=4, by=4, backend=be)[0],
    }
    call = calls[op]
    pallas = np.asarray(call(rops, xs, ys, vals, "pallas"),
                        np.float64).reshape(-1, 4)
    got = call(pops, t(xs), t(ys), t(vals), "torch").numpy().reshape(-1, 4)
    absv = np.asarray(call(rops, xs, ys, np.abs(vals), "np")).reshape(
        -1, 4)[:, 1]
    np.testing.assert_array_equal(got[:, 0], pallas[:, 0])
    occ = got[:, 0] > 0
    assert (got[occ, 2] == pallas[occ, 2]).all()
    assert (got[occ, 3] == pallas[occ, 3]).all()
    assert (np.abs(got[:, 1] - pallas[:, 1]) <= 1e-5 * absv + 1e-3).all()


def test_split_edges_stay_float64():
    """An object between ``f32(edge)`` and ``edge``: the reference's host
    reorganization (``edge_cell_ids_np``) compares in float64, its
    Pallas edges kernel against the edge rounded to float32. With the
    edge just above its float32 rounding f, the object at f lies left of
    the edge on the host and right of it in the Pallas kernel. The port
    follows the host rule on every backend — the Pallas kernel's child
    counts would disagree with the reorganized segments."""
    f = np.float32(37.3)
    e = float(f) + float(np.spacing(f)) / 4      # f32(e) == f < e
    assert np.float32(e) == f and float(f) < e
    xe = np.array([[0.0, e, 100.0]])
    ye = np.array([[0.0, 100.0]])
    xs = np.array([np.nextafter(f, np.float32(-np.inf)), f,
                   np.nextafter(f, np.float32(np.inf)), 5.0, 95.0],
                  np.float32)
    ys = np.full(len(xs), 50.0, np.float32)
    vals = np.arange(len(xs), dtype=np.float32)
    b = np.array([0, len(xs)], np.int64)
    want = rops.segment_bin_agg_edges(xs, ys, vals, b, xe, ye, backend="np")
    assert want[0, :, 0].tolist() == [3.0, 2.0]   # f sits left of e
    for backend in ("np", "torch"):
        got = np.asarray(pops.segment_bin_agg_edges(
            t(xs), t(ys), t(vals), b, xe, ye, backend=backend))
        np.testing.assert_array_equal(got[..., 0], want[..., 0])
        assert (got[..., 2:] == want[..., 2:]).all()
    pallas = np.asarray(rops.segment_bin_agg_edges(xs, ys, vals, b, xe, ye,
                                                   backend="pallas"))
    assert pallas[0, :, 0].tolist() == [2.0, 3.0]  # f rounded onto e


# --------------------------------------------------------------------- #
# the serving slice's ops: segment_window_agg_multi,
# segment_window_bin_agg_multi, segment_window_bin_select_multi
# --------------------------------------------------------------------- #

MULTI_CASES = {
    "S1": dict(n_seg=1, rows=3000),
    "S16": dict(n_seg=16, rows=600),
    "S64": dict(n_seg=64, rows=200),
    "S16_empty": dict(n_seg=16, rows=600, empty=(0, 5, 15)),
}
# query spans over the segments (spans of one segment included)
SPANS = {1: [0, 1], 16: [0, 1, 5, 6, 16], 64: [0, 8, 9, 30, 31, 64]}


def multi_inputs(case, bins=None, seed=41):
    """Segments in their own bboxes, segment s under its OWN window (a
    tuple of Python floats whose edges are not float32 values, crossing
    the segment's bbox), with objects on each window's edges and their
    float32 neighbours — and, given ``bins``, on its bin lines. The last
    segment's window has zero area, with objects on its point."""
    xs, ys, vals, b, bb = make_segments(seed, **MULTI_CASES[case])
    rng = np.random.default_rng(seed)
    windows = []
    for s in range(len(b) - 1):
        x0, y0, x1, y1 = bb[s]
        w = tuple(float(np.round(v, 1) + 0.03) for v in (
            x0 + 0.2 * (x1 - x0), y0 + 0.1 * (y1 - y0),
            x0 + 0.8 * (x1 - x0), y0 + 0.7 * (y1 - y0)))
        sl = slice(int(b[s]), int(b[s + 1]))
        if sl.stop > sl.start:
            if bins is not None:
                xs[sl], ys[sl] = bin_line_objects(xs[sl], ys[sl], w, bins,
                                                  rng, k=40)
            xs[sl], ys[sl] = window_edge_objects(xs[sl], ys[sl], w, rng,
                                                 k=30)
        windows.append(w)
    last = slice(int(b[-2]), int(b[-1]))
    if last.stop > last.start:
        px, py = np.float32(xs[last.start]), np.float32(ys[last.start])
        xs[last.start:last.start + 20] = px
        ys[last.start:last.start + 20] = py
        windows[-1] = (float(px), float(py), float(px), float(py))
    return xs, ys, vals, b, windows


def per_segment(fn, xs, ys, vals, b, windows):
    """The reference's single-window op on each segment under its own
    window — what each query's own read gives."""
    rows = []
    for s in range(len(b) - 1):
        one = np.array([0, b[s + 1] - b[s]], np.int64)
        sl = slice(int(b[s]), int(b[s + 1]))
        rows.append(fn(xs[sl], ys[sl], vals[sl], one, windows[s])[0])
    return np.stack(rows)


@pytest.mark.parametrize("case", list(MULTI_CASES))
def test_segment_window_agg_multi(case):
    """Each segment against its own window under the ticket's rule: the
    reference's single-window mirror on Python floats (float32 compare).
    Given a float64 array of windows, the port's mirror is the
    reference's multi mirror bit for bit."""
    xs, ys, vals, b, windows = multi_inputs(case)
    want = per_segment(lambda *a: rops.segment_window_agg(*a, backend="np"),
                       xs, ys, vals, b, windows)
    got_np = pops.segment_window_agg_multi(t(xs), t(ys), t(vals), b,
                                           windows, backend="np")
    np.testing.assert_array_equal(got_np, want)
    w64 = np.asarray(windows, np.float64)
    np.testing.assert_array_equal(
        pops.segment_window_agg_multi(t(xs), t(ys), t(vals), b, w64,
                                      backend="np"),
        rops.segment_window_agg_multi(xs, ys, vals, b, w64, backend="np"))
    absv = per_segment(
        lambda *a: rops.segment_window_agg(*a, backend="np"), xs, ys,
        np.abs(vals), b, windows)[:, 1]
    got = pops.segment_window_agg_multi(t(xs), t(ys), t(vals), b, windows,
                                        backend="torch")
    assert got.dtype == torch.float64 and got.shape == want.shape
    assert_matches(got, want, absv)
    assert want[-1, 0] >= 20 or int(b[-1] - b[-2]) == 0  # zero-area ran


def test_multi_window_compare_follows_the_ticket():
    """ROADMAP C.6: objects at ``float32(e) < e`` on a window's left edge
    e. The ticket's own read (a window of Python floats, compared in
    float32) counts them; the reference's multi mirror turns the windows
    into a float64 array and drops them. The port's multi op follows the
    ticket on every backend."""
    e = 300.3
    assert float(np.float32(e)) < e
    rng = np.random.default_rng(2)
    xs = np.full(40, np.float32(e))
    xs[20:] = rng.uniform(310, 400, 20).astype(np.float32)
    ys = rng.uniform(310, 400, 40).astype(np.float32)
    vals = rng.normal(0, 1, 40).astype(np.float32)
    b = np.array([0, 40], np.int64)
    window = (e, 300.0, 500.0, 500.0)
    single = rops.segment_window_agg(xs, ys, vals, b, window, backend="np")
    multi = rops.segment_window_agg_multi(xs, ys, vals, b, [window],
                                          backend="np")
    assert single[0, 0] == 40 and multi[0, 0] == 20
    for backend in ("np", "torch"):
        got = np.asarray(pops.segment_window_agg_multi(
            t(xs), t(ys), t(vals), b, [window], backend=backend))
        assert got[0, 0] == single[0, 0]
        assert (got[:, 2:] == single[:, 2:]).all()


@pytest.mark.parametrize("bins", [(4, 4), (16, 16)])
@pytest.mark.parametrize("case", list(MULTI_CASES))
def test_segment_window_bin_agg_multi(case, bins):
    bx, by = bins
    xs, ys, vals, b, windows = multi_inputs(case, bins)
    want = rops.segment_window_bin_agg_multi(xs, ys, vals, b, windows,
                                             bx=bx, by=by, backend="np")
    got_np = pops.segment_window_bin_agg_multi(
        t(xs), t(ys), t(vals), b, windows, bx=bx, by=by, backend="np")
    np.testing.assert_array_equal(got_np, want)
    absv = rops.segment_window_bin_agg_multi(
        xs, ys, np.abs(vals), b, windows, bx=bx, by=by,
        backend="np")[..., 1]
    got = pops.segment_window_bin_agg_multi(
        t(xs), t(ys), t(vals), b, windows, bx=bx, by=by, backend="torch")
    assert got.dtype == torch.float64 and got.shape == want.shape
    assert_matches(got, want, absv)


@pytest.mark.parametrize("bins", [(4, 4), (16, 16)])
@pytest.mark.parametrize("case", list(MULTI_CASES))
def test_segment_window_bin_select_multi(case, bins):
    """The serving tick's heatmap op: the table as above and
    ``suffix_w`` per query span bit for bit the reference mirror's —
    and each span's rows bit for bit the single-window select's over
    the span alone (what the sequential tick reads)."""
    bx, by = bins
    xs, ys, vals, b, windows = multi_inputs(case, bins)
    n_seg = len(b) - 1
    qb = np.array(SPANS[n_seg], np.int64)
    rng = np.random.default_rng(9)
    vmin = rng.uniform(-100, 0, n_seg)
    vmax = vmin + rng.uniform(0, 200, n_seg)
    want, want_w = rops.segment_window_bin_select_multi(
        xs, ys, vals, b, windows, vmin, vmax, qb, bx=bx, by=by,
        backend="np")
    got_np, got_np_w = pops.segment_window_bin_select_multi(
        t(xs), t(ys), t(vals), b, windows, vmin, vmax, qb, bx=bx, by=by,
        backend="np")
    np.testing.assert_array_equal(got_np, want)
    np.testing.assert_array_equal(got_np_w, want_w)
    got, got_w = pops.segment_window_bin_select_multi(
        t(xs), t(ys), t(vals), b, windows, vmin, vmax, qb, bx=bx, by=by,
        backend="torch")
    assert got_w.shape == (n_seg, bx * by)
    np.testing.assert_array_equal(got_w.numpy(), want_w)
    absv = rops.segment_window_bin_agg_multi(
        xs, ys, np.abs(vals), b, windows, bx=bx, by=by,
        backend="np")[..., 1]
    assert_matches(got, want, absv)
    # span q's rows: the single-window select over its segments, whose
    # widths are the same (the windows differ per segment, the counts
    # are the table's)
    w = want[:, :, 0] * (vmax - vmin)[:, None]
    for a, e in zip(qb[:-1], qb[1:]):
        single = np.concatenate([np.cumsum(w[a:e][::-1], 0)[::-1],
                                 np.zeros((1, bx * by))])
        np.testing.assert_array_equal(got_w.numpy()[a:e], single[:-1])


LATTICE_WINDOWS = [(0.0, 0.0, 512.0, 512.0), (128.0, 64.0, 640.0, 576.0),
                   (256.0, 384.0, 768.0, 896.0), (384.0, 0.0, 896.0, 512.0),
                   (0.0, 256.0, 512.0, 768.0)]


@pytest.mark.parametrize("op", ["segment_window_agg_multi",
                                "segment_window_bin_agg_multi",
                                "segment_window_bin_select_multi"])
def test_multi_kernels_match_pallas(op):
    """The port's plain versions against the reference's Pallas kernels
    (interpret mode) on lattice inputs, one window per segment: counts
    and extrema equal; the Pallas sums are float32, so sums agree to
    float32 rounding of Σ|v|."""
    xs, ys, vals, b, _, _ = lattice_segments(13)
    n_seg = len(b) - 1
    wins = LATTICE_WINDOWS[:n_seg]
    vmin = np.full(n_seg, -150.0)
    vmax = np.full(n_seg, 160.0)
    qb = np.array([0, 2, 3, n_seg], np.int64)
    calls = {
        "segment_window_agg_multi":
            lambda m, x, y, v, be: m.segment_window_agg_multi(
                x, y, v, b, wins, backend=be),
        "segment_window_bin_agg_multi":
            lambda m, x, y, v, be: m.segment_window_bin_agg_multi(
                x, y, v, b, wins, bx=4, by=4, backend=be),
        "segment_window_bin_select_multi":
            lambda m, x, y, v, be: m.segment_window_bin_select_multi(
                x, y, v, b, wins, vmin, vmax, qb, bx=4, by=4,
                backend=be)[0],
    }
    call = calls[op]
    pallas = np.asarray(call(rops, xs, ys, vals, "pallas"),
                        np.float64).reshape(-1, 4)
    got = call(pops, t(xs), t(ys), t(vals), "torch").numpy().reshape(-1, 4)
    absv = np.asarray(call(rops, xs, ys, np.abs(vals), "np")).reshape(
        -1, 4)[:, 1]
    np.testing.assert_array_equal(got[:, 0], pallas[:, 0])
    occ = got[:, 0] > 0
    assert occ.any()
    assert (got[occ, 2] == pallas[occ, 2]).all()
    assert (got[occ, 3] == pallas[occ, 3]).all()
    assert (np.abs(got[:, 1] - pallas[:, 1]) <= 1e-5 * absv + 1e-3).all()


def test_multi_ops_validate_their_inputs():
    xs = torch.zeros(4)
    b = np.array([0, 2, 4])
    w = [(0.0, 0.0, 1.0, 1.0)] * 2
    with pytest.raises(TypeError):
        pops.segment_window_agg_multi(xs, xs, xs, b, w, backend="cuda")
    with pytest.raises(ValueError):           # one window for two segments
        pops.segment_window_agg_multi(xs, xs, xs, b, w[:1], backend="torch")
    with pytest.raises(ValueError):           # spans must end at S
        pops.segment_window_bin_select_multi(
            xs, xs, xs, b, w, np.zeros(2), np.ones(2), [0, 1], bx=2, by=2,
            backend="torch")


def test_span_suffix_is_never_total_minus_tail():
    """Hazard 2: the reference's device epilogue takes a span's suffix as
    the global suffix minus the span's tail (``segmented_suffix``, float32
    there), which rounds differently from the span's own reversed cumsum
    even in float64. The port's per-span walk equals the mirror."""
    from repro.kernels.fused_select import segmented_suffix

    w = np.array([[0.1], [0.2], [0.3]])
    qb = np.array([0, 1, 3])
    mirror = np.concatenate([np.cumsum(w[a:b][::-1], 0)[::-1]
                             for a, b in zip(qb[:-1], qb[1:])])
    suf = np.cumsum(w[::-1], 0)[::-1]
    tail = np.concatenate([suf, np.zeros((1, 1))])[np.repeat(qb[1:],
                                                             np.diff(qb))]
    assert (suf - tail)[0, 0] != mirror[0, 0]          # float64 too
    qend = np.repeat(qb[1:], np.diff(qb)).astype(np.int32)
    dev = np.asarray(segmented_suffix(w.astype(np.float32), qend))
    assert not np.array_equal(dev.astype(np.float64), mirror)
    from repro_torch.kernels.fused_select import span_suffix
    agg = torch.zeros((3, 1, 4), dtype=torch.float64)
    agg[:, 0, 0] = 1.0
    got = span_suffix(agg, np.zeros(3), w[:, 0], qb, 3)
    np.testing.assert_array_equal(got.numpy(), mirror)


# --------------------------------------------------------------------- #
# the kernels bench's op: window_agg / window_count
# --------------------------------------------------------------------- #

# (plane length, logical n)
WA_CASES = {"n1": (1, None), "n7": (7, None), "n127": (127, None),
            "n4096": (4096, None), "n16384": (16384, None),
            "n_lt_len": (5000, 3001), "n0": (100, 0)}
# Python-float windows whose edges are not float32 values: the float32
# compare rule decides the objects put on them
WA_WINDOWS = {
    "window": (20.3, 20.7, 70.1, 69.9),
    "everywhere": (-np.inf, -np.inf, np.inf, np.inf),
    "empty": (200.0, 200.0, 300.0, 300.0),
}


def window_inputs(case, wname, seed=19, integer=False):
    """Points on [0, 100)², objects on the finite window's edges and
    their float32 neighbours; ``integer`` rounds the values to integers
    (|v| < 2^24 in every partial sum: exact in float32 in any order)."""
    length, n = WA_CASES[case]
    rng = np.random.default_rng(seed)
    xs = rng.uniform(0, 100, length).astype(np.float32)
    ys = rng.uniform(0, 100, length).astype(np.float32)
    vals = rng.normal(0, 10, length).astype(np.float32)
    if integer:
        vals = np.round(vals * 10)
    window = WA_WINDOWS[wname]
    if np.isfinite(window).all():
        xs, ys = window_edge_objects(xs, ys, window, rng)
    return xs, ys, vals, window, n


def assert_within_f32_ulp(got, want):
    """Counts and extrema equal; the float64 sum within one float32 ulp
    of the reference's row, which rounds its sum to float32."""
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float32)
    assert g[0] == w[0], "count"
    assert g[2] == w[2] and g[3] == w[3], "extrema"
    assert abs(g[1] - np.float64(w[1])) <= np.spacing(np.abs(w[1])), "sum"


@pytest.mark.parametrize("wname", list(WA_WINDOWS))
@pytest.mark.parametrize("case", list(WA_CASES))
def test_window_agg(case, wname):
    """Port "np" ≡ reference "np" bit for bit; port "torch" (exact count,
    float64 sum) against the reference's float32 row."""
    xs, ys, vals, window, n = window_inputs(case, wname)
    want = rops.window_agg(xs, ys, vals, window, n=n, backend="np")
    got_np = pops.window_agg(t(xs), t(ys), t(vals), window, n=n,
                             backend="np")
    assert got_np.dtype == want.dtype
    np.testing.assert_array_equal(got_np, want)
    got = pops.window_agg(t(xs), t(ys), t(vals), window, n=n,
                          backend="torch")
    assert got.dtype == torch.float64 and got.shape == (4,)
    assert_within_f32_ulp(got.numpy(), want)
    cnt_np = pops.window_count(t(xs), t(ys), window, n=n, backend="np")
    assert cnt_np == rops.window_count(xs, ys, window, n=n, backend="np")
    cnt = pops.window_count(t(xs), t(ys), window, n=n, backend="torch")
    assert cnt.dim() == 0 and cnt.dtype == torch.float64
    assert cnt.item() == want[0]


@pytest.mark.parametrize("case", list(WA_CASES))
def test_window_agg_matches_pallas(case):
    """Port "torch" against the reference's Pallas kernel (interpret
    mode), window edges on float32 neighbours: counts and extrema equal,
    and the sum within one float32 ulp of the Pallas row, which sums in
    float32 — on integer values, so that every float32 partial sum is
    exact and the Pallas block order cannot move it."""
    xs, ys, vals, window, n = window_inputs(case, "window", integer=True)
    pallas = np.asarray(rops.window_agg(xs, ys, vals, window, n=n,
                                        backend="pallas"))
    got = pops.window_agg(t(xs), t(ys), t(vals), window, n=n,
                          backend="torch").numpy()
    assert_within_f32_ulp(got, pallas)


def test_window_count_reads_no_values_and_ops_validate():
    xs, ys, vals, window, _ = window_inputs("n4096", "window")
    zeros = pops.window_agg(t(xs), t(ys), t(np.zeros_like(vals)), window,
                            backend="torch")
    assert torch.equal(pops.window_agg(t(xs), t(ys), None, window,
                                       backend="torch"), zeros)
    from repro_torch.kernels.window_agg import window_agg_cuda
    with pytest.raises(TypeError):        # a CPU tensor under "cuda"
        pops.window_agg(t(xs), t(ys), t(vals), window, backend="cuda")
    with pytest.raises(TypeError):
        pops.window_count(t(xs), t(ys), window, backend="cuda")
    with pytest.raises(TypeError):
        window_agg_cuda(t(xs), t(ys), t(vals), window)
    with pytest.raises(ValueError):       # n past the planes
        pops.window_agg(t(xs), t(ys), t(vals), window, n=len(xs) + 1,
                        backend="torch")


def test_split_kernel_edge_limit_raises_before_any_launch():
    """The split kernel takes its edges in its launch parameters: past
    ``EDGE_CAP`` interior edges the wrapper raises ``ValueError`` before
    it looks at the planes; within the limit it goes on to them (and a
    CPU tensor then raises ``TypeError``). No launch is counted."""
    from repro_torch.kernels import build
    from repro_torch.kernels import segment_agg as sa

    before = sum(build.LAUNCHES.values())
    xs = torch.zeros(16)
    for n_seg, span, err in ((4, sa.EDGE_CAP // 4, TypeError),
                             (4, sa.EDGE_CAP // 4 + 1, ValueError),
                             (sa.MAX_SEGMENTS + 1, 2, ValueError)):
        b = np.zeros(n_seg + 1, np.int64)
        # gx + gy - 2 = span interior edges a segment
        gx = span // 2 + 1
        gy = span - gx + 2
        xe = np.tile(np.linspace(0.0, 1.0, gx + 1), (n_seg, 1))
        ye = np.tile(np.linspace(0.0, 1.0, gy + 1), (n_seg, 1))
        assert n_seg * (gx + gy - 2) == n_seg * span
        with pytest.raises(err):
            sa.segment_bin_agg_edges_cuda(xs, xs, xs, b, xe, ye)
    assert sum(build.LAUNCHES.values()) == before


MULTI_BAD = {
    # case: (ops it applies to, error)
    "segments": (("agg", "select"), ValueError),      # S = 65
    "bins": (("agg", "select"), ValueError),          # a 0 x 2 bin grid
    "windows": (("agg", "select"), ValueError),       # S - 1 windows
    "widths": (("select",), ValueError),              # S - 1 widths
    "spans_start": (("select",), ValueError),         # qb[0] = 1
    "spans_end": (("select",), ValueError),           # qb[-1] = S - 1
    "spans_order": (("select",), ValueError),         # decreasing
    "spans_count": (("select",), ValueError),         # 65 spans
    "cpu_tensors": (("agg", "select"), TypeError),    # all else right
}


@pytest.mark.parametrize("case", list(MULTI_BAD))
def test_multi_bin_kernel_raises_before_any_launch(case):
    """The multi-window heatmap kernel's wrappers (rows 9 and 10) check
    every argument before the planes, and the planes before any launch:
    bad spans, too many segments, an empty bin grid and a count of
    windows or widths that is not S raise ``ValueError`` even for CPU
    tensors; right arguments on CPU tensors raise ``TypeError``. No
    launch is counted."""
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_select as fs
    from repro_torch.kernels import segment_agg as sa

    ops_of, err = MULTI_BAD[case]
    n_seg = sa.MAX_SEGMENTS + 1 if case == "segments" else 4
    b = np.arange(n_seg + 1, dtype=np.int64) * 4
    xs = torch.zeros(int(b[-1]))
    wins = [(0.0, 0.0, 1.0, 1.0)] * (n_seg - (case == "windows"))
    bx = 0 if case == "bins" else 2
    vmin = np.zeros(n_seg - (case == "widths"))
    qb = {"spans_start": [1, n_seg], "spans_end": [0, n_seg - 1],
          "spans_order": [0, 3, 2, n_seg],
          "spans_count": [0] * (sa.MAX_SEGMENTS + 1) + [n_seg]}.get(
              case, [0, 1, 1, n_seg])
    calls = {
        "agg": lambda: sa.segment_window_bin_agg_multi_cuda(
            xs, xs, xs, b, wins, bx, 2),
        "select": lambda: fs.segment_window_bin_select_multi_cuda(
            xs, xs, xs, b, wins, bx, 2, vmin, vmin + 1.0, np.array(qb))}
    before = dict(build.LAUNCHES)
    for op in ops_of:
        with pytest.raises(err):
            calls[op]()
    assert dict(build.LAUNCHES) == before


# (numpy record of the wrapper, its C struct, the source declaring it)
ARG_RECORDS = [("_SWA_ARGS", "SwaArgs", "segment_window_agg.cu"),
               ("_SBA_ARGS", "SbaArgs", "segment_bin_agg.cu"),
               ("_WIN_ARGS", "WinArgs", "segment_window_bin_agg.cu"),
               ("_MULTI_ARGS", "MultiArgs", "segment_window_bin_agg.cu")]


@pytest.mark.parametrize("record,struct,source", ARG_RECORDS,
                         ids=[r[1] for r in ARG_RECORDS])
def test_argument_records_have_their_c_struct_sizes(record, struct, source):
    """Each host argument record has the size its C struct asserts, and
    the wrapper checks that size against the library's export for the
    launch function that takes it (the check a library runs at first
    use)."""
    import re

    from repro_torch.kernels import build
    from repro_torch.kernels import segment_agg as sa

    text = (build.CSRC / source).read_text()
    size = re.search(rf"static_assert\(sizeof\({struct}\) == (\d+)", text)
    assert size and getattr(sa, record).itemsize == int(size.group(1))
    checked = [(fn, export) for fn, (export, n) in sa._ARGS_SIZE.items()
               if n == int(size.group(1))]
    assert len(checked) == 1
    fn, export = checked[0]
    assert f'extern "C" int {export}()' in text
    assert f"return (int)sizeof({struct});" in text.split(export)[1][:80]
    assert f'extern "C" int {fn}(' in text


def test_one_launch_workspace_starts_in_identity_state():
    """The one-launch kernels' workspace words decode, under the kernels'
    float encoding (``csrc/agg_common.cuh`` ``o2f``), to empty cells —
    count 0, sum 0, min +inf, max -inf — with the ticket at 0; a larger
    table replaces it, a smaller one reuses it."""
    from repro_torch.kernels import segment_agg as sa

    def o2f(o):
        u = (o & 0x7FFFFFFF) if o & 0x80000000 else (~o & 0xFFFFFFFF)
        return float(np.array([u], np.uint32).view(np.float32)[0])

    dev = torch.device("cpu")
    ws = sa.workspace(dev, 12345, 5)
    w = ws.numpy()
    assert len(w) == 3 * 5 + 1 and w[-1] == 0
    assert (w[0:15:3] == 0).all() and (w[1:15:3] == 0).all()
    for word in w[2:15:3].astype(np.uint64):
        assert o2f(int(word) & 0xFFFFFFFF) == np.inf
        assert o2f(int(word) >> 32) == -np.inf
    assert sa.workspace(dev, 12345, 3) is ws
    assert sa.workspace(dev, 12345, 6).numel() == 3 * 6 + 1
    assert sa.workspace(dev, 54321, 3) is not sa.workspace(dev, 12345, 3)
    sa._WORKSPACES.clear()


def test_select_pair_crosses_to_the_host_in_one_copy(monkeypatch):
    """``read_batch_heatmap`` copies the select kernel's table and suffix
    widths, adjacent views of one buffer, to the host in one copy; two
    separate tensors (the plain version's) take one copy each."""
    from repro_torch.core import index as index_mod

    copies = []
    real = index_mod._host

    def spy(a):
        copies.append(tuple(a.shape))
        return real(a)

    monkeypatch.setattr(index_mod, "_host", spy)
    buf = torch.arange(2 * 3 * 4 + 3 * 3, dtype=torch.float64)
    agg, suffix = buf[:24].view(2, 3, 4), buf[24:].view(3, 3)
    a, s = index_mod._host_pair(agg, suffix)
    assert copies == [(33,)]
    np.testing.assert_array_equal(a, agg.numpy())
    np.testing.assert_array_equal(s, suffix.numpy())
    copies.clear()
    a, s = index_mod._host_pair(agg.clone(), suffix.clone())
    assert copies == [(2, 3, 4), (3, 3)]
    np.testing.assert_array_equal(s, suffix.numpy())


# --------------------------------------------------------------------- #
# NaN values, in every op
# --------------------------------------------------------------------- #

NAN_OPS = ["segment_window_agg", "segment_bin_agg", "bin_agg",
           "segment_bin_agg_edges", "window_agg", "segment_window_bin_agg",
           "segment_window_bin_select", "segment_window_agg_multi",
           "segment_window_bin_agg_multi", "segment_window_bin_select_multi"]
# float32 values, so that the reference's float64 multi compare (ROADMAP
# C.6) and the ticket's float32 rule agree
NAN_WINDOW = (150.0, 120.0, 520.0, 610.5)


def nan_case(op, seed=43):
    """``(call(module, xs, ys, vals, backend), (xs, ys, vals))``: the
    op's inputs with one NaN value on an object inside the window (or
    the segment's own window; any object of the split ops' first
    segment)."""
    xs, ys, vals, b, bb = make_segments(seed, n_seg=8, rows=1500)
    n_seg = len(b) - 1
    rng = np.random.default_rng(seed)
    wins = [tuple(float(np.float32(v)) for v in (
        r[0] + 0.25 * (r[2] - r[0]), r[1] + 0.25 * (r[3] - r[1]),
        r[0] + 0.75 * (r[2] - r[0]), r[1] + 0.75 * (r[3] - r[1])))
        for r in bb]
    xe, ye = split_edges(bb, (4, 3), rng)
    vmin = np.full(n_seg, -150.0)
    vmax = np.full(n_seg, 160.0)
    qb = np.array([0, 3, n_seg], np.int64)
    n0 = int(b[1])
    calls = {
        "segment_window_agg": lambda m, x, y, v, be: m.segment_window_agg(
            x, y, v, b, NAN_WINDOW, backend=be),
        "segment_bin_agg": lambda m, x, y, v, be: m.segment_bin_agg(
            x, y, v, b, bb, gx=2, gy=2, backend=be),
        "bin_agg": lambda m, x, y, v, be: m.bin_agg(
            x[:n0], y[:n0], v[:n0], bb[0], gx=2, gy=2, backend=be),
        "segment_bin_agg_edges": lambda m, x, y, v, be:
            m.segment_bin_agg_edges(x, y, v, b, xe, ye, backend=be),
        "window_agg": lambda m, x, y, v, be: m.window_agg(
            x, y, v, NAN_WINDOW, backend=be),
        "segment_window_bin_agg": lambda m, x, y, v, be:
            m.segment_window_bin_agg(x, y, v, b, NAN_WINDOW, bx=4, by=4,
                                     backend=be),
        "segment_window_bin_select": lambda m, x, y, v, be:
            m.segment_window_bin_select(x, y, v, b, NAN_WINDOW, vmin, vmax,
                                        bx=4, by=4, backend=be),
        "segment_window_agg_multi": lambda m, x, y, v, be:
            m.segment_window_agg_multi(x, y, v, b, wins, backend=be),
        "segment_window_bin_agg_multi": lambda m, x, y, v, be:
            m.segment_window_bin_agg_multi(x, y, v, b, wins, bx=4, by=4,
                                           backend=be),
        "segment_window_bin_select_multi": lambda m, x, y, v, be:
            m.segment_window_bin_select_multi(x, y, v, b, wins, vmin, vmax,
                                              qb, bx=4, by=4, backend=be),
    }
    if op.endswith("_multi"):
        sid = np.repeat(np.arange(n_seg), np.diff(b))
        w = np.asarray(wins)[sid]
        inside = ((xs >= w[:, 0]) & (xs <= w[:, 2]) & (ys >= w[:, 1])
                  & (ys <= w[:, 3]))
    elif op in ("bin_agg", "segment_bin_agg", "segment_bin_agg_edges"):
        inside = np.arange(len(xs)) < n0
    else:
        inside = rops.window_mask_np(xs, ys, NAN_WINDOW)
    idx = np.flatnonzero(inside)
    vals[idx[len(idx) // 2]] = np.nan
    return calls[op], (xs, ys, vals)


def assert_matches_nan(got, want, abs_sum, rtol=SUM_RTOL):
    """:func:`assert_matches` where NaN equals NaN: counts equal, extrema
    equal, sums NaN where the mirror's are and within ``rtol * sum|v|``
    elsewhere."""
    g = np.asarray(got, np.float64).reshape(-1, 4)
    w = np.asarray(want, np.float64).reshape(-1, 4)
    np.testing.assert_array_equal(g[:, 0], w[:, 0])
    np.testing.assert_array_equal(g[:, 2:], w[:, 2:])
    nan = np.isnan(w[:, 1])
    np.testing.assert_array_equal(np.isnan(g[:, 1]), nan)
    a = np.asarray(abs_sum, np.float64).reshape(-1)[~nan]
    assert (np.abs(g[~nan, 1] - w[~nan, 1]) <= rtol * a).all(), "sums"


@pytest.mark.parametrize("op", NAN_OPS)
def test_nan_values_follow_the_mirror(op):
    """One NaN value on an object the op folds: the NaN object counts,
    and its cell's sum, min and max are NaN, as numpy's reductions give
    them. Port "np" ≡ reference "np" bit for bit (NaN equal to NaN);
    port "torch" equals it under the usual tolerances (the float32 rows
    of ``bin_agg`` and ``window_agg``: sums within float32 rounding)."""
    call, (xs, ys, vals) = nan_case(op)
    want = call(rops, xs, ys, vals, "np")
    got_np = call(pops, t(xs), t(ys), t(vals), "np")
    got = call(pops, t(xs), t(ys), t(vals), "torch")
    absv = call(rops, xs, ys, np.abs(np.nan_to_num(vals)), "np")
    if isinstance(want, tuple):                   # the select ops
        np.testing.assert_array_equal(got_np[1], want[1])
        np.testing.assert_array_equal(got[1].numpy(), want[1])
        want, got_np, got, absv = want[0], got_np[0], got[0], absv[0]
    np.testing.assert_array_equal(got_np, want)
    w = np.asarray(want, np.float64).reshape(-1, 4)
    hit = np.isnan(w[:, 2])
    assert hit.sum() == 1 and np.isnan(w[hit, 1:]).all() and w[hit, 0] > 0
    f32 = op in ("bin_agg", "window_agg")
    assert_matches_nan(got.numpy(), want,
                       np.asarray(absv, np.float64).reshape(-1, 4)[:, 1],
                       rtol=2.0 ** -22 if f32 else SUM_RTOL)
