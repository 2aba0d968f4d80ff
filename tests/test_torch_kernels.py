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
