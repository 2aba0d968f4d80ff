"""The AQP scenarios of ``tests/test_distributed.py``, written once for
both packages, and the ``torch.distributed`` rank worker of
``tests/test_torch_distributed.py``.

A scenario takes a package adapter (:class:`Ref` for ``repro`` on a jax
mesh, :class:`Port` for ``repro_torch`` on a ``ShardMesh``), runs the
reference test's own session with its assertions, and returns its
observations as a flat ``{name: numpy array}`` record: every result
field but the wall time, and the session state's arrays. This module
imports neither package at import time, so the reference can run it in a
subprocess with 8 fake jax devices (``run_reference``).
"""
import dataclasses
import os
import sys

import numpy as np

AQP_CFG = dict(grid=(16, 16), capacity=1024, min_split_count=128)
STATE = ("cell", "bbox", "active", "level", "count", "vmin", "vmax",
         "n_tiles")


class Ref:
    """The reference on a jax mesh of ``shape`` (names ``data``[,
    ``model``])."""

    def __init__(self):
        import jax
        import jax.numpy as jnp
        from repro.core import AQPEngine, AccuracyPolicy, IndexConfig
        from repro.core import distributed as dist
        from repro.data import ChunkedDataset, make_synthetic_dataset
        from repro.data.rawfile import RawDataset
        from repro.data.synthetic import (exploration_path,
                                          make_streaming_chunks)
        self.jax, self.jnp, self.dist = jax, jnp, dist
        self.AQPEngine, self.AccuracyPolicy = AQPEngine, AccuracyPolicy
        self.IndexConfig = IndexConfig
        self.ChunkedDataset, self.RawDataset = ChunkedDataset, RawDataset
        self.synthetic, self.path = make_synthetic_dataset, exploration_path
        self.streaming = make_streaming_chunks

    def mesh(self, shape):
        axes = ("data", "model")[:len(shape)]
        return self.jax.make_mesh(shape, axes)

    def engine(self, ds, shape, **cfg):
        return self.dist.DistributedAQPEngine(ds, self.mesh(shape),
                                              self.dist.DistConfig(**cfg))

    def dataset(self, n, seed):
        return self.synthetic(n=n, seed=seed)

    def raw(self, x, y, cols):
        return self.RawDataset(x, y, cols)

    def host_engine(self, ds, **kw):
        return self.AQPEngine(ds, self.IndexConfig(**kw))

    def chunked(self):
        return self.ChunkedDataset()

    def win(self, w):
        return self.jnp.asarray(w, self.jnp.float32)

    def heatmap_step(self, eng, cfg, bins, w, phi):
        step = self.dist.make_heatmap_step(eng.mesh, cfg, bins)
        return step(eng.xs, eng.ys, eng.vals["a0"], eng.domain,
                    self.win(w), self.jnp.float32(phi))


class Port:
    """The port on a ``ShardMesh`` of ``prod(shape)`` shards, on the
    CPU (or ``device``)."""

    def __init__(self, device="cpu"):
        from repro_torch.core import AQPEngine, AccuracyPolicy, IndexConfig
        from repro_torch.core import distributed as dist
        from repro_torch.core.mesh import ShardMesh
        from repro_torch.data import (ChunkedDataset, RawDataset,
                                      exploration_path,
                                      make_streaming_chunks,
                                      make_synthetic_dataset)
        self.device, self.dist, self.ShardMesh = device, dist, ShardMesh
        self.AQPEngine, self.AccuracyPolicy = AQPEngine, AccuracyPolicy
        self.IndexConfig = IndexConfig
        self.ChunkedDataset, self.RawDataset = ChunkedDataset, RawDataset
        self.synthetic, self.path = make_synthetic_dataset, exploration_path
        self.streaming = make_streaming_chunks

    def mesh(self, shape):
        return self.ShardMesh(int(np.prod(shape)), self.device)

    def engine(self, ds, shape, **cfg):
        return self.dist.DistributedAQPEngine(ds, self.mesh(shape),
                                              self.dist.DistConfig(**cfg))

    def dataset(self, n, seed):
        return self.synthetic(n=n, seed=seed, device=self.device)

    def raw(self, x, y, cols):
        return self.RawDataset(x, y, cols, device=self.device)

    def host_engine(self, ds, **kw):
        return self.AQPEngine(ds, self.IndexConfig(backend="torch", **kw))

    def chunked(self):
        return self.ChunkedDataset(device=self.device)

    def win(self, w):
        return w

    def heatmap_step(self, eng, cfg, bins, w, phi):
        step = self.dist.make_heatmap_step(eng.mesh, cfg, bins)
        return step(eng.xs, eng.ys, eng.vals["a0"], eng.domain, w, phi)


def host(a):
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def record_result(rec, name, r):
    for k, v in dataclasses.asdict(r).items():
        if k != "eval_time_s" and v is not None:
            rec[f"{name}.{k}"] = np.asarray(v)


def record_state(rec, name, state):
    for k in STATE:
        rec[f"{name}.{k}"] = host(getattr(state, k))


def column(ds, attr, n):
    return host(ds.read_all_unaccounted(attr))[:n]


def xy(ds, n):
    return host(ds.x)[:n], host(ds.y)[:n]


def window_mask_np(xs, ys, w):
    return (xs >= w[0]) & (xs <= w[2]) & (ys >= w[1]) & (ys <= w[3])


def window_bin_ids_np(xs, ys, w, bx, by):
    """The reference's host rule (``kernels.ref.window_bin_ids_np``)."""
    m = window_mask_np(xs, ys, w)
    cw = max((w[2] - w[0]) / bx, 1e-30)
    ch = max((w[3] - w[1]) / by, 1e-30)
    cx = np.clip(np.floor((xs - w[0]) / cw).astype(np.int64), 0, bx - 1)
    cy = np.clip(np.floor((ys - w[1]) / ch).astype(np.int64), 0, by - 1)
    return m, cy * bx + cx


# --------------------------------------------------------------------- #
# the scenarios (tests/test_distributed.py, AQP cases)
# --------------------------------------------------------------------- #

def query_oracle(P, shape=(4, 2)):
    """:26 — the session scalar path cracks and stays oracle-correct."""
    rec = {}
    ds = P.dataset(80_000, 3)
    eng = P.engine(ds, shape, **AQP_CFG)
    wins = P.path(ds, n_queries=6, target_objects=8000)
    n = eng_n(eng)
    xs, ys = xy(ds, n)
    col = column(ds, "a0", n)
    for phi in (0.0, 0.05):
        for i, w in enumerate(wins):
            r = eng.query(w, "a0", phi)
            truth = col[window_mask_np(xs, ys, w)].sum(dtype=np.float64)
            eps = 1e-5 * abs(truth) + 1e-2
            assert r.lo - eps <= truth <= r.hi + eps, (phi, w, r, truth)
            if phi == 0.0:
                np.testing.assert_allclose(r.value, truth, rtol=1e-3,
                                           atol=1.0)
            else:
                assert r.bound <= phi + 1e-6 or r.exact
            record_result(rec, f"q{phi}/{i}", r)
    tot = eng.trace.totals()
    assert tot["queries"] == 12 and tot["scalar_queries"] == 12
    assert tot["total_objects_read"] == sum(
        r.objects_read for r in eng.trace.results)
    assert list(eng.n_active.values())[0] > 16 * 16
    record_state(rec, "state", eng._states["a0"])
    return rec


def eng_n(eng):
    return len(host(eng.xs)) if not hasattr(eng, "n") else eng.n


def heatmap_oracle(P, shape=(4, 2)):
    """:62 — session heatmaps stay oracle-correct while the state cracks
    and the registry fills."""
    rec = {}
    bx, by = 6, 4
    ds = P.dataset(80_000, 3)
    eng = P.engine(ds, shape, **AQP_CFG)
    wins = P.path(ds, n_queries=4, target_objects=8000)
    n = eng_n(eng)
    xs, ys = xy(ds, n)
    col = column(ds, "a0", n)
    for phi in (0.0, 0.05):
        for i, w in enumerate(wins):
            r = eng.heatmap(w, "a0", bins=(bx, by), phi=phi)
            m, cid = window_bin_ids_np(xs, ys, w, bx, by)
            truth = np.bincount(cid[m], weights=col[m].astype(np.float64),
                                minlength=bx * by)
            occ = np.bincount(cid[m], minlength=bx * by) > 0
            eps = 1e-4 * np.abs(truth) + 0.5
            assert (r.lo[occ] - eps[occ] <= truth[occ]).all(), (phi, w)
            assert (truth[occ] <= r.hi[occ] + eps[occ]).all(), (phi, w)
            if phi == 0.0:
                np.testing.assert_allclose(r.values[occ], truth[occ],
                                           rtol=1e-3, atol=1.0)
            else:
                assert r.bound <= phi + 1e-6 or r.exact
            err = np.abs(r.values[occ] - truth[occ])
            cap = r.bin_bound[occ] * np.maximum(
                np.abs(r.values[occ]), 1e-9) + eps[occ]
            assert (err <= cap).all(), (phi, w)
            record_result(rec, f"h{phi}/{i}", r)
    assert eng.trace.totals()["heatmap_queries"] == 8
    record_state(rec, "state", eng._states["a0"])
    return rec


def session_repeat(P, shape=(8,)):
    """:111 — a repeated window reads fewer on query 2+; the stateless
    step pays the full price every time."""
    rec = {}
    ds = P.dataset(80_000, 5)
    cfg = dict(grid=(16, 16), capacity=2048, min_split_count=128)
    eng = P.engine(ds, shape, **cfg)
    w = P.path(ds, n_queries=1, target_objects=12_000)[0]
    rs = [eng.heatmap(w, "a0", bins=(6, 6), phi=0.02) for _ in range(3)]
    assert rs[0].objects_read > 0
    assert rs[1].objects_read < rs[0].objects_read
    assert rs[2].objects_read <= rs[1].objects_read
    s = [float(host(P.heatmap_step(eng, P.dist.DistConfig(**cfg), (6, 6),
                                   P.win(w), 0.02)["objects_read"]))
         for _ in range(2)]
    assert s[0] == s[1] and s[0] > 0
    assert rs[1].objects_read < s[1]
    q1 = eng.query(w, "a0", 0.02)
    q2 = eng.query(w, "a0", 0.02)
    assert q2.objects_read <= q1.objects_read
    for i, r in enumerate(rs + [q1, q2]):
        record_result(rec, f"r{i}", r)
    rec["stateless"] = np.asarray(s)
    record_state(rec, "state", eng._states["a0"])
    return rec


def policy_parity(P, shape=(8,)):
    """:153 — the uniform policy equals the scalar-φ build bit for bit,
    the stateless step a fresh session's first pass, and floored /
    salience φ_b allocations meet every per-bin budget, on the mesh and
    on the host engine."""
    rec = {}
    bx, by = 6, 4
    nb = bx * by
    ds = P.dataset(64_000, 7)
    cfg = dict(grid=(16, 16), capacity=1024, min_split_count=128)
    w = P.path(ds, n_queries=1, target_objects=10_000)[0]
    e1 = P.engine(ds, shape, **cfg)
    e2 = P.engine(ds, shape, **cfg)
    r1 = e1.heatmap(w, "a0", bins=(bx, by), phi=0.05, policy=None)
    r2 = e2.heatmap(w, "a0", bins=(bx, by), phi=0.05,
                    policy=P.AccuracyPolicy())
    for f in ("values", "lo", "hi", "bin_bound"):
        np.testing.assert_array_equal(getattr(r1, f), getattr(r2, f))
    assert (r1.objects_read, r1.tiles_processed) == \
        (r2.objects_read, r2.tiles_processed)
    record_result(rec, "uniform", r1)
    dc = P.dist.DistConfig(**cfg)
    init = P.dist.make_init_state(e1.mesh, dc)
    sess = P.dist.make_session_heatmap_step(e1.mesh, dc, (bx, by), "sum",
                                            with_policy=False)
    st = init(e1.xs, e1.ys, e1.vals["a0"], e1.domain)
    cache = (P.dist._empty_cache(dc.capacity, nb) if isinstance(P, Ref)
             else P.dist._empty_cache(dc.capacity, nb, "sum", e1.xs.device))
    zeros = (P.jnp.zeros((nb,), P.jnp.float32) if isinstance(P, Ref)
             else np.zeros(nb, np.float32))
    phi = P.jnp.float32(0.05) if isinstance(P, Ref) else 0.05
    eps0 = P.jnp.float32(0.0) if isinstance(P, Ref) else 0.0
    out_s, _ = sess(st, cache, e1.xs, e1.ys, e1.vals["a0"], P.win(w), phi,
                    zeros, eps0)
    out_w = P.heatmap_step(e1, dc, (bx, by), P.win(w), 0.05)
    for f in ("values", "lo", "hi", "bin_bound", "objects_read",
              "n_processed"):
        np.testing.assert_array_equal(host(out_s[f]), host(out_w[f]))
        rec[f"stateless.{f}"] = host(out_w[f])

    rng = np.random.default_rng(11)
    n = 64_000
    x = rng.uniform(0, 1000, n).astype(np.float32)
    y = rng.uniform(0, 1000, n).astype(np.float32)
    hot = (x > 750) & (y > 750)
    v = np.where(hot, rng.normal(100, 10, n),
                 rng.normal(0, 0.02, n)).astype(np.float32)
    sk = P.raw(x, y, {"a0": v})
    wsk = (500.0, 500.0, 1000.0, 1000.0)
    m, cid = window_bin_ids_np(x, y, wsk, bx, by)
    truth = np.bincount(cid[m], weights=v[m].astype(np.float64),
                        minlength=nb)
    occ = np.bincount(cid[m], minlength=nb) > 0
    eps_abs = 0.02 * float(np.abs(truth).max())
    deng = P.engine(sk, shape, **cfg)
    heng = P.host_engine(sk, grid0=(8, 8), min_split_count=256,
                         init_metadata_attrs=("a0",))
    for i, pol in enumerate((P.AccuracyPolicy(eps_abs=eps_abs),
                             P.AccuracyPolicy(eps_abs=eps_abs,
                                              salience="center"))):
        phi_b = pol.phi_b(0.05, (bx, by))
        tau = np.maximum(phi_b * np.maximum(np.abs(truth), 1e-9),
                         pol.eps_abs)
        slack = 1e-3 * np.abs(truth) + 0.5
        rd = deng.heatmap(wsk, "a0", bins=(bx, by), phi=0.05, policy=pol)
        assert rd.bin_met is not None and rd.bin_met.all(), pol
        assert (np.abs(rd.values[occ] - truth[occ])
                <= tau[occ] + slack[occ]).all(), pol
        rh = heng.heatmap(wsk, "sum", "a0", bins=(bx, by), phi=0.05,
                          policy=pol)
        assert (np.abs(rh.values[occ] - truth[occ])
                <= tau[occ] + slack[occ]).all(), pol
        record_result(rec, f"phi_b{i}", rd)
    record_state(rec, "state", deng._states["a0"])
    return rec


def minmax_oracle(P, shape=(4, 2)):
    """:262 — min/max heatmaps: CIs contain the oracle, φ = 0 is exact,
    empty bins ±inf."""
    rec = {}
    bx, by = 5, 3
    nb = bx * by
    ds = P.dataset(80_000, 3)
    eng = P.engine(ds, shape, **AQP_CFG)
    wins = P.path(ds, n_queries=3, target_objects=8000)
    n = eng_n(eng)
    xs, ys = xy(ds, n)
    col = column(ds, "a0", n)

    def f32_bin_ids(w):
        # the SPMD step's float32 binning, as XLA compiles it on the CPU
        w32 = np.asarray(w, np.float32)
        m = ((xs >= w32[0]) & (xs <= w32[2])
             & (ys >= w32[1]) & (ys <= w32[3]))
        cw = np.maximum((w32[2] - w32[0]) * np.float32(1 / bx),
                        np.float32(1e-30))
        ch = np.maximum((w32[3] - w32[1]) * np.float32(1 / by),
                        np.float32(1e-30))
        cx = np.clip(np.floor((xs - w32[0]) / cw).astype(np.int64), 0,
                     bx - 1)
        cy = np.clip(np.floor((ys - w32[1]) / ch).astype(np.int64), 0,
                     by - 1)
        return m, cy * bx + cx

    for agg in ("min", "max"):
        fill = np.inf if agg == "min" else -np.inf
        for phi in (0.0, 0.05):
            for i, w in enumerate(wins):
                r = eng.heatmap(w, "a0", bins=(bx, by), phi=phi, agg=agg)
                m, cid = f32_bin_ids(w)
                occ = np.bincount(cid[m], minlength=nb) > 0
                truth = np.full(nb, fill)
                for b in np.flatnonzero(occ):
                    sel = col[m & (cid == b)]
                    truth[b] = sel.min() if agg == "min" else sel.max()
                assert (r.lo[occ] - 1e-4 <= truth[occ]).all()
                assert (truth[occ] <= r.hi[occ] + 1e-4).all()
                assert (r.values[~occ] == fill).all()
                if phi == 0.0:
                    np.testing.assert_array_equal(
                        r.values[occ].astype(np.float32),
                        truth[occ].astype(np.float32))
                else:
                    assert r.bound <= phi + 1e-6 or r.exact
                err = np.abs(r.values[occ] - truth[occ])
                cap = r.bin_bound[occ] * np.maximum(
                    np.abs(r.values[occ]), 1e-9) + 1e-4
                assert (err <= cap).all()
                record_result(rec, f"{agg}{phi}/{i}", r)
    record_state(rec, "state", eng._states["a0"])
    return rec


def refine_invariants(P, shape=(8,)):
    """:343 — splits rewrite the cell ids and append sound child
    metadata: conservation, recount, nesting, bin-aligned snapping."""
    rec = {}
    ds = P.dataset(40_000, 4)
    eng = P.engine(ds, shape, grid=(8, 8), capacity=512,
                   min_split_count=64, epoch_k=8)
    n = eng_n(eng)
    col = column(ds, "a1", n)
    bx = by = 6
    d = host(eng.domain)
    w = (d[0], d[1], d[2], d[3])
    info = eng.refine("a1", window=w, bins=(bx, by))
    assert info["n_split"] == 8, info
    info2 = eng.refine("a1", window=w, bins=(bx, by))
    st = eng._states["a1"]
    active, count = host(st.active), host(st.count)
    cell, bbox = host(st.cell), host(st.bbox)
    vmin, vmax = host(st.vmin), host(st.vmax)
    nt = int(host(st.n_tiles))
    assert nt == 8 * 8 + (info["n_split"] + info2["n_split"]) * 4
    assert count[active].sum() == n
    recount = np.bincount(cell, minlength=len(count))
    np.testing.assert_array_equal(recount[active],
                                  count[active].astype(np.int64))
    assert (recount[~active] == 0).all()
    xs, ys = host(eng.xs), host(eng.ys)
    for t in np.flatnonzero(active)[:64]:
        own = cell == t
        if not own.any():
            continue
        assert col[own].min() >= vmin[t] - 1e-4
        assert col[own].max() <= vmax[t] + 1e-4
        assert (xs[own] >= bbox[t, 0] - 1e-3).all()
        assert (xs[own] <= bbox[t, 2] + 1e-3).all()
        assert (ys[own] >= bbox[t, 1] - 1e-3).all()
        assert (ys[own] <= bbox[t, 3] + 1e-3).all()
    w32 = np.asarray(w, np.float32)
    xlines = (w32[0] + (w32[2] - w32[0]) / np.float32(bx)
              * np.arange(1, bx, dtype=np.float32))
    n_children = nt - 8 * 8
    assert n_children > 0 and n_children % 4 == 0
    checked = 0
    for g in range(n_children // 4):
        rows = 8 * 8 + 4 * g + np.arange(4)
        px0, px1 = bbox[rows, 0].min(), bbox[rows, 2].max()
        cut = bbox[rows[0], 2]
        near_line = np.abs(xlines - cut).min() <= 1e-3
        inside = xlines[(xlines > px0 + 1e-3) & (xlines < px1 - 1e-3)]
        if inside.size:
            assert near_line, (g, cut, inside)
            checked += 1
        else:
            assert near_line or abs(cut - 0.5 * (px0 + px1)) <= 1e-3
    assert checked > 0
    rec["info"] = np.array([info["n_split"], info["objects_reorganized"],
                            info2["n_split"], info2["objects_reorganized"]])
    record_state(rec, "state", st)
    return rec


def chunked_snapshot(P, shape=(8,)):
    """:423 — a ChunkedDataset is held as a snapshot of its live chunks,
    in insertion order; a later retire does not reshard."""
    rec = {}
    cds = P.chunked()
    for x, y, cols in P.streaming(n_chunks=4, rows_per_chunk=16_000,
                                  n_columns=2, domain=1000.0, seed=13):
        cds.ingest(x, y, cols)
    eng = P.engine(cds, shape, **AQP_CFG)
    n = eng_n(eng)
    assert n == (cds.n // 8) * 8
    xs, ys = xy(cds, n)
    col = column(cds, "a0", n)
    wins = [(100.0, 100.0, 420.0, 800.0), (300.0, 50.0, 900.0, 950.0)]
    for phi in (0.0, 0.05):
        for i, w in enumerate(wins):
            r = eng.query(w, "a0", phi)
            truth = col[window_mask_np(xs, ys, w)].sum(dtype=np.float64)
            eps = 1e-5 * abs(truth) + 1e-2
            assert r.lo - eps <= truth <= r.hi + eps, (phi, w)
            if phi > 0.0:
                assert r.bound <= phi + 1e-6 or r.exact
            record_result(rec, f"q{phi}/{i}", r)
    h = eng.heatmap(wins[1], "a0", bins=(4, 4), phi=0.0)
    m, cid = window_bin_ids_np(xs, ys, wins[1], 4, 4)
    truth_b = np.bincount(cid[m], weights=col[m].astype(np.float64),
                          minlength=16)
    occ = np.bincount(cid[m], minlength=16) > 0
    np.testing.assert_allclose(h.values[occ], truth_b[occ], rtol=1e-3,
                               atol=1.0)
    record_result(rec, "h", h)
    cds.retire(0)
    r2 = eng.query(wins[0], "a0", 0.0)
    t0 = col[window_mask_np(xs, ys, wins[0])].sum(dtype=np.float64)
    eps = 1e-5 * abs(t0) + 1e-2
    assert r2.lo - eps <= t0 <= r2.hi + eps
    record_result(rec, "after_retire", r2)
    record_state(rec, "state", eng._states["a0"])
    return rec


SCENARIOS = {f.__name__: f for f in (
    query_oracle, heatmap_oracle, session_repeat, policy_parity,
    minmax_oracle, refine_invariants, chunked_snapshot)}


def run_reference(out_path, names=None, shape=None):
    """Every scenario (or ``names``) on the reference, each on its own
    mesh (or all on ``shape``); the records to ``out_path`` (.npz), keys
    ``<scenario>:<name>``."""
    P = Ref()
    flat = {}
    for name in names or SCENARIOS:
        fn = SCENARIOS[name]
        rec = fn(P) if shape is None else fn(P, shape)
        flat.update({f"{name}:{k}": v for k, v in rec.items()})
    np.savez(out_path, **flat)


# --------------------------------------------------------------------- #
# the torch.distributed rank worker
# --------------------------------------------------------------------- #

GLOO_WINDOWS = [(150.0, 200.0, 600.0, 700.0), (300.0, 250.0, 850.0, 900.0)]


def gloo_session(eng):
    """A small session: scalar queries and a heatmap, φ = 0 and 5 %."""
    rec = {}
    for phi in (0.0, 0.05):
        for i, w in enumerate(GLOO_WINDOWS):
            record_result(rec, f"q{phi}/{i}", eng.query(w, "a0", phi))
            record_result(rec, f"h{phi}/{i}",
                          eng.heatmap(w, "a0", bins=(4, 3), phi=phi))
    st = eng._states["a0"]
    for k in STATE:
        if k != "cell":
            rec[f"state.{k}"] = host(getattr(st, k))
    rec["state.cell"] = host(st.cell)
    return rec


def gloo_rank(rank, world, store, out_path):
    import torch.distributed as tdist
    from repro_torch.core.distributed import DistConfig, DistributedAQPEngine
    from repro_torch.core.mesh import ProcessGroupMesh
    from repro_torch.data import make_synthetic_dataset
    tdist.init_process_group("gloo", init_method=f"file://{store}",
                             world_size=world, rank=rank)
    try:
        ds = make_synthetic_dataset(n=12_002, n_columns=2, seed=9,
                                    device="cpu")
        eng = DistributedAQPEngine(ds, ProcessGroupMesh("cpu"), DistConfig(
            grid=(8, 8), capacity=512, min_split_count=64))
        rec = gloo_session(eng)
        np.savez(f"{out_path}.{rank}.npz", **rec)
    finally:
        tdist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    run_reference(sys.argv[1])
