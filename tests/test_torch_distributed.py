"""The port's SPMD session engine — ``repro_torch.core.distributed`` on
a ``ShardMesh``, ``EpochDriver`` and the budget helpers under
``xp=torch`` — against the reference package.

The AQP cases of ``tests/test_distributed.py`` (``torch_dist_cases.py``
runs each on either package, with the reference test's own assertions)
at those tests' sizes (80 000 rows, a 16×16 grid, capacity 1024):

- the reference on 1 jax device, in this process, against the port's
  1-shard loop;
- the reference on 8 fake jax devices, run once for the module in a
  subprocess (``XLA_FLAGS`` set there only) that writes every scenario's
  record to an ``.npz``, against the port's 8-shard loop.

Held equal: every counter of every result, the session state's ``cell``
plane and tile table. Values (``value``, ``values``, ``lo``, ``hi``)
agree within 1e-5 relative: the reference sums in float32, the port in
float64. Bounds (``bound``, ``bin_bound``) are ratios of float32
differences and agree within 1e-5 relative or absolute.

Within the port: 1 shard ≡ 8 shards (values within 1e-12 relative),
fused ≡ composed bit for bit, deferred epochs ≡ epochs in place, a
reference state carried into the port (and back) gives the next query's
counters and ``cell`` exactly, and ``torch.distributed`` on gloo with 2
ranks equals the 2-shard loop.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dist_cases as cases
from repro_torch.core import (AccuracyPolicy, DistConfig,
                              DistributedAQPEngine, ShardMesh,
                              sharded_state_from_numpy,
                              sharded_state_to_numpy)
from repro_torch.core import bounds as pbounds
from repro_torch.core import distributed as pdist
from repro_torch.core.refine import EpochDriver, EpochStats
from repro_torch.data import make_synthetic_dataset
from repro_torch.kernels import fused_select as pfsel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENARIOS = sorted(cases.SCENARIOS)
VALUES = ("value", "values", "lo", "hi")
BOUNDS = ("bound", "bin_bound")
VALUE_RTOL = 1e-5


def assert_records(want, got, what, value_rtol=VALUE_RTOL):
    """Counters and state equal; values within ``value_rtol``; bounds
    within ``value_rtol`` relative or absolute."""
    assert set(want) == set(got), (what, set(want) ^ set(got))
    for k in sorted(want):
        a, b = np.asarray(want[k]), np.asarray(got[k])
        field = k.rsplit(".", 1)[-1]
        msg = f"{what}: {k}"
        if field in VALUES:
            np.testing.assert_allclose(b.astype(np.float64),
                                       a.astype(np.float64),
                                       rtol=value_rtol, atol=0, err_msg=msg)
        elif field in BOUNDS:
            np.testing.assert_allclose(b.astype(np.float64),
                                       a.astype(np.float64),
                                       rtol=value_rtol, atol=value_rtol,
                                       err_msg=msg)
        else:
            assert a.shape == b.shape, msg
            if a.dtype.kind in "iufb":      # counts may differ in dtype
                a, b = a.astype(np.float64), b.astype(np.float64)
            np.testing.assert_array_equal(b, a, err_msg=msg)


@pytest.fixture(scope="module")
def ref8(tmp_path_factory):
    """The reference's scenarios on 8 fake jax devices, started in a
    subprocess at first use; calling the fixture's value waits for the
    record."""
    out = tmp_path_factory.mktemp("ref8") / "ref8.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")])
    proc = subprocess.Popen([sys.executable, cases.__file__, str(out)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    got = {}

    def record():
        if not got:
            _, err = proc.communicate(timeout=420)
            assert proc.returncode == 0, err[-4000:]
            got.update(np.load(out))
        return got

    yield record
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def scenario_record(rec, name):
    return {k.split(":", 1)[1]: v for k, v in rec.items()
            if k.startswith(name + ":")}


# the 8-device reference starts with the first test, beside these
@pytest.mark.usefixtures("ref8")
@pytest.mark.parametrize("name", SCENARIOS)
def test_one_shard_matches_reference_on_one_device(name):
    want = cases.SCENARIOS[name](cases.Ref(), (1,))
    got = cases.SCENARIOS[name](cases.Port("cpu"), (1,))
    assert_records(want, got, name)


@pytest.mark.parametrize("name", SCENARIOS)
def test_eight_shards_match_reference_on_eight_devices(name, ref8):
    got = cases.SCENARIOS[name](cases.Port("cpu"))
    assert_records(scenario_record(ref8(), name), got, name)


@pytest.mark.parametrize("name", ["query_oracle", "heatmap_oracle",
                                  "minmax_oracle", "policy_parity"])
def test_one_shard_equals_eight_shards(name):
    """The shard loop's reductions change no counter, no ``cell`` and no
    tile; float64 sums agree to 1e-12."""
    one = cases.SCENARIOS[name](cases.Port("cpu"), (1,))
    eight = cases.SCENARIOS[name](cases.Port("cpu"), (8,))
    assert_records(one, eight, name, value_rtol=1e-12)


def test_fused_equals_composed_bit_for_bit():
    """tests/test_distributed.py:577 in the port: every output of the
    scalar and heatmap steps (and the registry) equal, bit for bit, on
    the fresh state and after a refine epoch."""
    bx, by = 4, 3
    nb = bx * by
    mesh = ShardMesh(8, "cpu")
    ds = make_synthetic_dataset(n=64_000, seed=5, device="cpu")
    cfg = DistConfig(grid=(16, 16), capacity=1024, min_split_count=128)
    eng = DistributedAQPEngine(ds, mesh, cfg)
    xs, ys, vals = eng.xs, eng.ys, eng.vals["a0"]
    wins = cases.Port().path(ds, n_queries=2, target_objects=9000)

    def same(a, b, ctx):
        assert sorted(a) == sorted(b), ctx
        for k in a:
            assert torch.equal(a[k], b[k]), f"{ctx}:{k}"

    q_f = pdist.make_session_query_step(mesh, cfg, fused=True)
    q_c = pdist.make_session_query_step(mesh, cfg, fused=False)
    epoch = pdist.make_refine_epoch(mesh, cfg)
    init = pdist.make_init_state(mesh, cfg)
    st = init(xs, ys, vals, eng.domain)
    for i, w in enumerate(wins):
        out_f = q_f(st, xs, ys, vals, w, 0.05)
        same(out_f, q_c(st, xs, ys, vals, w, 0.05), f"query[{i}]")
        st, _ = epoch(st, xs, ys, vals, w, out_f["sel"])
    for agg in ("sum", "min", "max"):
        h_f = pdist.make_session_heatmap_step(mesh, cfg, (bx, by), agg,
                                              fused=True)
        h_c = pdist.make_session_heatmap_step(mesh, cfg, (bx, by), agg,
                                              fused=False)
        for i, state in enumerate((init(xs, ys, vals, eng.domain), st)):
            cache = pdist._empty_cache(cfg.capacity, nb, agg)
            args = (xs, ys, vals, wins[0], 0.05, np.zeros(nb, np.float32),
                    0.0)
            out_f, cache_f = h_f(state, cache, *args)
            out_c, cache_c = h_c(state, cache, *args)
            same(out_f, out_c, f"heatmap[{agg}, {i}]")
            for lf, lc in zip(cache_f, cache_c):
                assert torch.equal(lf, lc)


def ref_state(arrays):
    """A reference ``ShardedTileState`` (1 device) holding ``arrays``."""
    import jax.numpy as jnp
    from repro.core.distributed import ShardedTileState
    dt = {"cell": jnp.int32, "bbox": jnp.float32, "active": bool,
          "level": jnp.int32, "count": jnp.float32, "vmin": jnp.float32,
          "vmax": jnp.float32, "n_tiles": jnp.int32}
    return ShardedTileState(**{k: jnp.asarray(np.asarray(arrays[k]), d)
                               for k, d in dt.items()})


def test_state_carried_across_packages():
    """Three reference queries crack the state; the port continues from
    it, and the 4th query's counters, ``cell`` and table equal the
    reference's. The port's state carried back gives the reference's 5th
    query the port's answer."""
    P, R = cases.Port("cpu"), cases.Ref()
    ds_r, ds_p = R.dataset(80_000, 3), P.dataset(80_000, 3)
    er = R.engine(ds_r, (1,), **cases.AQP_CFG)
    ep = P.engine(ds_p, (1,), **cases.AQP_CFG)
    wins = P.path(ds_p, n_queries=5, target_objects=8000)
    for w in wins[:3]:
        er.query(w, "a0", 0.05)
    ep._states["a0"] = sharded_state_from_numpy(
        sharded_state_to_numpy(er._states["a0"]), "cpu")
    for i, (who, other) in enumerate(((ep, er), (er, ep))):
        rw, ro = who.query(wins[3 + i], "a0", 0.05), \
            other.query(wins[3 + i], "a0", 0.05)
        want, got = {}, {}
        cases.record_result(want, "q", ro)
        cases.record_state(want, "s", other._states["a0"])
        cases.record_result(got, "q", rw)
        cases.record_state(got, "s", who._states["a0"])
        assert_records(want, got, f"query {4 + i}")
        if i == 0:   # carry the port's state back
            er._states["a0"] = ref_state(
                sharded_state_to_numpy(ep._states["a0"]))
    with pytest.raises(ValueError, match="whole numbers"):
        sharded_state_from_numpy(dict(sharded_state_to_numpy(
            ep._states["a0"]), count=np.full(1024, 0.5)), "cpu")


def deferred_session(P, defer):
    ds = P.dataset(80_000, 3)
    eng = P.engine(ds, (1,), **cases.AQP_CFG)
    if defer:
        eng.defer_epochs = True
    wins = P.path(ds, n_queries=3, target_objects=8000)
    out = {}
    for i, w in enumerate(wins[:2]):
        cases.record_result(out, f"h{i}", eng.heatmap(w, "a0", bins=(4, 4),
                                                      phi=0.05))
        if defer:
            rep = eng.publish_epochs()
            out[f"publish{i}"] = np.array(
                [rep["epochs_published"], rep["tiles_split"],
                 rep["cache_rows_invalidated"]])
    cases.record_result(out, "q", eng.query(wins[2], "a0", 0.05))
    if defer:
        out["publish2"] = np.array([eng.publish_epochs()["tiles_split"]])
    cases.record_state(out, "s", eng._states["a0"])
    return out


def test_deferred_epochs_publish_as_in_place():
    """``defer_epochs=True``, then ``publish_epochs()`` after each query,
    leaves the state an epoch in place leaves; the publication reports
    equal the reference's."""
    P = cases.Port("cpu")
    deferred = deferred_session(P, True)
    in_place = deferred_session(P, False)
    assert deferred["publish0"][0] == 1 and deferred["publish0"][1] > 0
    # a staged epoch is applied by the publication, not by the query
    assert deferred["h0.batch_rounds"] == 0 < in_place["h0.batch_rounds"]
    assert_records({k: v for k, v in in_place.items()
                    if not k.endswith("batch_rounds")},
                   {k: v for k, v in deferred.items()
                    if not k.startswith("publish")
                    and not k.endswith("batch_rounds")}, "deferred",
                   value_rtol=0)
    assert_records(deferred_session(cases.Ref(), True), deferred,
                   "deferred vs reference")


def test_gloo_two_ranks_equal_two_shards(tmp_path):
    """``ProcessGroupMesh`` on ``torch.distributed`` (gloo, 2 ranks, one
    shard each) answers as the in-process 2-shard loop: counters, table
    and each rank's ``cell`` shard equal, values within 1e-12."""
    import torch.multiprocessing as mp
    out = str(tmp_path / "rank")
    mp.spawn(cases.gloo_rank, args=(2, str(tmp_path / "store"), out),
             nprocs=2, join=True)
    ds = make_synthetic_dataset(n=12_002, n_columns=2, seed=9, device="cpu")
    eng = DistributedAQPEngine(ds, ShardMesh(2, "cpu"), DistConfig(
        grid=(8, 8), capacity=512, min_split_count=64))
    assert eng.n == 12_002
    want = cases.gloo_session(eng)
    cell = want.pop("state.cell")
    half = len(cell) // 2
    for rank in (0, 1):
        got = dict(np.load(f"{out}.{rank}.npz"))
        np.testing.assert_array_equal(got.pop("state.cell"),
                                      cell[rank * half:(rank + 1) * half])
        assert_records(want, got, f"rank {rank}", value_rtol=1e-12)


def test_mesh_and_truncation():
    """A mesh with no shard raises; the store truncates to a multiple of
    the shard count, as the reference's; fewer objects than shards
    raise; the default mesh wants the card."""
    with pytest.raises(ValueError, match="at least one shard"):
        ShardMesh(0, "cpu")
    ds = make_synthetic_dataset(n=80_003, n_columns=2, seed=3, device="cpu")
    eng = DistributedAQPEngine(ds, ShardMesh(8, "cpu"))
    assert eng.n == 80_000 and len(eng.xs) == 80_000
    assert eng.xs.data_ptr() == ds.x.data_ptr()     # a view, no copy
    assert [len(v[0]) for v in eng.mesh.shards(eng.xs)] == [10_000] * 8
    tiny = make_synthetic_dataset(n=5, n_columns=1, seed=3, device="cpu")
    with pytest.raises(ValueError, match="fewer objects than shards"):
        DistributedAQPEngine(tiny, ShardMesh(8, "cpu"))
    with pytest.raises(ValueError, match="positive"):
        DistConfig(grid=(0, 4))


def test_engine_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardMesh(8)


# --------------------------------------------------------------------- #
# EpochDriver and the budget helpers, against the reference
# --------------------------------------------------------------------- #

# scripted step outputs: (budget_bound, n_processed, n_partial,
# objects_read) per pass at φ > 0, then the φ = 0 pass
SCRIPTS = {
    "met_first": [(0.01, 3, 9, 300)],
    "missed_then_met": [(0.2, 2, 9, 200), (0.04, 4, 9, 100)],
    "never_met": [(0.3, 2, 9, 200), (0.2, 3, 9, 50), (0.15, 4, 9, 40),
                  (0.1, 5, 9, 30)],
    "all_read": [(0.2, 9, 9, 900)],
    "capped": [(0.2, 4, 9, 400)],
    "nothing_read": [(0.2, 0, 0, 0)],
}
EXACT = (0.0, 9, 9, 77)


def run_driver(Driver, script, phi, stateful, splits, max_process):
    calls = []
    outs = iter(script)

    def run_step(p):
        row = EXACT if p == 0.0 else next(outs)
        calls.append(("step", p))
        return dict(zip(("budget_bound", "n_processed", "n_partial",
                         "objects_read"), (np.float32(row[0]),) + tuple(
            np.int64(v) for v in row[1:])))

    def run_epoch(out):
        calls.append(("epoch", int(out["n_processed"])))
        return splits

    out, stats = Driver(run_step, run_epoch, phi, max_epochs=2,
                        max_process=max_process,
                        stateful_steps=stateful).run()
    return ({k: float(v) for k, v in out.items()},
            dataclasses.asdict(stats), calls)


@pytest.mark.parametrize("splits", [0, 4])
@pytest.mark.parametrize("stateful", [True, False])
@pytest.mark.parametrize("phi", [0.0, 0.05])
@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_epoch_driver_matches_reference(script, phi, stateful, splits):
    from repro.core.refine import EpochDriver as RefDriver
    cap = 4 if script == "capped" else 1 << 62
    want = run_driver(RefDriver, SCRIPTS[script], phi, stateful, splits,
                      cap)
    got = run_driver(EpochDriver, SCRIPTS[script], phi, stateful, splits,
                     cap)
    assert got == want
    assert set(got[1]) == {f.name for f in dataclasses.fields(EpochStats)}


def budget_inputs(dtype):
    rng = np.random.default_rng(4)
    n = 64
    phi_b = rng.uniform(0.01, 0.2, n).astype(np.float32)
    phi_b[[3, 17]] = np.inf
    vals = rng.normal(0, 50, n).astype(dtype)
    vals[[5, 9]] = 0.0
    dev = np.abs(rng.normal(0, 2, n)).astype(dtype)
    dev[[2, 11]] = [np.inf, 0.0]
    occ = rng.random(n) < 0.8
    return phi_b, vals, dev, occ


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("eps_abs", [0.0, 0.75])
def test_budget_helpers_torch_equal_numpy_and_reference(dtype, eps_abs):
    """``phi_budgets``, ``budget_ratios`` and ``bin_budgets_met`` with
    ``xp=torch`` (a Python-float ε_abs and a tensor one) equal their
    numpy path and, in float32, the reference's ``xp=jnp``."""
    import jax.numpy as jnp
    from repro.core import bounds as rbounds
    phi_b, vals, dev, occ = budget_inputs(dtype)
    denom = np.maximum(np.abs(vals), dtype(1e-9))
    T = torch.from_numpy
    want_tau = pbounds.phi_budgets(phi_b, denom, eps_abs)
    want_r = pbounds.budget_ratios(dev, want_tau)
    want_met = pbounds.bin_budgets_met(dev, vals, phi_b, eps_abs, occ)
    for eps in (eps_abs, torch.tensor(eps_abs, dtype=torch.float32)):
        tau = pbounds.phi_budgets(T(phi_b), T(denom), eps, xp=torch)
        np.testing.assert_array_equal(tau.numpy(), want_tau)
        np.testing.assert_array_equal(
            pbounds.budget_ratios(T(dev), tau, xp=torch).numpy(), want_r)
        np.testing.assert_array_equal(pbounds.bin_budgets_met(
            T(dev), T(vals), T(phi_b), eps, T(occ), xp=torch).numpy(),
            want_met)
    if dtype is np.float32:
        j = jnp.asarray
        np.testing.assert_array_equal(np.asarray(rbounds.phi_budgets(
            j(phi_b), j(denom), jnp.float32(eps_abs), xp=jnp)), want_tau)
        np.testing.assert_array_equal(np.asarray(rbounds.budget_ratios(
            j(dev), j(want_tau), xp=jnp)), want_r)
        np.testing.assert_array_equal(np.asarray(rbounds.bin_budgets_met(
            j(dev), j(vals), j(phi_b), jnp.float32(eps_abs), j(occ),
            xp=jnp)), want_met)


# --------------------------------------------------------------------- #
# the SPMD primitives, against the reference's jnp expressions
# --------------------------------------------------------------------- #

def primitive_case(seed, n=20_000, cap=64):
    rng = np.random.default_rng(seed)
    xs = rng.uniform(0, 1000, n).astype(np.float32)
    ys = rng.uniform(0, 1000, n).astype(np.float32)
    vals = rng.normal(10, 30, n).astype(np.float32)
    cell = rng.integers(0, cap, n).astype(np.int32)
    w = (float(rng.uniform(0, 400)), float(rng.uniform(0, 400)),
         float(rng.uniform(500, 1000)), float(rng.uniform(500, 1000)))
    return xs, ys, vals, cell, w


@pytest.mark.parametrize("agg", ["sum", "min", "max"])
@pytest.mark.parametrize("bins", [(1, 1), (3, 7), (6, 4)])
def test_fused_count_val_matches_reference(bins, agg):
    """Counts and extrema equal the reference's float32 tables; sums
    agree to float32 accumulation; the bin ids equal the reference's
    ``window_bin_ids`` and its contract-param form."""
    import jax.numpy as jnp
    from repro.kernels import fused_select as rfsel
    from repro.kernels.ref import window_bin_params
    bx, by = bins
    cap = 64
    xs, ys, vals, cell, w = primitive_case(sum(bins))
    T = torch.from_numpy
    want_c, want_v = (np.asarray(a) for a in rfsel.fused_count_val(
        jnp.asarray(cell), jnp.asarray(xs), jnp.asarray(ys),
        jnp.asarray(vals), jnp.asarray(w, jnp.float32), cap, bx * by, bx,
        by, agg))
    got_c, got_v = pfsel.fused_count_val(T(cell), T(xs), T(ys), T(vals), w,
                                         cap, bx * by, bx, by, agg)
    assert got_c.dtype == torch.int64
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    if agg == "sum":
        assert got_v.dtype == torch.float64
        np.testing.assert_allclose(got_v.numpy(), want_v, rtol=1e-5,
                                   atol=1e-2)
    else:
        np.testing.assert_array_equal(got_v.numpy(), want_v)
    m_w, id_w = rfsel.window_bin_ids(jnp.asarray(xs), jnp.asarray(ys),
                                     jnp.asarray(w, jnp.float32), bx, by)
    m_g, id_g = pfsel.window_bin_ids(T(xs), T(ys), w, bx, by)
    np.testing.assert_array_equal(m_g.numpy(), np.asarray(m_w))
    np.testing.assert_array_equal(id_g.numpy(), np.asarray(id_w))
    p = window_bin_params([w], bx, by)
    m_w, id_w = rfsel.window_bin_ids_params(
        jnp.asarray(xs), jnp.asarray(ys),
        jnp.broadcast_to(jnp.asarray(p), (len(xs), 6)), bx, by)
    m_g, id_g = pfsel.window_bin_ids_params(T(xs), T(ys), T(p).expand(
        len(xs), 6), bx, by)
    np.testing.assert_array_equal(m_g.numpy(), np.asarray(m_w))
    np.testing.assert_array_equal(id_g.numpy(), np.asarray(id_w))


@pytest.mark.parametrize("agg", ["sum", "max"])
def test_suffix_scans_match_reference(agg):
    """Reversed running max bit for bit, reversed cumsum to float32
    rounding, the last row exactly 0; the segmented suffix likewise."""
    import jax.numpy as jnp
    from repro.kernels import fused_select as rfsel
    rng = np.random.default_rng(2)
    w = np.abs(rng.normal(0, 5, (300, 6))).astype(np.float32)
    w[200:] = 0.0
    want = np.asarray(rfsel.suffix_residual(jnp.asarray(w), agg))
    got = pfsel.suffix_residual(torch.from_numpy(w), agg).numpy()
    assert got.shape == (301, 6) and (got[200:] == 0).all()
    if agg == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-5)
        qend = np.repeat([100, 250, 300], [100, 150, 50])
        np.testing.assert_allclose(
            pfsel.segmented_suffix(torch.from_numpy(w), qend).numpy(),
            np.asarray(rfsel.segmented_suffix(jnp.asarray(w),
                                              jnp.asarray(qend))),
            rtol=1e-4, atol=1e-3)
    else:
        np.testing.assert_array_equal(got, want)


def test_select_oracles_match_reference():
    """``segment_window_bin_select_ref`` and its multi-window form:
    counts and extrema equal the reference's, sums and suffix widths to
    float32 rounding."""
    import jax.numpy as jnp
    from repro.kernels import fused_select as rfsel
    from repro.kernels.ref import window_bin_params
    xs, ys, vals, _, w = primitive_case(9)
    n_seg, grid = 5, (3, 2)
    rng = np.random.default_rng(1)
    sids = np.sort(rng.integers(-1, n_seg + 1, len(xs)))  # some out of range
    valid = rng.random(len(xs)) < 0.9
    vmin = np.full(n_seg, -40.0, np.float32)
    vmax = np.full(n_seg, 60.0, np.float32)
    T, J = torch.from_numpy, jnp.asarray
    ra, rs = rfsel.segment_window_bin_select_ref(
        J(xs), J(ys), J(vals), J(sids), J(w, jnp.float32), grid, J(valid),
        n_seg, J(vmin), J(vmax))
    ga, gs = pfsel.segment_window_bin_select_ref(
        T(xs), T(ys), T(vals), T(sids), w, grid, T(valid), n_seg, T(vmin),
        T(vmax))
    for ch in (0, 2, 3):
        np.testing.assert_array_equal(ga[..., ch].numpy(),
                                      np.asarray(ra[..., ch]))
    np.testing.assert_allclose(ga[..., 1].numpy(), np.asarray(ra[..., 1]),
                               rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(gs.numpy(), np.asarray(rs), rtol=1e-5,
                               atol=1e-2)
    params = window_bin_params([w, (0.0, 0.0, 700.0, 600.0), w, w, w],
                               *grid)
    qend = np.array([2, 2, 5, 5, 5])
    ra, rs = rfsel.segment_window_bin_select_multi_ref(
        J(xs), J(ys), J(vals), J(sids), J(params), grid, J(valid), n_seg,
        J(vmin), J(vmax), J(qend))
    ga, gs = pfsel.segment_window_bin_select_multi_ref(
        T(xs), T(ys), T(vals), T(sids), T(params), grid, T(valid), n_seg,
        T(vmin), T(vmax), qend)
    for ch in (0, 2, 3):
        np.testing.assert_array_equal(ga[..., ch].numpy(),
                                      np.asarray(ra[..., ch]))
    np.testing.assert_allclose(gs.numpy(), np.asarray(rs), rtol=1e-5,
                               atol=1e-1)


def test_phi_b_engine_meets_budgets_on_port_policy():
    """A floored φ_b heatmap on the port's own ``AccuracyPolicy`` meets
    every per-bin budget (the engine's verdict recomputed here)."""
    ds = make_synthetic_dataset(n=40_000, seed=2, device="cpu")
    eng = DistributedAQPEngine(ds, ShardMesh(4, "cpu"), DistConfig(
        grid=(16, 16), capacity=1024, min_split_count=128))
    w = (200.0, 200.0, 800.0, 700.0)
    r0 = eng.heatmap(w, "a0", bins=(8, 8), phi=0.0)
    pol = AccuracyPolicy(eps_abs=0.02 * float(np.abs(r0.values).max()))
    r = eng.heatmap(w, "a0", bins=(8, 8), phi=0.05, policy=pol)
    assert r.bin_met.all()
    occ = np.isfinite(r.values)
    tau = np.maximum(pol.phi_b(0.05, (8, 8)) * np.abs(r0.values),
                     pol.eps_abs)
    assert (np.abs(r.values - r0.values)[occ] <= tau[occ] + 1e-6).all()
