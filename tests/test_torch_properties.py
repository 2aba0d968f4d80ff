"""The port's slice of the randomized differential harness: the
sessions of ``tests/test_properties.py`` at fixed seeds, on both
packages.

Each session draws its operations with the reference harness's own
generators (``random_window``, ``random_policy``, the same rng calls in
the same order) and runs them on

- the reference (batched path),
- the port under ``"np"``, on the batched and on the sequential path,
- the port under ``"torch"`` on CPU tensors (batched path).

Checks:

- port ``"np"`` batched ≡ reference, field for field (every result
  field but the wall time) and index for index at session end;
- port ``"torch"`` holds the parity contract against port ``"np"``:
  every integer field equal, values, interval ends and bounds within
  ``VALUE_RTOL``, the index's ``perm`` and tile table equal;
- P1–P6 on the port: the reference harness's ``_check_scalar`` /
  ``_check_heatmap`` (oracle containment, φ or per-bin budgets,
  batched ≡ sequential, read amortization: ``read_calls <=
  tiles_processed`` and ``read_calls == batch_rounds``) on port
  ``"np"``, index evolution equal across both paths, and
  ``check_invariants`` on every port index;
- on the chunk-lifecycle session, on every port engine: ``read_calls <=
  tiles_processed + pruned_chunks``, the aggregate ``rows_read``
  monotone through queries, ingests and retires, and a retired chunk's
  counters frozen.

The seeds are fixed, with no hypothesis draw: op seeds 0, 1, 2 ×
``array``/``csv`` × uniform and φ_b, and the chunk-lifecycle session at
0, 1, 70, 320048 and 640096 (the last two: seeds the reference harness
drew and failed on). At 640096 the port's batched path inherits the
reference's violation of ``read_calls <= tiles_processed +
pruned_chunks`` (ROADMAP C.1): ``KNOWN_C1`` names that query and its
counts, and the test asserts those counts there, so a fix on either
side shows. Seed 70 retires a chunk that no query follows, where the
reference's ``ChunkIndexSet.check_invariants`` walks the
retired forest (ROADMAP C.8): the harness never calls the reference's
``check_invariants``, ``n_tiles`` or ``n_active`` and compares forests
over live chunks only; a result's ``batch_rounds`` is compared only
where no run of the query was dead (C.9).
"""
import dataclasses

import numpy as np
import pytest

import test_properties as ref_harness
from repro.core import AQPEngine as RefEngine, IndexConfig as RefConfig
from repro.data import ChunkedDataset as RefChunked
from repro.data import make_synthetic_dataset as ref_dataset
from repro.data.synthetic import make_streaming_chunks as ref_chunks
from repro_torch.core import AccuracyPolicy, AQPEngine, IndexConfig
from repro_torch.data import (ChunkedDataset, RawDataset,
                              make_streaming_chunks, make_synthetic_dataset)

N_ROWS = ref_harness.N_ROWS
VALUE_RTOL = 1e-9
# result fields compared to VALUE_RTOL under "torch"
LOOSE = {"value", "lo", "hi", "bound", "values", "bin_bound"}
TABLE = ("offset", "count", "active")

_DS = {}


def dataset(pkg, storage):
    """The harness's dataset (seed 101, 3 columns) for the reference
    (``pkg=None``), port ``"np"`` (host, ``storage``) or port
    ``"torch"`` (CPU tensors of the host dataset's parsed columns)."""
    key = (pkg, storage)
    if key not in _DS:
        kw = dict(n=N_ROWS, n_columns=3, seed=101)
        if pkg is None:
            _DS[key] = ref_dataset(storage=storage, **kw)
        elif pkg == "np":
            _DS[key] = make_synthetic_dataset(storage=storage, device=None,
                                              **kw)
        else:
            src = dataset("np", storage)
            _DS[key] = RawDataset(
                src.x, src.y, {a: src.read_all_unaccounted(a)
                               for a in src.attributes}, device="cpu")
    return _DS[key]


def engine(pkg, ds):
    kw = dict(grid0=(6, 6), min_split_count=64,
              init_metadata_attrs=("a0",))
    if pkg is None:
        return RefEngine(ds, RefConfig(**kw))
    return AQPEngine(ds, IndexConfig(backend=pkg, **kw))


def port_policy(policy):
    if policy is None:
        return None
    return AccuracyPolicy(**{f.name: getattr(policy, f.name)
                             for f in dataclasses.fields(policy)})


def draw_ops(op_seed, ds, with_policies, n_ops=5):
    """``ref_harness.run_session``'s operation stream."""
    rng = np.random.default_rng(op_seed)
    ops = []
    for _ in range(n_ops):
        w = ref_harness.random_window(rng, ds)
        agg = ref_harness.AGGS[rng.integers(len(ref_harness.AGGS))]
        phi = ref_harness.PHIS[rng.integers(len(ref_harness.PHIS))]
        attr = ref_harness.ATTRS[rng.integers(len(ref_harness.ATTRS))]
        if rng.random() < 0.5:
            ops.append(("query", w, agg, attr, phi, None, None))
        else:
            bins = (int(rng.integers(2, 5)), int(rng.integers(2, 5)))
            policy = (ref_harness.random_policy(rng, bins)
                      if with_policies else None)
            ops.append(("heatmap", w, agg, attr, phi, bins, policy))
    return ops


def run(eng, op, port, sequential=False):
    kind, w, agg, attr, phi, bins, policy = op
    if kind == "query":
        return eng.query(w, agg, attr, phi=phi, sequential=sequential)
    return eng.heatmap(w, agg, attr, bins=bins, phi=phi,
                       policy=port_policy(policy) if port else policy,
                       sequential=sequential)


def fields(r):
    d = dataclasses.asdict(r)
    d.pop("eval_time_s")
    return d


def assert_same(a, b, rtol, what):
    """Equal field for field; with ``rtol``, the LOOSE fields within it."""
    assert a.keys() == b.keys(), what
    for k in a:
        x, y = a[k], b[k]
        if rtol and k in LOOSE and x is not None:
            np.testing.assert_allclose(np.asarray(y, np.float64),
                                       np.asarray(x, np.float64),
                                       rtol=rtol, atol=1e-12,
                                       err_msg=f"{what}.{k}")
        elif isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x),
                                          err_msg=f"{what}.{k}")
        else:
            assert x == y, (what, k, x, y)


def host(a):
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def assert_index_equal(ia, ib, attrs, rtol, what):
    """Tile table, ``perm`` and per-attribute metadata (``meta_sum``
    within ``rtol``)."""
    n = ia.n_tiles
    assert ib.n_tiles == n, what
    np.testing.assert_array_equal(host(ib.perm), host(ia.perm),
                                  err_msg=what)
    for k in TABLE:
        np.testing.assert_array_equal(host(getattr(ib, k))[:n],
                                      host(getattr(ia, k))[:n],
                                      err_msg=f"{what}.{k}")
    for a in attrs:
        np.testing.assert_array_equal(host(ib.meta_valid[a])[:n],
                                      host(ia.meta_valid[a])[:n])
        np.testing.assert_allclose(host(ib.meta_sum[a])[:n],
                                   host(ia.meta_sum[a])[:n],
                                   rtol=rtol or 1e-300, atol=0,
                                   err_msg=f"{what}.meta_sum.{a}")


@pytest.mark.parametrize("with_policies", [False, True],
                         ids=["uniform", "phi_b"])
@pytest.mark.parametrize("storage", ["array", "csv"])
@pytest.mark.parametrize("op_seed", [0, 1, 2])
def test_random_session_matches_reference(op_seed, storage, with_policies):
    ops = draw_ops(op_seed, dataset(None, storage), with_policies)
    e_ref = engine(None, dataset(None, storage))
    e_bat = engine("np", dataset("np", storage))
    e_seq = engine("np", dataset("np", storage))
    e_dev = engine("torch", dataset("torch", storage))
    attrs = {"a0"}
    for i, op in enumerate(ops):
        attrs.add(op[3])
        r_ref = run(e_ref, op, port=False)
        rb = run(e_bat, op, port=True)
        rs = run(e_seq, op, port=True, sequential=True)
        rd = run(e_dev, op, port=True)
        assert_same(fields(r_ref), fields(rb), 0.0, f"np op {i}")
        assert_same(fields(rb), fields(rd), VALUE_RTOL, f"torch op {i}")
        kind, w, agg, attr, phi, bins, policy = op
        if kind == "query":
            ref_harness._check_scalar(rs, rb, e_bat.oracle(w, agg, attr),
                                      phi)
        else:
            ref_harness._check_heatmap(
                rs, rb, e_bat.heatmap_oracle(w, agg, attr, bins=bins),
                phi, policy=port_policy(policy))
    assert_index_equal(e_ref.index, e_bat.index, attrs, 0.0, "np index")
    assert_index_equal(e_bat.index, e_seq.index, attrs, 0.0, "sequential")
    assert_index_equal(e_bat.index, e_dev.index, attrs, VALUE_RTOL,
                       "torch index")
    for a in attrs:                                            # P5
        for e in (e_bat, e_seq, e_dev):
            e.index.check_invariants(a)


@pytest.mark.parametrize("pkg", ["np", "torch"])
def test_p6_heatmap_approx_reads_no_more_than_exact(pkg):
    """P6 on the port: a φ > 0 heatmap session on a fresh index reads no
    more objects than the exact session, and the reads equal the
    reference's."""
    storages = ("array", "csv") if pkg == "np" else ("array",)
    for storage in storages:
        rng = np.random.default_rng(7)
        wins = [ref_harness.random_window(rng, dataset(None, storage))
                for _ in range(4)]
        reads = {}
        for who in (None, pkg):
            ds = dataset(who, storage)
            reads[who] = [sum(engine(who, ds).heatmap(
                w, "mean", "a0", bins=(3, 3), phi=phi).objects_read
                for w in wins) for phi in (0.0, 0.1)]
        assert reads[pkg] == reads[None]
        assert reads[pkg][1] <= reads[pkg][0]


# --------------------------------------------------------------------- #
# the chunk-lifecycle session (tests/test_properties.py:270-355)
# --------------------------------------------------------------------- #

def chunk_sources(pkg):
    mk = ref_chunks if pkg is None else make_streaming_chunks
    return mk(n_chunks=5, rows_per_chunk=6_000, n_columns=3,
              domain=1000.0, seed=101)


def chunked(pkg):
    if pkg is None:
        return RefChunked()
    return ChunkedDataset(device=None if pkg == "np" else "cpu")


def chunked_session(pkg, op_seed, sequential=False, n_ops=8):
    """``ref_harness.run_chunked_session``'s operations on one engine;
    returns ``(engine, dataset, records)``: each query's result fields
    and oracle, in order. On the port (``pkg`` not None) it asserts
    after every operation that the aggregate ``rows_read`` did not fall
    and that no retired chunk's counters moved."""
    src = chunk_sources(pkg)
    cds = chunked(pkg)
    for x, y, cols in src[:2]:
        cds.ingest(x, y, cols)
    next_chunk = 2
    eng = engine(pkg, cds)
    rng = np.random.default_rng(op_seed)
    recs = []
    retired, last_rows = [], 0

    def frozen_and_monotone():
        nonlocal last_rows
        if pkg is None:
            return
        assert cds.stats.rows_read >= last_rows
        last_rows = cds.stats.rows_read
        for chunk, snap in retired:
            assert chunk.stats == snap

    for _ in range(n_ops):
        roll = rng.random()
        if roll < 0.2 and next_chunk < len(src):
            cds.ingest(*src[next_chunk])
            next_chunk += 1
            frozen_and_monotone()
            continue
        if roll < 0.35 and cds.n_chunks > 2:
            victim = cds.live_ids[int(rng.integers(cds.n_chunks))]
            retired.append((cds.chunk(victim),
                            cds.chunk(victim).stats.snapshot()))
            cds.retire(victim)
            recs.append(("retire", None, None))
            frozen_and_monotone()
            continue
        w = ref_harness.random_window(rng, cds)
        agg = ref_harness.AGGS[rng.integers(len(ref_harness.AGGS))]
        phi = ref_harness.PHIS[rng.integers(len(ref_harness.PHIS))]
        if rng.random() < 0.6:
            r = eng.query(w, agg, "a0", phi=phi, sequential=sequential)
            truth = eng.oracle(w, agg, "a0")
        else:
            bins = (int(rng.integers(2, 4)), int(rng.integers(2, 4)))
            r = eng.heatmap(w, agg, "a0", bins=bins, phi=phi,
                            sequential=sequential)
            truth = eng.heatmap_oracle(w, agg, "a0", bins=bins)
        recs.append((r, truth, phi))
        frozen_and_monotone()
    return eng, cds, recs


def live_forest(eng, cds):
    return {cid: ti for cid, ti in eng.index._indexes.items()
            if cds.is_live(cid)}


# (op seed, record) -> (read_calls, tiles_processed, pruned_chunks) of
# the reference harness's chunked read bound's known violation on the
# batched path (ROADMAP C.1: a max heatmap reads 6 times for 5 tiles and
# no pruned chunk; the sequential path reads 5); the port "np" equals
# the reference there
KNOWN_C1 = {(640096, 4): (6, 5, 0)}


def check_chunked_reads(op_seed, i, r, batched):
    got = (r.read_calls, r.tiles_processed, r.pruned_chunks)
    if batched and (op_seed, i) in KNOWN_C1:
        assert got == KNOWN_C1[op_seed, i], (op_seed, i, got)
    else:
        assert r.read_calls <= r.tiles_processed + r.pruned_chunks, got


# 70, 320048: C.8's KeyError in the reference harness; 640096: KNOWN_C1
@pytest.mark.parametrize("op_seed", [0, 1, 70, 320048, 640096])
def test_chunk_lifecycle_session_matches_reference(op_seed):
    e_ref, c_ref, rec_ref = chunked_session(None, op_seed)
    e_bat, c_bat, rec_bat = chunked_session("np", op_seed)
    e_seq, c_seq, rec_seq = chunked_session("np", op_seed,
                                            sequential=True)
    e_dev, c_dev, rec_dev = chunked_session("torch", op_seed)
    assert len(rec_ref) == len(rec_bat) == len(rec_seq) == len(rec_dev)
    for i, (a, b, s, d) in enumerate(zip(rec_ref, rec_bat, rec_seq,
                                         rec_dev)):
        if a[0] == "retire":
            assert b[0] == s[0] == d[0] == "retire"
            continue
        (ra, ta, phi), (rb, tb, _), (rs, _, _), (rd, td, _) = a, b, s, d
        fa, fb, fd = fields(ra), fields(rb), fields(rd)
        if ra.retired_during_query:                           # C.9
            for f in (fa, fb, fd):
                f.pop("batch_rounds")
        assert_same(fa, fb, 0.0, f"np op {i}")
        assert_same(fb, fd, VALUE_RTOL, f"torch op {i}")
        np.testing.assert_array_equal(np.asarray(tb), np.asarray(ta))
        np.testing.assert_allclose(np.asarray(td, np.float64),
                                   np.asarray(tb, np.float64),
                                   rtol=VALUE_RTOL, atol=1e-12)
        # P1-P3 and batched ≡ sequential on the port
        assert rb.tiles_processed == rs.tiles_processed
        assert rb.pruned_chunks == rs.pruned_chunks
        for r, batched in ((rb, True), (rs, False), (rd, True)):
            check_chunked_reads(op_seed, i, r, batched)
        np.testing.assert_allclose(rb.values if hasattr(rb, "values")
                                   else rb.value,
                                   rs.values if hasattr(rs, "values")
                                   else rs.value, rtol=1e-12, atol=1e-9)
        assert np.all(np.asarray(rb.lo) - 1e-3 <= np.where(
            np.isfinite(tb), tb, np.asarray(rb.lo)))
        assert np.all(np.where(np.isfinite(tb), tb, np.asarray(rb.hi))
                      <= np.asarray(rb.hi) + 1e-3)
        assert rb.exact or rb.bound <= phi + 1e-9
        if phi == 0.0:
            assert rb.exact
    # the forests of live chunks, chunk for chunk (never the
    # reference's own walk over every built forest: C.8)
    fr, fb = live_forest(e_ref, c_ref), live_forest(e_bat, c_bat)
    fs = live_forest(e_seq, c_seq)
    fd = live_forest(e_dev, c_dev)
    assert fr.keys() == fb.keys() == fs.keys() == fd.keys()
    for cid in fr:
        assert_index_equal(fr[cid], fb[cid], ("a0",), 0.0, f"np {cid}")
        assert_index_equal(fb[cid], fs[cid], ("a0",), 0.0, f"seq {cid}")
        assert_index_equal(fb[cid], fd[cid], ("a0",), VALUE_RTOL,
                           f"torch {cid}")
    for e in (e_bat, e_seq, e_dev):                              # P5
        e.index.check_invariants("a0")
