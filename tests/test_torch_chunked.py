"""The port's chunked storage — ``ChunkedDataset``, the lazy
``ChunkIndexSet`` forest and the engine over it — against the reference
package, on every scenario of ``tests/test_chunked.py`` (its fixtures:
``make_streaming_chunks`` 4 x-slabs of 12 000 rows, grid0 (6, 6),
``min_split_count=64``).

Each scenario runs once on the reference and once on the port, with the
reference test's own assertions on each, and records every observation
on the way: each result's fields but the wall time, the ``IOStats`` and
``AdaptStats`` deltas of each query, oracles, ``built_ids`` and each live
chunk's index fingerprint (``forest_to_numpy``).

- Port ``"np"`` ≡ reference, bit for bit: every record.
- Port ``"torch"`` on CPU tensors runs the device code path with the
  plain kernels: every record equal but values, interval ends, bounds,
  oracles and sums, which agree to ``VALUE_RTOL`` (float64 sums in
  another order). Reads, splits, ``perm`` and ``pruned_chunks`` are
  therefore equal.

The host storage modes (``csv``, ``mmap``) run under ``"np"`` only: a
device backend needs the chunks on a device. Also here: the reference's
``ChunkIndexSet.check_invariants`` over a retired forest (ROADMAP C.8)
against the port's, and a cracked reference forest carried into the
port.
"""
import dataclasses
import os

import numpy as np
import pytest

from repro.core import AQPEngine as RefEngine, IndexConfig as RefConfig
from repro.data import ChunkedDataset as RefChunked
from repro.data import make_synthetic_dataset as ref_dataset
from repro.data.rawfile import IOStats as RefIOStats
from repro.data.synthetic import exploration_path as ref_path
from repro.data.synthetic import make_streaming_chunks as ref_chunks
from repro_torch.core import (AQPEngine, ChunkIndexSet, IndexConfig,
                              forest_from_numpy, forest_to_numpy)
from repro_torch.data import (ChunkedDataset, IOStats, exploration_path,
                              make_streaming_chunks, make_synthetic_dataset)

DOMAIN = 1000.0
VALUE_RTOL = 1e-9
# record keys compared to VALUE_RTOL under "torch" (everything inside
# them too); every other key is compared exactly
LOOSE = {"value", "lo", "hi", "bound", "values", "bin_bound", "oracle",
         "meta_sum", "hm_regs"}


class Pkg:
    """One side of a comparison: the reference, or the port on a
    backend ("np": host data; "torch": CPU tensors)."""

    def __init__(self, backend=None):
        self.backend = backend
        self.ref = backend is None
        self.device = None if backend in (None, "np") else "cpu"

    def cfg(self, **kw):
        kw.setdefault("grid0", (6, 6))
        kw.setdefault("min_split_count", 64)
        kw.setdefault("init_metadata_attrs", ("a0",))
        if self.ref:
            return RefConfig(**kw)
        return IndexConfig(backend=self.backend, **kw)

    def engine(self, ds, cfg):
        return (RefEngine if self.ref else AQPEngine)(ds, cfg)

    def chunked(self, storage="array", mmap_dir=None):
        if self.ref:
            return RefChunked(storage=storage, mmap_dir=mmap_dir)
        return ChunkedDataset(storage=storage, mmap_dir=mmap_dir,
                              device=self.device)

    def from_dataset(self, ds):
        return (RefChunked if self.ref else ChunkedDataset).from_dataset(ds)

    def synthetic(self, **kw):
        if self.ref:
            return ref_dataset(**kw)
        return make_synthetic_dataset(device=self.device, **kw)

    def path(self, ds, **kw):
        return (ref_path if self.ref else exploration_path)(ds, **kw)

    def streaming(self, n_chunks=4, rows=12_000, storage="array", seed=3,
                  ingest=None, mmap_dir=None):
        """tests/test_chunked.py:34."""
        mk = ref_chunks if self.ref else make_streaming_chunks
        chunks = mk(n_chunks=n_chunks, rows_per_chunk=rows, n_columns=3,
                    domain=DOMAIN, seed=seed)
        cds = self.chunked(storage, mmap_dir)
        for x, y, cols in chunks[:ingest]:
            cds.ingest(x, y, cols)
        return cds, chunks


class Rec(list):
    """The observations of one run, in order: ``(label, value)``."""

    def result(self, label, r):
        d = dataclasses.asdict(r)
        d.pop("eval_time_s")
        self.append((label, d))

    def step(self, label, eng, fn):
        """Run ``fn()`` (a query of ``eng``) and record its result and
        the engine's I/O and adaptation deltas around it."""
        io, ad = eng.io_stats.snapshot(), eng.adapt_stats.snapshot()
        r = fn()
        self.result(label, r)
        self.append((label + " io", dataclasses.asdict(
            eng.io_stats.delta(io))))
        self.append((label + " adapt", dataclasses.asdict(
            eng.adapt_stats.delta(ad))))
        return r

    def forest(self, label, index):
        self.append((label + " built", tuple(index.built_ids())))
        self.append((label + " forest", {"meta": forest_to_numpy(index)}))


def same(a, b, rtol, what, loose=False):
    """Equal, or within ``rtol`` where ``loose`` (``rtol=0``: exactly)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), what
        for k in a:
            same(a[k], b[k], rtol, f"{what}.{k}", loose or k in LOOSE)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, rtol, f"{what}[{i}]", loose)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if loose and rtol and a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=rtol, atol=0,
                                       err_msg=what)
        else:
            np.testing.assert_array_equal(a, b, err_msg=what)
    elif isinstance(a, float) and isinstance(b, float):
        if loose and rtol and np.isfinite(a):
            assert b == pytest.approx(a, rel=rtol, abs=0), what
        else:
            assert a == b or (np.isnan(a) and np.isnan(b)), (what, a, b)
    else:
        assert a == b, (what, a, b)


# --------------------------------------------------------------------- #
# the scenarios of tests/test_chunked.py, on either package
# --------------------------------------------------------------------- #

def s_pruned_chunks_cost_zero_io(P, rec, tmp):
    cds, _ = P.streaming(ingest=3)
    eng = P.engine(cds, P.cfg())
    w = (20.0, 100.0, 230.0, 700.0)   # strictly inside chunk 0's slab
    r = rec.step("q", eng, lambda: eng.query(w, "mean", "a0", phi=0.0))
    truth = eng.oracle(w, "mean", "a0")
    rec.append(("oracle", {"oracle": truth}))
    np.testing.assert_allclose(r.value, truth, rtol=1e-5, atol=1e-3)
    assert r.pruned_chunks == 2
    assert eng.index.built_ids() == (0,)
    for cid in (1, 2):
        s = cds.chunk(cid).stats
        assert s.rows_read == 0 and s.read_calls == 0 and s.init_rows == 0
        assert s.pruned_calls == 1
    assert cds.chunk(0).stats.init_rows == cds.chunk(0).n
    rec.append(("stats", [dataclasses.asdict(c.stats)
                          for c in cds.chunks()]))
    rec.forest("end", eng.index)


def s_lazy_build_on_first_overlap_only(P, rec, tmp):
    cds, _ = P.streaming(ingest=3)
    eng = P.engine(cds, P.cfg())
    assert eng.index.built_ids() == ()
    assert cds.stats.init_rows == 0
    rec.step("q0", eng, lambda: eng.query((20.0, 0.0, 230.0, DOMAIN),
                                          "sum", "a0", phi=0.05))
    assert eng.index.built_ids() == (0,)
    rec.step("q1", eng, lambda: eng.query((300.0, 0.0, 700.0, DOMAIN),
                                          "sum", "a0", phi=0.05))
    assert set(eng.index.built_ids()) == {0, 1, 2}
    for c in cds.chunks():
        assert c.stats.init_rows == c.n
    rec.append(("stats", dataclasses.asdict(cds.stats)))
    rec.forest("end", eng.index)


def s_heatmap_over_chunks_matches_oracle(P, rec, tmp):
    cds, _ = P.streaming(ingest=4)
    eng = P.engine(cds, P.cfg())
    w = (100.0, 50.0, 900.0, 950.0)   # straddles all four chunks
    r = rec.step("h0", eng, lambda: eng.heatmap(w, "sum", "a0", bins=(4, 4),
                                                phi=0.0))
    truth = eng.heatmap_oracle(w, "sum", "a0", bins=(4, 4))
    rec.append(("oracle", {"oracle": truth}))
    assert r.exact
    fin = np.isfinite(truth)
    np.testing.assert_allclose(r.values[fin], truth[fin], rtol=1e-5,
                               atol=1e-3)
    r2 = rec.step("h1", eng, lambda: eng.heatmap(w, "sum", "a0",
                                                 bins=(4, 4), phi=0.0))
    assert r2.objects_read < r.objects_read
    eng.index.check_invariants("a0")
    rec.forest("end", eng.index)


def s_single_chunk_reproduces_legacy_engine(P, rec, tmp, storage):
    ds_l = P.synthetic(n=40_000, seed=5, storage=storage)
    ds_c = P.synthetic(n=40_000, seed=5, storage=storage)
    legacy = P.engine(ds_l, P.cfg(grid0=(8, 8)))
    chunked = P.engine(P.from_dataset(ds_c), P.cfg(grid0=(8, 8)))
    wins = P.path(ds_l, n_queries=4, target_objects=6000)
    s_fields = ["value", "lo", "hi", "bound", "exact", "tiles_full",
                "tiles_partial", "tiles_processed", "objects_read",
                "read_calls", "batch_rounds", "speculative_rows",
                "pruned_chunks"]
    for i, w in enumerate(wins):
        for agg, phi in (("mean", 0.05), ("sum", 0.0), ("min", 0.1),
                         ("count", 0.0)):
            a = rec.step(f"legacy {i} {agg}", legacy,
                         lambda: legacy.query(w, agg, "a0", phi=phi))
            b = rec.step(f"chunked {i} {agg}", chunked,
                         lambda: chunked.query(w, agg, "a0", phi=phi))
            for f in s_fields:
                assert getattr(a, f) == getattr(b, f), (agg, f)
        ha = rec.step(f"legacy {i} hm", legacy, lambda: legacy.heatmap(
            w, "mean", "a0", bins=(3, 3), phi=0.05))
        hb = rec.step(f"chunked {i} hm", chunked, lambda: chunked.heatmap(
            w, "mean", "a0", bins=(3, 3), phi=0.05))
        assert np.array_equal(ha.values, hb.values)
        assert np.array_equal(ha.lo, hb.lo)
        assert np.array_equal(ha.hi, hb.hi)
        for f in ("bound", "exact", "objects_read", "read_calls",
                  "batch_rounds", "speculative_rows"):
            assert getattr(ha, f) == getattr(hb, f), f
    ti_l, ti_c = legacy.index, chunked.index._indexes[0]
    n = ti_l.n_tiles
    assert ti_c.n_tiles == n
    for k in ("perm", "offset", "count", "active"):
        a, b = np.asarray(getattr(ti_l, k)), np.asarray(getattr(ti_c, k))
        assert np.array_equal(a[:n] if k != "perm" else a,
                              b[:n] if k != "perm" else b), k
    assert np.array_equal(ti_l.meta_sum["a0"][:n], ti_c.meta_sum["a0"][:n])
    for f in dataclasses.fields(ds_l.stats):
        assert getattr(ds_l.stats, f.name) == getattr(ds_c.stats, f.name)
    rec.append(("stats", dataclasses.asdict(ds_c.stats)))
    rec.forest("end", chunked.index)


def s_single_chunk_array(P, rec, tmp):
    s_single_chunk_reproduces_legacy_engine(P, rec, tmp, "array")


def s_single_chunk_csv(P, rec, tmp):
    s_single_chunk_reproduces_legacy_engine(P, rec, tmp, "csv")


def s_chunked_batched_matches_sequential(P, rec, tmp):
    cds_s, _ = P.streaming(ingest=4, seed=11)
    cds_b, _ = P.streaming(ingest=4, seed=11)
    e_seq = P.engine(cds_s, P.cfg())
    e_bat = P.engine(cds_b, P.cfg())
    rng = np.random.default_rng(0)
    for i in range(6):
        x0 = rng.uniform(0, 700.0)
        w = (x0, 100.0, x0 + rng.uniform(100.0, 300.0), 900.0)
        agg = ["sum", "mean", "min", "max"][rng.integers(4)]
        phi = [0.0, 0.05][rng.integers(2)]
        rs = rec.step(f"seq {i}", e_seq, lambda: e_seq.query(
            w, agg, "a0", phi=phi, sequential=True))
        rb = rec.step(f"bat {i}", e_bat, lambda: e_bat.query(
            w, agg, "a0", phi=phi))
        assert rb.tiles_processed == rs.tiles_processed
        assert rb.value == pytest.approx(rs.value, rel=1e-12, abs=1e-9)
        assert rb.lo == pytest.approx(rs.lo, rel=1e-12, abs=1e-9)
        assert rb.hi == pytest.approx(rs.hi, rel=1e-12, abs=1e-9)
        assert rb.bound == pytest.approx(rs.bound, rel=1e-12, abs=1e-12)
    assert e_seq.index.built_ids() == e_bat.index.built_ids()
    for cid in e_seq.index.built_ids():
        ts, tb = e_seq.index._indexes[cid], e_bat.index._indexes[cid]
        n = ts.n_tiles
        assert tb.n_tiles == n
        assert np.array_equal(np.asarray(ts.perm), np.asarray(tb.perm))
        assert np.array_equal(ts.count[:n], tb.count[:n])
        assert np.array_equal(ts.active[:n], tb.active[:n])
    e_seq.index.check_invariants("a0")
    e_bat.index.check_invariants("a0")
    rec.forest("seq", e_seq.index)
    rec.forest("bat", e_bat.index)


def s_ingest_mid_session_extends_answers(P, rec, tmp):
    cds, chunks = P.streaming(ingest=2)
    eng = P.engine(cds, P.cfg())
    w = (100.0, 0.0, 700.0, DOMAIN)
    r1 = rec.step("q0", eng, lambda: eng.query(w, "count", "a0"))
    cds.ingest(*chunks[2])          # slab [500, 750) overlaps w
    r2 = rec.step("q1", eng, lambda: eng.query(w, "count", "a0"))
    assert r2.value > r1.value
    truth = eng.oracle(w, "count", "a0")
    assert r2.value == truth
    assert set(eng.index.built_ids()) == {0, 1, 2}
    rec.forest("end", eng.index)


def s_retire_drops_chunk_and_never_reads_it_again(P, rec, tmp):
    cds, _ = P.streaming(ingest=3)
    eng = P.engine(cds, P.cfg())
    w = (100.0, 0.0, 700.0, DOMAIN)
    rec.step("q0", eng, lambda: eng.query(w, "sum", "a0", phi=0.05))
    before = cds.stats.snapshot()
    retired = cds.chunk(0)
    cds.retire(0)
    assert cds.live_ids == (1, 2)
    delta = cds.stats.delta(before)
    for f in dataclasses.fields(delta):
        assert getattr(delta, f.name) == 0
    with pytest.raises(RuntimeError):
        retired.data.read_values("a0", np.array([0]))
    r = rec.step("q1", eng, lambda: eng.query(w, "sum", "a0", phi=0.0))
    truth = eng.oracle(w, "sum", "a0")
    rec.append(("oracle", {"oracle": truth}))
    np.testing.assert_allclose(r.value, truth, rtol=1e-5, atol=1e-2)
    assert set(eng.index.built_ids()) <= {1, 2}
    with pytest.raises(KeyError):
        cds.retire(0)
    rec.append(("stats", dataclasses.asdict(cds.stats)))
    rec.forest("end", eng.index)


def s_mmap_chunk_lifecycle(P, rec, tmp):
    mdir = os.path.join(tmp, "chunks")
    cds, chunks = P.streaming(ingest=2, rows=6_000, storage="mmap",
                              mmap_dir=mdir)
    eng = P.engine(cds, P.cfg())
    w = (20.0, 0.0, 480.0, DOMAIN)
    r = rec.step("q0", eng, lambda: eng.query(w, "mean", "a0", phi=0.0))
    truth = eng.oracle(w, "mean", "a0")
    np.testing.assert_allclose(r.value, truth, rtol=1e-5, atol=1e-3)
    d0 = os.path.join(mdir, "chunk_00000")
    assert os.path.isdir(d0)
    cds.ingest(*chunks[2])
    cds.retire(0)
    assert not os.path.exists(d0)   # storage reclaimed with the chunk
    w2 = (300.0, 0.0, 700.0, DOMAIN)
    r2 = rec.step("q1", eng, lambda: eng.query(w2, "mean", "a0", phi=0.05))
    t2 = eng.oracle(w2, "mean", "a0")
    assert r2.lo - 1e-3 <= t2 <= r2.hi + 1e-3
    rec.append(("oracle", {"oracle": (truth, t2)}))
    rec.forest("end", eng.index)


def s_iostats_delta_is_field_complete(P, rec, tmp):
    cls = RefIOStats if P.ref else IOStats
    s = cls(rows_read=10, bytes_read=40, read_calls=2, init_rows=5,
            pruned_calls=1)
    before = s.snapshot()
    for f in dataclasses.fields(cls):
        setattr(s, f.name, getattr(s, f.name) + 7)
    d = s.delta(before)
    for f in dataclasses.fields(cls):
        assert getattr(d, f.name) == 7, f.name
    m = s.merge(before)
    for f in dataclasses.fields(cls):
        assert getattr(m, f.name) == (getattr(s, f.name)
                                      + getattr(before, f.name)), f.name
    rec.append(("fields", [f.name for f in dataclasses.fields(cls)]))
    rec.append(("merge", dataclasses.asdict(m)))


def s_rawdataset_domain_cached_at_construction(P, rec, tmp):
    ds = P.synthetic(n=2_000, seed=1)
    d1 = ds.domain()
    assert d1 == (float(ds.x.min()), float(ds.y.min()),
                  float(ds.x.max()), float(ds.y.max()))
    assert ds.domain() is d1
    rec.append(("domain", d1))


def s_session_bin_memory_answers_repeat_heatmap_without_io(P, rec, tmp):
    def engine(**kw):
        ds = P.synthetic(n=10_000, seed=9)
        return P.engine(ds, P.cfg(min_split_count=100_000, **kw))

    w = (200.0, 200.0, 700.0, 700.0)
    eng = engine()
    hm = (lambda e, w: lambda: e.heatmap(w, "mean", "a0", bins=(4, 4),
                                         phi=0.0))
    first = rec.step("first", eng, hm(eng, w))
    second = rec.step("second", eng, hm(eng, w))
    assert first.objects_read > 0
    assert second.objects_read == 0 and second.read_calls == 0
    np.testing.assert_allclose(second.values, first.values, rtol=1e-12)
    np.testing.assert_allclose(second.lo, first.lo, rtol=1e-12)
    moved = rec.step("moved", eng, hm(eng, (210.0, 200.0, 710.0, 700.0)))
    assert moved.objects_read > 0
    eng_off = engine(session_bin_memory=False)
    rec.step("off", eng_off, hm(eng_off, w))
    repeat_off = rec.step("off repeat", eng_off, hm(eng_off, w))
    assert repeat_off.objects_read > 0
    np.testing.assert_allclose(repeat_off.values, second.values,
                               rtol=1e-12)


def s_ingest_mmap_override_without_dir_raises(P, rec, tmp):
    cds, chunks = P.streaming(storage="array", ingest=1)
    x, y, cols = chunks[1]
    with pytest.raises(ValueError, match="mmap_dir"):
        cds.ingest(x, y, cols, storage="mmap")
    assert cds.n_chunks == 1
    cid = cds.ingest(x, y, cols, storage="mmap", mmap_dir=tmp)
    assert cds.chunk(cid).data.storage == "mmap"
    assert cds.n_chunks == 2
    eng = P.engine(cds, P.cfg())
    w = (260.0, 100.0, 480.0, 700.0)    # inside chunk 1's x-slab
    r = rec.step("q", eng, lambda: eng.query(w, "mean", "a0", phi=0.0))
    truth = eng.oracle(w, "mean", "a0")
    np.testing.assert_allclose(r.value, truth, rtol=1e-5, atol=1e-3)
    with pytest.raises(ValueError, match="unknown storage"):
        cds.ingest(x, y, cols, storage="parquet")
    rec.forest("end", eng.index)


def s_bin_memory_lru_survives_viewport_alternation(P, rec, tmp):
    def engine(**kw):
        ds = P.synthetic(n=10_000, seed=9)
        return P.engine(ds, P.cfg(min_split_count=100_000, **kw))

    hm = (lambda e, w: lambda: e.heatmap(w, "mean", "a0", bins=(4, 4),
                                         phi=0.0))
    wa = (200.0, 200.0, 700.0, 700.0)
    wb = (210.0, 200.0, 710.0, 700.0)
    eng = engine()
    first = rec.step("a", eng, hm(eng, wa))
    rec.step("b", eng, hm(eng, wb))
    back = rec.step("a again", eng, hm(eng, wa))
    assert back.objects_read == 0 and back.read_calls == 0
    np.testing.assert_allclose(back.values, first.values, rtol=1e-12)
    slots = eng.index.cfg.bin_memory_slots
    for i in range(slots):
        wi = (200.0 + 10.0 * (i + 2), 200.0, 700.0 + 10.0 * (i + 2), 700.0)
        rec.step(f"w{i}", eng, hm(eng, wi))
    evicted = rec.step("evicted", eng, hm(eng, wa))
    assert evicted.objects_read > 0
    eng1 = engine(bin_memory_slots=1)
    rec.step("1 a", eng1, hm(eng1, wa))
    rec.step("1 b", eng1, hm(eng1, wb))
    back1 = rec.step("1 a again", eng1, hm(eng1, wa))
    assert back1.objects_read > 0
    np.testing.assert_allclose(back1.values, first.values, rtol=1e-12)


def s_value_range_pruning_minmax_exact(P, rec, tmp):
    rng = np.random.default_rng(11)
    cds = P.chunked()
    for lo in (0.0, 100.0, 200.0):
        n = 3000
        x = rng.uniform(0, DOMAIN, n).astype(np.float32)
        y = rng.uniform(0, DOMAIN, n).astype(np.float32)
        cds.ingest(x, y, {"a0": rng.uniform(lo, lo + 50, n).astype(
            np.float32)})
    rec.append(("zone maps", [c.val_range for c in cds.chunks()]))
    eng = P.engine(cds, P.cfg())
    w = (100.0, 100.0, 900.0, 900.0)
    r3 = rec.step("mean", eng, lambda: eng.query(w, "mean", "a0", phi=0.0))
    np.testing.assert_allclose(r3.value, eng.oracle(w, "mean", "a0"),
                               rtol=1e-6)
    assert r3.pruned_chunks == 0
    before = {cid: cds.chunk(cid).stats.snapshot() for cid in (1, 2)}
    r = rec.step("min", eng, lambda: eng.query(w, "min", "a0", phi=0.0))
    assert r.exact and r.value == eng.oracle(w, "min", "a0")
    assert r.pruned_chunks == 2
    for cid in (1, 2):
        d = cds.chunk(cid).stats.delta(before[cid])
        assert d.rows_read == 0 and d.read_calls == 0
        assert d.pruned_calls == 1
    r2 = rec.step("max", eng, lambda: eng.query(w, "max", "a0", phi=0.0))
    assert r2.exact and r2.value == eng.oracle(w, "max", "a0")
    assert r2.pruned_chunks == 2
    rec.forest("end", eng.index)


DEVICE_OK = ["np", "torch"]
HOST_ONLY = ["np"]
SCENARIOS = {
    "pruned_chunks_cost_zero_io": (s_pruned_chunks_cost_zero_io, DEVICE_OK),
    "lazy_build_on_first_overlap_only": (s_lazy_build_on_first_overlap_only,
                                         DEVICE_OK),
    "heatmap_over_chunks_matches_oracle": (
        s_heatmap_over_chunks_matches_oracle, DEVICE_OK),
    "single_chunk_legacy_array": (s_single_chunk_array, DEVICE_OK),
    "single_chunk_legacy_csv": (s_single_chunk_csv, HOST_ONLY),
    "chunked_batched_matches_sequential": (
        s_chunked_batched_matches_sequential, DEVICE_OK),
    "ingest_mid_session_extends_answers": (
        s_ingest_mid_session_extends_answers, DEVICE_OK),
    "retire_drops_chunk_and_never_reads_it_again": (
        s_retire_drops_chunk_and_never_reads_it_again, DEVICE_OK),
    "mmap_chunk_lifecycle": (s_mmap_chunk_lifecycle, HOST_ONLY),
    "iostats_delta_is_field_complete": (s_iostats_delta_is_field_complete,
                                        HOST_ONLY),
    "rawdataset_domain_cached_at_construction": (
        s_rawdataset_domain_cached_at_construction, DEVICE_OK),
    "session_bin_memory_repeat_heatmap_without_io": (
        s_session_bin_memory_answers_repeat_heatmap_without_io, DEVICE_OK),
    "ingest_mmap_override_without_dir_raises": (
        s_ingest_mmap_override_without_dir_raises, HOST_ONLY),
    "bin_memory_lru_survives_viewport_alternation": (
        s_bin_memory_lru_survives_viewport_alternation, DEVICE_OK),
    "value_range_pruning_minmax_exact": (s_value_range_pruning_minmax_exact,
                                         DEVICE_OK),
}
CASES = [(name, b) for name, (_, backends) in SCENARIOS.items()
         for b in backends]


@pytest.mark.parametrize("scenario,backend", CASES,
                         ids=[f"{n}-{b}" for n, b in CASES])
def test_port_matches_reference(scenario, backend, tmp_path):
    fn = SCENARIOS[scenario][0]
    got = []
    for side, pkg in (("ref", Pkg()), ("port", Pkg(backend))):
        rec = Rec()
        d = tmp_path / side
        d.mkdir()
        fn(pkg, rec, str(d))
        got.append(rec)
    ra, rb = got
    assert [lab for lab, _ in ra] == [lab for lab, _ in rb]
    rtol = 0.0 if backend == "np" else VALUE_RTOL
    for (label, a), (_, b) in zip(ra, rb):
        same(a, b, rtol, label)


def test_streaming_chunks_equal_the_reference():
    a = ref_chunks(n_chunks=3, rows_per_chunk=5000, n_columns=4, seed=31)
    b = make_streaming_chunks(n_chunks=3, rows_per_chunk=5000, n_columns=4,
                              seed=31)
    assert len(a) == len(b) == 3
    for (xa, ya, ca), (xb, yb, cb) in zip(a, b):
        for u, v in ((xa, xb), (ya, yb)):
            assert u.dtype == v.dtype == np.float32
            np.testing.assert_array_equal(u, v)
        assert ca.keys() == cb.keys()
        for k in ca:
            np.testing.assert_array_equal(ca[k], cb[k])


def test_zone_map_equals_numpy_with_nan():
    """The zone map of a device chunk is one ``aminmax`` per column and
    gives ``float(np.min(v))`` / ``float(np.max(v))``, a NaN included."""
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 10, 500).astype(np.float32)
    y = rng.uniform(0, 10, 500).astype(np.float32)
    a0 = rng.normal(0, 1, 500).astype(np.float32)
    a1 = a0.copy()
    a1[17] = np.nan
    cols = {"a0": a0, "a1": a1}
    ref = RefChunked()
    ref.ingest(x, y, cols)
    for device in (None, "cpu"):
        cds = ChunkedDataset(device=device)
        cds.ingest(x, y, cols)
        got, want = cds.chunk(0).val_range, ref.chunk(0).val_range
        assert got.keys() == want.keys()
        assert got["a0"] == want["a0"]
        assert all(np.isnan(v) for v in got["a1"] + want["a1"])
        assert all(type(v) is float for r in got.values() for v in r)


def test_retire_releases_device_planes():
    """A retired chunk's columns and axis planes go at retire, and its
    forest (``perm``, ``x_s``, ``y_s``) at the next query's ``prepare``:
    nothing of it stays reachable from the engine."""
    import gc
    import weakref

    cds, _ = Pkg("torch").streaming(ingest=3)
    eng = AQPEngine(cds, Pkg("torch").cfg())
    eng.query((100.0, 0.0, 700.0, DOMAIN), "mean", "a0", phi=0.05)
    ti = eng.index._indexes[0]
    planes = [weakref.ref(t) for t in (ti.perm, ti.x_s, ti.y_s,
                                       cds.chunk(0).data.x)]
    del ti
    cds.retire(0)
    assert eng.index.n_tiles == sum(
        t.n_tiles for c, t in eng.index._indexes.items() if c != 0)
    eng.query((600.0, 0.0, 700.0, DOMAIN), "mean", "a0", phi=0.05)
    gc.collect()
    assert 0 not in eng.index.built_ids()
    assert all(p() is None for p in planes)


# --------------------------------------------------------------------- #
# ROADMAP C.8: the reference checks retired forests
# --------------------------------------------------------------------- #

def lifecycle(P):
    """Three chunks, a query over all of them, then a retire that no
    query follows."""
    cds, _ = P.streaming(ingest=3)
    eng = P.engine(cds, P.cfg())
    eng.query((100.0, 0.0, 700.0, DOMAIN), "mean", "a0", phi=0.05)
    eng.heatmap((100.0, 0.0, 700.0, DOMAIN), "sum", "a0", bins=(4, 4),
                phi=0.05)
    cds.retire(cds.live_ids[0])
    return eng


@pytest.mark.parametrize("backend", ["np", "torch"])
def test_invariants_after_retire_cover_live_forests_only(backend):
    """The reference's ``ChunkIndexSet.check_invariants`` walks every
    built forest, a retired chunk's too, and reads its closed dataset
    (``KeyError: 'a0'``); its ``n_tiles``/``n_active`` count that forest.
    The port's check and counts cover the live chunks' forests only."""
    ref = lifecycle(Pkg())
    with pytest.raises(KeyError, match="a0"):
        ref.index.check_invariants("a0")
    port = lifecycle(Pkg(backend))
    port.index.check_invariants("a0")
    live = [ti for cid, ti in ref.index._indexes.items()
            if ref.dataset.is_live(cid)]
    assert port.index.n_tiles == sum(ti.n_tiles for ti in live)
    assert port.index.n_active == sum(ti.n_active for ti in live)
    assert ref.index.n_tiles > port.index.n_tiles


@pytest.mark.parametrize("backend", ["np", "torch"])
def test_dead_runs_count_no_round(backend):
    """ROADMAP C.9: a round that straddles a chunk whose storage closed
    mid-session reads its live runs only. The reference's forest still
    subtracts a round for each run past the first, so the query's
    ``batch_rounds`` goes negative; the port counts the runs that read,
    and agrees with the reference on everything else."""
    got = []
    for P in (Pkg(), Pkg(backend)):
        cds, _ = P.streaming(ingest=3)
        eng = P.engine(cds, P.cfg())
        w = (100.0, 0.0, 700.0, DOMAIN)
        eng.query(w, "mean", "a0", phi=0.05)
        cds.chunk(0).data.close()
        r = eng.query(w, "sum", "a0", phi=0.0)
        assert r.retired_during_query and r.objects_read > 0
        got.append(dataclasses.asdict(r))
    ra, rb = got
    assert ra.pop("batch_rounds") < 0 < rb.pop("batch_rounds")
    ra.pop("eval_time_s")
    rb.pop("eval_time_s")
    same(ra, rb, 0.0 if backend == "np" else VALUE_RTOL, "result")


# --------------------------------------------------------------------- #
# a cracked forest carried from the reference into the port
# --------------------------------------------------------------------- #

def forest_windows():
    rng = np.random.default_rng(12)
    out = []
    for _ in range(6):
        x0 = rng.uniform(0, 600.0)
        out.append((x0, rng.uniform(0, 300.0), x0 + rng.uniform(150, 380),
                    rng.uniform(600.0, DOMAIN)))
    return out


@pytest.mark.parametrize("backend", ["np", "torch"])
def test_carried_forest_continues(backend):
    """Three queries crack a reference forest over three chunks; the port
    rebuilds it with ``forest_from_numpy``; the next queries, heatmaps
    among them, and a new chunk agree as in the other scenarios."""
    wins = forest_windows()
    ref_p, port_p = Pkg(), Pkg(backend)
    cds_r, chunks = ref_p.streaming(ingest=3, seed=21)
    e_ref = ref_p.engine(cds_r, ref_p.cfg())
    for w in wins[:3]:
        e_ref.query(w, "sum", "a0", phi=0.01)
    cds_p, _ = port_p.streaming(ingest=3, seed=21)
    e_port = port_p.engine(cds_p, port_p.cfg())
    e_port.index = forest_from_numpy(cds_p, e_port.index.cfg,
                                     forest_to_numpy(e_ref.index))
    assert isinstance(e_port.index, ChunkIndexSet)
    assert e_port.index.built_ids() == e_ref.index.built_ids()
    assert cds_p.stats.init_rows == 0       # no I/O accounted
    got = []
    for eng, cds in ((e_ref, cds_r), (e_port, cds_p)):
        rec = Rec()
        for i, w in enumerate(wins[3:]):
            rec.step(f"q{i}", eng, lambda: eng.query(w, "mean", "a0",
                                                     phi=0.01))
            rec.step(f"h{i}", eng, lambda: eng.heatmap(
                w, "sum", "a0", bins=(4, 4), phi=0.0))
        cds.ingest(*chunks[3])
        rec.step("after ingest", eng, lambda: eng.query(
            (500.0, 0.0, 900.0, DOMAIN), "max", "a0", phi=0.0))
        eng.index.check_invariants("a0")
        rec.forest("end", eng.index)
        got.append(rec)
    rtol = 0.0 if backend == "np" else VALUE_RTOL
    for (label, a), (_, b) in zip(*got):
        same(a, b, rtol, label)
