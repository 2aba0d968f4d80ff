"""Carrying a cracked index from the reference package to the port.

Three queries crack a reference engine's index; ``index_from_numpy``
rebuilds it in the port from its numpy arrays. The next queries must
agree bit for bit under the port's ``"np"`` backend (answers, I/O and
adaptation deltas, and the final index), and under ``"torch"`` must read
and split the same (answers to float64 summation-order tolerance).
"""
import dataclasses

import numpy as np
import pytest

from repro.core import AQPEngine as RefEngine, IndexConfig as RefConfig
from repro.data import make_synthetic_dataset as ref_dataset
from repro.data.synthetic import exploration_path as ref_path
from repro_torch.core import (AQPEngine, IndexConfig, index_from_numpy,
                              index_to_numpy)
from repro_torch.data import make_synthetic_dataset

KW = dict(grid0=(8, 8), min_split_count=64, init_metadata_attrs=("a0",))


def carried(agg, backend):
    e_ref = RefEngine(ref_dataset(n=60_000, seed=5), RefConfig(**KW))
    wins = ref_path(e_ref.dataset, n_queries=6, target_objects=4000)
    for w in wins[:3]:
        e_ref.query(w, agg, "a0", phi=0.01)
    ds = make_synthetic_dataset(n=60_000, seed=5, device="cpu")
    cfg = IndexConfig(backend=backend, **KW)
    e_port = AQPEngine(ds, cfg)
    e_port.index = index_from_numpy(ds, cfg, index_to_numpy(e_ref.index))
    return e_ref, e_port, wins[3:]


def step(e, w, agg):
    io, ad = e.io_stats.snapshot(), e.adapt_stats.snapshot()
    r = e.query(w, agg, "a0", phi=0.01)
    return (r, dataclasses.asdict(e.io_stats.delta(io)),
            dataclasses.asdict(e.adapt_stats.delta(ad)))


@pytest.mark.parametrize("agg", ["count", "sum", "mean", "min", "max"])
def test_carried_index_continues_bitwise(agg):
    e_ref, e_port, wins = carried(agg, "np")
    for w in wins:
        ra, ia, aa = step(e_ref, w, agg)
        rb, ib, ab = step(e_port, w, agg)
        da, db = dataclasses.asdict(ra), dataclasses.asdict(rb)
        da.pop("eval_time_s")
        db.pop("eval_time_s")
        assert da == db
        assert (ia, aa) == (ib, ab)
    a, b = index_to_numpy(e_ref.index), index_to_numpy(e_port.index)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            assert a[k].keys() == b[k].keys()
            for attr in a[k]:
                np.testing.assert_array_equal(a[k][attr], b[k][attr])
        else:
            np.testing.assert_array_equal(a[k], b[k])
    e_port.index.check_invariants("a0")


@pytest.mark.parametrize("agg", ["sum", "mean", "max"])
def test_carried_index_continues_on_torch(agg):
    e_ref, e_port, wins = carried(agg, "torch")
    for w in wins:
        ra, ia, aa = step(e_ref, w, agg)
        rb, ib, ab = step(e_port, w, agg)
        assert rb.value == pytest.approx(ra.value, rel=1e-9, abs=1e-9)
        assert (rb.tiles_processed, ia, aa) == (ra.tiles_processed, ib, ab)
    np.testing.assert_array_equal(e_port.index.perm.numpy(),
                                  e_ref.index.perm)
    e_port.index.check_invariants("a0")


def test_carried_state_is_validated():
    e_ref, _, _ = carried("sum", "np")
    arrays = index_to_numpy(e_ref.index)
    arrays["perm"] = arrays["perm"][:-1]
    ds = make_synthetic_dataset(n=60_000, seed=5, device="cpu")
    with pytest.raises(ValueError):
        index_from_numpy(ds, IndexConfig(backend="np", **KW), arrays)


def heatmap_carried(backend):
    """A reference index cracked by three heatmaps (bin-aligned children,
    warm bin-grid registries), carried into the port."""
    e_ref = RefEngine(ref_dataset(n=40_000, seed=23), RefConfig(**KW))
    wins = ref_path(e_ref.dataset, n_queries=5, target_objects=6000)
    for w in wins[:3]:
        e_ref.heatmap(w, "sum", "a0", bins=(4, 4), phi=0.0)
    ds = make_synthetic_dataset(n=40_000, seed=23, device="cpu")
    cfg = IndexConfig(backend=backend, **KW)
    e_port = AQPEngine(ds, cfg)
    e_port.index = index_from_numpy(ds, cfg, index_to_numpy(e_ref.index))
    # the next two heatmaps: the last cracked viewport again (its
    # enriched tiles answered from the carried registry) and a new one
    return e_ref, e_port, [wins[2], wins[3]]


@pytest.mark.parametrize("backend", ["np", "torch"])
def test_carried_heatmap_index_continues(backend):
    e_ref, e_port, wins = heatmap_carried(backend)
    carried_arrays = index_to_numpy(e_ref.index)
    regs = index_to_numpy(e_port.index)["hm_regs"]
    assert [k for k, _ in regs] == [
        k for k, _ in index_to_numpy(e_ref.index)["hm_regs"]]
    assert e_port.index._hm_key == e_ref.index._hm_key
    reads = []
    for w in wins:
        steps = []
        for e in (e_ref, e_port):
            io, ad = e.io_stats.snapshot(), e.adapt_stats.snapshot()
            r = e.heatmap(w, "sum", "a0", bins=(4, 4), phi=0.0)
            steps.append((r, dataclasses.asdict(e.io_stats.delta(io)),
                          dataclasses.asdict(e.adapt_stats.delta(ad))))
        (ra, ia, aa), (rb, ib, ab) = steps
        assert (ia, aa) == (ib, ab)
        da, db = dataclasses.asdict(ra), dataclasses.asdict(rb)
        for k in da:
            if k == "eval_time_s":
                continue
            if backend == "torch" and k in ("values", "lo", "hi"):
                np.testing.assert_allclose(db[k], da[k], rtol=1e-9)
            elif isinstance(da[k], np.ndarray):
                np.testing.assert_array_equal(da[k], db[k])
            else:
                assert da[k] == db[k], k
        reads.append(rb.objects_read)
    # the carried registries answered: the same index carried without
    # them reads more on the repeat
    cfg = IndexConfig(backend=backend, **KW)
    ds = make_synthetic_dataset(n=40_000, seed=23, device="cpu")
    cold = AQPEngine(ds, cfg)
    cold.index = index_from_numpy(ds, cfg, dict(carried_arrays, hm_regs=[]))
    assert cold.heatmap(wins[0], "sum", "a0", bins=(4, 4),
                        phi=0.0).objects_read > reads[0]
    a, b = index_to_numpy(e_ref.index), index_to_numpy(e_port.index)
    for k in ("n_tiles", "perm", "count", "bbox", "active", "parent"):
        np.testing.assert_array_equal(a[k], b[k])
    for k in ("meta_min", "meta_max", "meta_valid"):
        np.testing.assert_array_equal(a[k]["a0"], b[k]["a0"])
    if backend == "np":
        np.testing.assert_array_equal(a["meta_sum"]["a0"],
                                      b["meta_sum"]["a0"])
    e_port.index.check_invariants("a0")
