"""The port's single-analyst benches — B1 ``fig2_exploration``, B2
``objects_read``, B4 ``accuracy_sweep``, B5 ``adaptation_cost`` —
against the reference's, at the smoke size.

- Under ``"np"`` (the reference's ``storage="csv"`` file on the host)
  every counter field of every row equals, as printed, the reference
  bench run here and ``experiments/BENCH_baseline.json``'s row; B1's
  per-query reads equal the reference's.
- Under ``"torch"`` on CPU tensors the counters equal the reference
  bench's over the same arrays (its dataset in ``storage="array"``), and
  B4's error statistics agree to 1e-12 relative.

Counter fields are the derived fields that are not times, speedups,
rates or correlations with time. The helpers here serve
``test_torch_bench_sessions.py`` too.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

import benchmarks.accuracy_sweep as ref_b4
import benchmarks.adaptation_cost as ref_b5
import benchmarks.common as ref_common
import benchmarks.fig2_exploration as ref_b1
import benchmarks.objects_read as ref_b2
from repro.data import make_synthetic_dataset as ref_dataset
from repro_torch.benchmarks import (accuracy_sweep, adaptation_cost, common,
                                    fig2_exploration, objects_read)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# derived fields that are times, speedups, rates or correlations with time
NOT_COUNTERS = {"total_s", "overall_speedup", "speedup_phi5", "speedup_phi1",
                "q15-25_speedup_phi5", "phi1", "peak_early_phi5",
                "exact_vs_phi5_gap", "exact_vs_phi5", "rows_per_s",
                "queries_per_s", "p50_ms", "p99_ms", "corr_time_reads"}
# fields of the port's rows under "torch" that hold float64 values (or
# name the backend) rather than counters
VALUE_FIELDS = {"bit_for_bit", "values_rtol", "median_err", "p99_err",
                "worst_bin_err", "mean_bin_err", "worst_bin_bound"}


def fields(derived):
    return dict(kv.split("=", 1) for kv in derived.split(";"))


def counters(rows, drop=()):
    """name -> counter fields of each emitted row."""
    return {r["name"]: {k: v for k, v in fields(r["derived"]).items()
                        if k not in NOT_COUNTERS and k not in drop}
            for r in rows}


def baseline_counters(prefixes):
    rows = json.loads((ROOT / "experiments" / "BENCH_baseline.json")
                      .read_text())["rows"]
    return counters([r for r in rows if r["name"].startswith(prefixes)])


@pytest.fixture
def smoke(monkeypatch):
    """Both packages' bench sizes at the smoke, with their own dataset
    caches and row lists, restored afterwards."""
    for mod in (common, ref_common):
        for k in ("SMOKE", "N_ROWS", "N_QUERIES", "TARGET_OBJECTS", "SEED"):
            monkeypatch.setattr(mod, k, getattr(mod, k))
        monkeypatch.setattr(mod, "_DS_CACHE", {})
        monkeypatch.setattr(mod, "EMITTED", [])
    monkeypatch.setattr(common, "_HANDED", {})
    common.configure_smoke()
    ref_common.configure_smoke()
    # the reference's B1 bound the query count when it was imported
    monkeypatch.setattr(ref_b1, "N_QUERIES", ref_common.N_QUERIES)
    return common


def on_arrays():
    """Give the reference's benches the bench dataset in
    ``storage="array"``: the arrays the port holds as tensors."""
    ref_common._DS_CACHE[ref_common.SEED] = ref_dataset(
        n=ref_common.N_ROWS, seed=ref_common.SEED)


def run_reference(main, **kw):
    ref_common.EMITTED.clear()
    out = main(**kw)
    return out, list(ref_common.EMITTED)


def run_port(main, backend, **kw):
    common.EMITTED.clear()
    out = main(device="cpu", backend=backend, **kw)
    return out, list(common.EMITTED)


def csv_reads(csv):
    """B1's per-query reads (exact, φ=1%, φ=5%) from its CSV table."""
    rows = [line.split(",") for line in csv.splitlines()[1:]]
    return [tuple(int(v) for v in r[4:]) for r in rows]


PATH_BENCHES = {"B1": (fig2_exploration, ref_b1, "fig2_"),
                "B2": (objects_read, ref_b2, "objects_read_"),
                "B4": (accuracy_sweep, ref_b4, "accuracy_"),
                "B5": (adaptation_cost, ref_b5, "adaptation_")}


@pytest.mark.parametrize("bench", sorted(PATH_BENCHES))
def test_np_counters_equal_reference_and_baseline(smoke, bench):
    port, ref, prefix = PATH_BENCHES[bench]
    out, rows = run_port(port.main, "np")
    ref_out, ref_rows = run_reference(ref.main)
    got = counters(rows)
    assert [r["name"] for r in rows] == [r["name"] for r in ref_rows]
    assert got == counters(ref_rows)
    assert got == baseline_counters(prefix)
    if bench == "B1":
        assert csv_reads(out["csv"]) == csv_reads(ref_out["csv"])
        assert len(csv_reads(out["csv"])) == smoke.N_QUERIES


class _Spy:
    """Stands for ``numpy`` in a module, recording what its ``median``
    and ``quantile`` return."""

    def __init__(self):
        self.got = []

    def __getattr__(self, name):
        return getattr(np, name)

    def median(self, a):
        v = np.median(a)
        self.got.append(float(v))
        return v

    def quantile(self, a, q):
        v = np.quantile(a, q)
        self.got.append(float(v))
        return v


@pytest.mark.parametrize("bench", sorted(PATH_BENCHES))
def test_torch_counters_equal_reference(smoke, bench, monkeypatch):
    port, ref, _ = PATH_BENCHES[bench]
    on_arrays()
    spy = _Spy()
    monkeypatch.setattr(ref_b4, "np", spy)
    out, rows = run_port(port.main, "torch")
    ref_out, ref_rows = run_reference(ref.main)
    got = counters(rows, drop=VALUE_FIELDS)
    assert got == counters(ref_rows, drop=VALUE_FIELDS)
    if bench == "B1":
        assert csv_reads(out["csv"]) == csv_reads(ref_out["csv"])
    if bench == "B4":
        # the error statistics, unrounded: (median, p99) per phi
        mine = [v for r in rows for v in (r["median_err"], r["p99_err"])]
        np.testing.assert_allclose(mine, spy.got, rtol=1e-12, atol=0)
        assert all(r["violations"] == 0 for r in rows)


def test_b5_batched_cuts_read_calls_not_reads(smoke):
    """B5's claim at the smoke size, on the port: the batched arm reads
    the same rows and splits the same tiles as the sequential one, in
    fewer read calls."""
    _, rows = run_port(adaptation_cost.main, "torch")
    got = {r["name"]: r for r in rows}
    for phi in ("exact", "phi1", "phi5"):
        s, b = got[f"adaptation_{phi}_seq"], got[f"adaptation_{phi}_batched"]
        assert s["rows_read"] == b["rows_read"]
        assert s["tiles_split"] == b["tiles_split"]
        assert b["read_calls"] < s["read_calls"]


@pytest.mark.parametrize("phi", [0.0, 0.05])
def test_answer_gate_raises_on_a_wrong_answer(smoke, phi, monkeypatch):
    """``check_answer`` fails a run whose answer leaves the oracle: an
    exact answer off by more than 1e-9, an interval that misses it."""
    eng = common.fresh_engine(device="cpu")
    w = common.workload(eng.dataset, 1)[0]
    r = eng.query(w, "mean", "a0", phi=phi)
    common.check_answer(eng, r, w, "mean", "a0", phi)
    truth = eng.oracle(w, "mean", "a0")
    monkeypatch.setattr(eng, "oracle", lambda *a: truth + 1.0 + abs(r.hi))
    with pytest.raises(AssertionError):
        common.check_answer(eng, r, w, "mean", "a0", phi)


def test_configure_scales_the_query_with_the_rows(monkeypatch):
    for k in ("N_ROWS", "N_QUERIES", "TARGET_OBJECTS", "SEED"):
        monkeypatch.setattr(common, k, getattr(common, k))
    monkeypatch.setattr(common, "_DS_CACHE", {})
    monkeypatch.setattr(common, "_HANDED", {})
    common.configure(100_000_000)
    assert (common.N_ROWS, common.TARGET_OBJECTS, common.N_QUERIES) == (
        100_000_000, 500_000, 50)
    common.configure(4_000_000)
    assert common.TARGET_OBJECTS == 20_000


def test_a_handed_over_dataset_stands_for_every_seed(monkeypatch):
    from repro_torch.data import make_synthetic_dataset
    for k in ("N_ROWS", "TARGET_OBJECTS", "SEED"):
        monkeypatch.setattr(common, k, getattr(common, k))
    monkeypatch.setattr(common, "_DS_CACHE", {})
    monkeypatch.setattr(common, "_HANDED", {})
    common.configure(5_000)
    ds = make_synthetic_dataset(n=5_000, seed=3, device="cpu")
    with pytest.raises(ValueError):
        common.use_dataset(make_synthetic_dataset(n=10, device="cpu"), 3)
    common.use_dataset(ds, 3)
    assert common.SEED == 3
    assert common.dataset(device="cpu") is ds
    assert common.dataset(4, device="cpu", storage="array") is ds
    # the host's dataset is not the handed-over one
    assert common.dataset(device=None).device is None


def test_benches_run_on_the_card_by_default(smoke, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (fig2_exploration.main, objects_read.main,
                 accuracy_sweep.main, adaptation_cost.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main()
