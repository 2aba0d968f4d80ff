"""The port's session benches — B6 ``heatmap_exploration``, B7
``serving_concurrency``, B8 ``streaming_exploration`` — and its
``compare`` gate against the reference's, at the smoke size.

- Under ``"np"`` every counter field equals, as printed, the reference
  bench run here and ``experiments/BENCH_baseline.json``'s row (B6 with
  its distributed arm, the SPMD session engine on one shard).
- Under ``"torch"`` on CPU tensors the counters equal the reference
  bench's over the same arrays, and the gates hold.
- B6's sequential replay, the port's one added gate, fails when the two
  paths' answers differ.
"""
import json

import numpy as np
import pytest
import torch

import benchmarks.compare as ref_compare
import benchmarks.heatmap_exploration as ref_b6
import benchmarks.serving_concurrency as ref_b7
import benchmarks.streaming_exploration as ref_b8
from repro.data.rawfile import RawDataset as RefRawDataset
from repro_torch.benchmarks import (compare, heatmap_exploration,
                                    serving_concurrency,
                                    streaming_exploration)
from test_torch_bench_paths import (VALUE_FIELDS, baseline_counters,
                                    counters, on_arrays, run_port,
                                    run_reference, smoke)  # noqa: F401

SESSION_BENCHES = {
    "B6": (heatmap_exploration, ref_b6, ("heatmap_exact", "heatmap_phi",
                                         "heatmap_speedup",
                                         "heatmap_distributed")),
    "B7": (serving_concurrency, ref_b7, ("serving_",)),
    "B8": (streaming_exploration, ref_b8, ("streaming_",))}
# rows the port adds (B6's sequential replay)
PORT_ONLY = {"heatmap_batched_eq_sequential"}


@pytest.mark.parametrize("bench", sorted(SESSION_BENCHES))
def test_np_counters_equal_reference_and_baseline(smoke, bench):
    port, ref, prefixes = SESSION_BENCHES[bench]
    _, rows = run_port(port.main, "np")
    _, ref_rows = run_reference(ref.main)
    got = counters([r for r in rows if r["name"] not in PORT_ONLY])
    assert got == counters(ref_rows)
    assert got == baseline_counters(prefixes)
    if bench == "B6":
        assert counters(rows)["heatmap_batched_eq_sequential"] == {
            "queries": "5", "equal": "True", "bit_for_bit": "True"}


@pytest.mark.parametrize("bench", sorted(SESSION_BENCHES))
def test_torch_counters_equal_reference(smoke, bench, monkeypatch):
    port, ref, _ = SESSION_BENCHES[bench]
    on_arrays()
    # B6's skewed set as arrays, not the reference's csv file
    monkeypatch.setattr(ref_b6, "RawDataset",
                        lambda x, y, cols, storage: RefRawDataset(x, y, cols))
    _, rows = run_port(port.main, "torch")
    _, ref_rows = run_reference(ref.main)
    got = counters([r for r in rows if r["name"] not in PORT_ONLY],
                   drop=VALUE_FIELDS)
    assert got == counters(ref_rows, drop=VALUE_FIELDS)
    by_name = {r["name"]: r for r in rows}
    if bench == "B6":
        assert all(r["speculative_rows"] == 0 for r in rows
                   if "speculative_rows" in r)
        assert by_name["heatmap_phi_b_floored"]["queries_unmet"] == 0
        assert by_name["heatmap_batched_eq_sequential"]["equal"]
    if bench == "B7":
        assert by_name["serving_batched_eq_sequential"]["equal"]
    if bench == "B8":
        assert by_name["streaming_chunked"]["violations"] == 0
        assert by_name["streaming_chunked"]["prune_leaks"] == 0
        assert by_name["streaming_single_chunk_parity"]["equal"]


@pytest.mark.parametrize("backend", ["np", "torch"])
def test_b6_sequential_replay_catches_a_divergence(smoke, backend,
                                                   monkeypatch):
    """The replay gate fails when the sequential path's answers differ
    from the batched path's."""
    assert heatmap_exploration.sequential_parity("cpu", backend)
    real = heatmap_exploration.run_session

    def skewed(phi, *a, sequential=False, **kw):
        eng, tot = real(phi, *a, sequential=sequential, **kw)
        if sequential:
            r = eng.trace.results[-1]
            r.values = np.where(np.isfinite(r.values), r.values + 1.0,
                                r.values)
        return eng, tot
    monkeypatch.setattr(heatmap_exploration, "run_session", skewed)
    with pytest.raises(AssertionError, match="sequential heatmap path"):
        heatmap_exploration.sequential_parity("cpu", backend)


def test_b8_chunks_are_made_once_for_a_size(smoke):
    a = streaming_exploration.chunks(4_000)
    assert streaming_exploration.chunks(4_000) is a
    assert len(a) == streaming_exploration.N_CHUNKS
    assert len(streaming_exploration.chunks(4_001)[0][0]) == 4_001


def test_session_benches_run_on_the_card_by_default(smoke, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (heatmap_exploration.main, serving_concurrency.main,
                 streaming_exploration.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main()


def _artifact(path, rows):
    path.write_text(json.dumps({"rows": [
        {"name": n, "us_per_call": 0.0, "derived": d} for n, d in rows]}))
    return str(path)


@pytest.mark.parametrize("current,rc", [
    ((12.0, 900.0), 0),        # both rows better
    ((7.5, 1000.0), 0),        # GB_s down 25 %: inside the tolerance
    ((6.0, 1000.0), 1),        # GB_s down 40 %
    ((10.0, 600.0), 1)],       # rows_per_s down 40 %
    ids=["better", "within", "gb_s_regressed", "rows_per_s_regressed"])
def test_compare_gates_as_the_reference(tmp_path, capsys, current, rc):
    """The port's gate and the reference's give the same verdict and
    lines on the same artifacts: a row in both files that dropped more
    than 30 % fails; rows in one file only never do."""
    base = _artifact(tmp_path / "base.json", [
        ("window_agg_cuda_1M", "GB_s=10.0;roofline_fraction=0.1"),
        ("serving_n16", "sessions=16;rows_per_s=1000"),
        ("gone", "GB_s=5.0")])
    cur = _artifact(tmp_path / "cur.json", [
        ("window_agg_cuda_1M", f"GB_s={current[0]};roofline_fraction=0.1"),
        ("serving_n16", f"sessions=16;rows_per_s={current[1]}"),
        ("new_row", "GB_s=1.0")])
    assert compare.compare(base, cur) == rc
    mine = capsys.readouterr().out
    assert ref_compare.compare(base, cur) == rc
    assert mine == capsys.readouterr().out
    assert "# gone [GB_s]: only in baseline (skipped)" in mine
    assert "# new_row: new row" in mine
