"""The port's kernels bench (B3) and its bandwidth roofline, on the CPU.

The roofline gives the reference's verdict for the host mirror and
scores the card's backends against H100 HBM3; the bench's ``np`` and
``torch`` rows run here at the smoke size, and its default device, the
card, raises without one.
"""
import json
import math

import pytest
import torch

from repro.launch import roofline as rroof
from repro_torch.benchmarks import common, kernels_bench, run
from repro_torch.launch import roofline


@pytest.mark.parametrize("n_bytes,seconds", [(12e6, 1e-3), (8e6, 3.7e-5),
                                             (1.2e9, 0.0)])
def test_roofline_matches_the_reference_and_scores_the_card(n_bytes,
                                                            seconds):
    got = roofline.aqp_kernel_roofline(n_bytes, seconds, "np")
    want = rroof.aqp_kernel_roofline(n_bytes, seconds, "np")
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == v or (isinstance(v, float) and math.isnan(v)
                               and math.isnan(got[k])), k
    for backend in ("cuda", "torch"):
        r = roofline.aqp_kernel_roofline(n_bytes, seconds, backend)
        assert r["bound_GB_s"] == 3350.0 and r["backend"] == backend
        if seconds:
            assert r["roofline_fraction"] == pytest.approx(
                n_bytes / seconds / 3.35e12, rel=1e-15)


@pytest.fixture
def smoke(monkeypatch):
    monkeypatch.setattr(common, "SMOKE", False)
    monkeypatch.setattr(common, "EMITTED", [])
    common.configure_smoke()
    return common


def test_bench_on_the_cpu_emits_np_and_torch_rows(smoke):
    kernels_bench.main(device="cpu")
    names = [r["name"] for r in smoke.EMITTED]
    assert names == [
        "window_agg_np_200K", "window_agg_torch_200K",
        "bin_agg_torch_200K_2x2", "fused_select_np_200K_4seg_2x2",
        "fused_select_torch_200K_4seg_2x2", "fused_multi_np_200K_4seg_2x2",
        "fused_multi_torch_200K_4seg_2x2"]
    for r in smoke.EMITTED:
        # the recorded numbers, unrounded: a slow CPU row's GB/s prints
        # as "0.00" in the derived field
        assert math.isfinite(r["GB_s"]) and r["GB_s"] > 0
        assert math.isfinite(r["roofline_fraction"])
        assert r["roofline_fraction"] > 0
        d = dict(kv.split("=") for kv in r["derived"].split(";"))
        assert d["device"] == "cpu" and d["bound_GB_s"] == "25"
        assert d["GB_s"] == f"{r['GB_s']:.2f}"
        assert d["roofline_fraction"] == f"{r['roofline_fraction']:.4f}"


def test_bench_runner_writes_its_own_artifact(smoke, tmp_path,
                                              monkeypatch):
    monkeypatch.setattr(kernels_bench, "main",
                        lambda device: common.emit("row", 1.0, "x=1"))
    monkeypatch.setattr(run, "EXPERIMENTS", tmp_path)
    path = run.main(["--smoke", "--device", "cpu"])
    assert path.parent == tmp_path
    assert path.name == "BENCH_torch_smoke.json"
    out = json.loads(path.read_text())
    assert out["device"] == "cpu" and out["rows"][0]["name"] == "row"


def test_bench_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kernels_bench.main()
