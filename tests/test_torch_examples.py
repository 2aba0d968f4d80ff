"""The port's examples (``repro_torch/examples``) on the CPU.

Each runs at a small ``n`` under ``"np"`` (host data) and ``"torch"``
(CPU tensors): its answers lie within the bounds it prints around the
engine's float64 oracle, exact answers equal it. The quickstart under
``"np"`` answers as the reference's script does on the same data, bit
for bit, and its command line runs. Without a card the examples raise.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import AQPEngine as RefEngine
from repro.core import IndexConfig as RefConfig
from repro.data import make_synthetic_dataset as ref_dataset
from repro_torch.examples import (exploration_session, heatmap, quickstart,
                                  serve_approx)

ROOT = pathlib.Path(__file__).resolve().parents[1]
BACKENDS = ["np", "torch"]


def contains(r, truth, tol=1e-9):
    t = tol * max(abs(truth), 1.0)
    return r.lo - t <= truth <= r.hi + t


@pytest.mark.parametrize("backend", BACKENDS)
def test_quickstart(backend, capsys):
    out = quickstart.main(n=40_000, device="cpu", backend=backend)
    truth = out["oracle"]
    assert out["exact"].exact
    assert abs(out["exact"].value - truth) <= 1e-9 * abs(truth)
    assert out["approx"].bound <= 0.05 and contains(out["approx"], truth)
    assert out["repeat"].objects_read <= out["approx"].objects_read
    assert "(inside CI: True)" in capsys.readouterr().out


def test_quickstart_np_equals_reference_script():
    """The reference script's steps on the same data (its defaults: host
    arrays, the ``"np"`` control plane) give the port's answers."""
    n = 40_000
    port = quickstart.main(n=n, device="cpu", backend="np")
    engine = RefEngine(ref_dataset(n=n, seed=42),
                       RefConfig(grid0=(16, 16), init_metadata_attrs=("a0",)))
    window = (200.0, 200.0, 420.0, 420.0)
    ref = {"exact": engine.query(window, "mean", "a0", phi=0.0),
           "approx": engine.query(window, "mean", "a0", phi=0.05),
           "oracle": engine.oracle(window, "mean", "a0")}
    ref["repeat"] = engine.query(window, "mean", "a0", phi=0.05)
    assert port["oracle"] == ref["oracle"]
    for k in ("exact", "approx", "repeat"):
        for f in ("value", "lo", "hi", "bound", "exact", "objects_read",
                  "read_calls", "tiles_processed"):
            assert getattr(port[k], f) == getattr(ref[k], f), (k, f)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("policy", ["uniform", "floor_salience"])
def test_heatmap(backend, policy, capsys):
    kw = {} if policy == "uniform" else {"phi_floor": 0.5,
                                         "salience": "center"}
    out = heatmap.main(n=40_000, device="cpu", backend=backend, **kw)
    truth, approx, exact = out["oracle"], out["approx"], out["exact"]
    fin = np.isfinite(truth)
    np.testing.assert_allclose(exact.values[fin], truth[fin], rtol=1e-9)
    assert ((approx.lo[fin] - 1e-9 <= truth[fin])
            & (truth[fin] <= approx.hi[fin] + 1e-9)).all()
    if policy == "uniform":
        assert approx.bound <= 0.05
    else:
        assert approx.bin_met.all()
    assert "oracle inside every per-bin CI: True" in capsys.readouterr().out


@pytest.mark.parametrize("backend", BACKENDS)
def test_serve_approx(backend, capsys):
    out = serve_approx.main(n=30_000, device="cpu", backend=backend)
    assert len(out["served"]) == 2 * serve_approx.N_SESSIONS \
        * serve_approx.N_TICKS
    for r, truth in zip(out["served"], out["oracle"]):
        assert r.exact or r.bound <= serve_approx.PHI + 1e-9
        assert contains(r, truth)
    printed = capsys.readouterr().out
    assert "inside_CI=True" in printed and "epochs published: 20" in printed


@pytest.mark.parametrize("backend", BACKENDS)
def test_exploration_session(backend, capsys):
    out = exploration_session.main(n=20_000, device="cpu", backend=backend)
    assert len(out["exact"]) == exploration_session.N_QUERIES
    for e, a, truth in zip(out["exact"], out["phi5"], out["oracle"]):
        assert e.exact and abs(e.value - truth) <= 1e-9 * abs(truth)
        assert (a.exact or a.bound <= 0.05) and contains(a, truth)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split() == ["query", "exact_ms", "phi5_ms",
                                "exact_reads", "phi5_reads"]
    assert lines[-1].startswith("totals: exact")


def test_examples_run_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (quickstart.main, heatmap.main, serve_approx.main,
                 exploration_session.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(n=1_000)


def test_quickstart_command_line():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.quickstart",
         "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr
    assert "(inside CI: True)" in p.stdout
