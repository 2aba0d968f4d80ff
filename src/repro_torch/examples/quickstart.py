"""Quickstart: partial adaptive indexing for approximate query answering
(port of ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

from ..benchmarks.common import resolve
from ..core import AQPEngine, IndexConfig
from ..data import make_synthetic_dataset


def main(n=500_000, device="cuda", backend=None):
    backend, data_device = resolve(device, backend)
    # An in-situ "raw file": n objects, 2 axis attributes + 10 numeric
    # columns. No DBMS loading step — the engine builds a crude tile
    # index in one pass and adapts as you query.
    dataset = make_synthetic_dataset(n=n, seed=42, device=data_device)
    engine = AQPEngine(dataset, IndexConfig(grid0=(16, 16),
                                            init_metadata_attrs=("a0",),
                                            backend=backend))

    window = (200.0, 200.0, 420.0, 420.0)          # a map viewport

    # Exact answering (φ = 0): reads every partially-covered tile.
    exact = engine.query(window, "mean", "a0", phi=0.0)
    print(f"exact   mean(a0) = {exact.value:.4f}   "
          f"objects_read={exact.objects_read}  "
          f"t={exact.eval_time_s*1e3:.1f}ms")

    # Approximate answering with a 5% accuracy constraint: the engine
    # processes only the highest-score tiles until the deterministic
    # error bound meets φ — everything else is answered from tile
    # metadata.
    approx = engine.query(window, "mean", "a0", phi=0.05)
    print(f"approx  mean(a0) = {approx.value:.4f} ± bound "
          f"{approx.bound:.3%} CI=[{approx.lo:.4f},{approx.hi:.4f}]  "
          f"objects_read={approx.objects_read}  "
          f"t={approx.eval_time_s*1e3:.1f}ms")

    truth = engine.oracle(window, "mean", "a0")
    print(f"oracle  mean(a0) = {truth:.4f}  "
          f"(inside CI: {approx.lo <= truth <= approx.hi})")

    # The index adapted along the way: split tiles answer future queries
    # from metadata alone.
    again = engine.query(window, "mean", "a0", phi=0.05)
    print(f"repeat  objects_read={again.objects_read} (index now refined)")
    return {"exact": exact, "approx": approx, "oracle": truth,
            "repeat": again}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the data lives; 'cpu' runs the engine "
                         "under 'torch'")
    main(device=ap.parse_args().device)
