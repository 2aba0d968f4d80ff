"""Heatmap queries: φ-constrained binned aggregates over a viewport
(port of ``examples/heatmap.py``).

    PYTHONPATH=src python -m repro_torch.examples.heatmap [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.heatmap --phi-floor 200
    PYTHONPATH=src python -m repro_torch.examples.heatmap --salience center

Exploration frontends render binned views, not scalars: every pan/zoom
asks for a bx×by heatmap of some aggregate over the visible window. The
engine answers those under the same deterministic per-bin error bounds
as scalar queries — each bin gets (value, lo, hi), and refinement stops
as soon as EVERY occupied bin's relative bound is within φ.

``--phi-floor``/``--salience`` attach an AccuracyPolicy: the scalar φ
becomes a per-bin vector φ_b (center-weighted salience loosens the
periphery the eye doesn't fixate) with an absolute-error floor ε_abs
(near-zero bins stop once their CI half-width fits the floor instead of
refining to exactness). The per-bin ACHIEVED error is printed either
way.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..benchmarks.common import resolve
from ..core import AQPEngine, AccuracyPolicy, IndexConfig
from ..data import make_synthetic_dataset

BINS = (6, 6)


def main(n=300_000, phi=0.05, phi_floor=0.0, salience="none",
         device="cuda", backend=None):
    backend, data_device = resolve(device, backend)
    dataset = make_synthetic_dataset(n=n, seed=42, device=data_device)
    engine = AQPEngine(dataset, IndexConfig(grid0=(16, 16),
                                            init_metadata_attrs=("a0",),
                                            backend=backend))

    window = (200.0, 200.0, 420.0, 420.0)          # a map viewport

    policy = None
    if phi_floor > 0 or salience != "none":
        policy = AccuracyPolicy(
            eps_abs=phi_floor,
            salience=None if salience == "none" else salience)

    # Exact per-bin answering (φ = 0).
    exact = engine.heatmap(window, "mean", "a0", bins=BINS, phi=0.0)
    print(f"exact   {BINS[0]}x{BINS[1]} mean(a0) heatmap   "
          f"objects_read={exact.objects_read}  "
          f"read_calls={exact.read_calls}  t={exact.eval_time_s*1e3:.1f}ms")

    # Approximate: every occupied bin within its own budget.
    approx = engine.heatmap(window, "mean", "a0", bins=BINS, phi=phi,
                            policy=policy)
    tag = "uniform" if policy is None else \
        f"phi_b(floor={phi_floor}, salience={salience})"
    print(f"approx  [{tag}]  worst-bin bound {approx.bound:.3%}  "
          f"objects_read={approx.objects_read}  "
          f"t={approx.eval_time_s*1e3:.1f}ms")
    if approx.bin_met is not None:
        print(f"        every bin within its own budget: "
              f"{bool(approx.bin_met.all())}")

    truth = engine.heatmap_oracle(window, "mean", "a0", bins=BINS)
    inside = ((approx.lo - 1e-9 <= truth) & (truth <= approx.hi + 1e-9)
              | ~np.isfinite(truth))
    print(f"oracle inside every per-bin CI: {bool(inside.all())}")

    # Per-bin ACHIEVED error (|value − oracle|), worst and mean over
    # occupied bins — what the stated bounds actually bought.
    fin = np.isfinite(truth)
    err = np.abs(approx.values[fin] - truth[fin])
    print(f"per-bin achieved |error|: worst={err.max():.4f} "
          f"mean={err.mean():.4f}  (reported worst bound "
          f"{approx.bound:.3%} of value)")

    print("\nper-bin mean(a0) ± relative bound (row-major y, northwest "
          "last):")
    vals, bnds = approx.grid(), approx.grid(approx.bin_bound)
    for row in range(BINS[1] - 1, -1, -1):
        print("  ".join(f"{vals[row, c]:7.2f}±{bnds[row, c]:5.1%}"
                        for c in range(BINS[0])))

    # The index adapted: once tiles nest inside single bins, repeats are
    # answered from metadata alone.
    again = engine.heatmap(window, "mean", "a0", bins=BINS, phi=phi,
                           policy=policy)
    print(f"\nrepeat  objects_read={again.objects_read} "
          f"(index now refined)")
    return {"exact": exact, "approx": approx, "oracle": truth,
            "repeat": again}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="where the data lives; 'cpu' runs the engine "
                         "under 'torch'")
    ap.add_argument("--phi", type=float, default=0.05,
                    help="relative per-bin accuracy constraint")
    ap.add_argument("--phi-floor", type=float, default=0.0,
                    help="absolute-error floor eps_abs (per-bin budget "
                         "max(phi_b*|value|, eps_abs))")
    ap.add_argument("--salience", choices=["none", "center"],
                    default="none",
                    help="per-bin salience: 'center' keeps phi at the "
                         "viewport center and relaxes the periphery")
    a = ap.parse_args()
    main(phi=a.phi, phi_floor=a.phi_floor, salience=a.salience,
         device=a.device)
