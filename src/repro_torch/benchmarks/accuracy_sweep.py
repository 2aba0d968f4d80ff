"""B4 — error-bound guarantee sweep (port of
``benchmarks/accuracy_sweep.py``): for φ ∈ {1%, 5%, 10%}, every query's
observed relative error must be ≤ the reported bound ≤ φ (or the answer
became exact). Also reports the observed-error distribution — typically
far inside the deterministic bound. ``violations`` must be 0: the port
asserts it, where the reference only reports it."""
from __future__ import annotations

import numpy as np

from .common import emit, fresh_engine, require, workload

PHIS = (0.01, 0.05, 0.10)
N_WINDOWS = 30


def main(device="cuda", backend=None):
    results = {}
    for phi in PHIS:
        eng = fresh_engine(device=device, backend=backend)
        wins = workload(eng.dataset, N_WINDOWS)
        errs, bounds, viol = [], [], 0
        t0 = 0.0
        for w in wins:
            for agg in ("sum", "mean"):
                r = eng.query(w, agg, "a0", phi=phi)
                truth = eng.oracle(w, agg, "a0")
                err = abs(r.value - truth) / max(abs(truth), 1e-12)
                errs.append(err)
                bounds.append(r.bound)
                t0 += r.eval_time_s
                if not (r.exact or r.bound <= phi + 1e-9):
                    viol += 1
                if err > r.bound + 1e-6:
                    viol += 1
        errs = np.array(errs)
        med, p99 = float(np.median(errs)), float(np.quantile(errs, 0.99))
        emit(f"accuracy_phi{int(phi*100)}", t0 * 1e6 / len(errs),
             f"violations={viol};median_err={med:.5f};"
             f"p99_err={p99:.5f};phi={phi}",
             violations=viol, median_err=med, p99_err=p99, phi=phi)
        require(viol == 0, f"B4: {viol} answers violate phi={phi}")
        results[phi] = viol
    return results


if __name__ == "__main__":
    main()
