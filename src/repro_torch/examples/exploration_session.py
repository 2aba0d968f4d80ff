"""A full visual-exploration session (the paper's Fig. 2 scenario): 50
overlapping window queries under different accuracy constraints, with
per-query latency/IO traces (port of ``examples/exploration_session.py``).

    PYTHONPATH=src python -m repro_torch.examples.exploration_session \
        [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from ..benchmarks.common import resolve
from ..core import AQPEngine, IndexConfig
from ..data import make_synthetic_dataset
from ..data.synthetic import exploration_path

N_QUERIES = 50


def session(phi: float, n: int, device, backend):
    """One session on a fresh engine; per query (time, reads, result,
    oracle)."""
    ds = make_synthetic_dataset(n=n, seed=7, device=device)
    eng = AQPEngine(ds, IndexConfig(grid0=(16, 16), min_split_count=256,
                                    init_metadata_attrs=("a0",),
                                    backend=backend))
    wins = exploration_path(ds, n_queries=N_QUERIES,
                            target_objects=n // 100, seed=11)
    times, reads, results, truths = [], [], [], []
    for w in wins:
        r = eng.query(w, "mean", "a0", phi=phi)
        times.append(r.eval_time_s)
        reads.append(r.objects_read)
        results.append(r)
        truths.append(eng.oracle(w, "mean", "a0"))
    return np.array(times), np.array(reads), results, truths


def main(n=1_000_000, device="cuda", backend=None):
    backend, data_device = resolve(device, backend)
    t_exact, r_exact, res_exact, truths = session(0.0, n, data_device,
                                                  backend)
    t_05, r_05, res_05, _ = session(0.05, n, data_device, backend)

    print("query  exact_ms  phi5_ms   exact_reads  phi5_reads")
    for i in range(0, N_QUERIES, 5):
        print(f"{i:5d}  {t_exact[i]*1e3:8.2f}  {t_05[i]*1e3:7.2f}"
              f"   {r_exact[i]:11d}  {r_05[i]:10d}")
    print(f"\ntotals: exact {t_exact.sum():.2f}s / {r_exact.sum()} reads;"
          f"  phi=5% {t_05.sum():.2f}s / {r_05.sum()} reads"
          f"  → speedup {t_exact.sum()/t_05.sum():.2f}x,"
          f" I/O saved {1 - r_05.sum()/max(r_exact.sum(),1):.1%}")
    return {"exact": res_exact, "phi5": res_05, "oracle": truths}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the data lives; 'cpu' runs the engine "
                         "under 'torch'")
    main(device=ap.parse_args().device)
