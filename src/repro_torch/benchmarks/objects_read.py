"""B2 — "The evaluation times closely follow the number of objects that
need to be read from the raw data file" (paper §4; port of
``benchmarks/objects_read.py``). Every answer is gated against the
float64 oracle."""
from __future__ import annotations

import numpy as np

from .common import emit, run_sequence


def main(device="cuda", backend=None):
    out = {}
    for name, phi in (("exact", 0.0), ("phi5", 0.05)):
        seq = run_sequence(phi, device=device, backend=backend)
        t, r = seq["times"], seq["reads"]
        mask = r > 0
        corr = float(np.corrcoef(r[mask], t[mask])[0, 1]) \
            if mask.sum() > 2 else float("nan")
        # reads per second of eval time (the implied "I/O speed")
        rate = r.sum() / max(t.sum(), 1e-9)
        emit(f"objects_read_{name}", t.sum() * 1e6 / len(t),
             f"corr_time_reads={corr:.3f};reads_total={int(r.sum())};"
             f"rows_per_s={rate:.0f}",
             corr_time_reads=corr, reads_total=int(r.sum()),
             rows_per_s=float(rate))
        out[name] = corr
    return out


if __name__ == "__main__":
    main()
