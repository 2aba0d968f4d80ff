"""B5 — partial vs full adaptation cost, sequential vs batched pipeline
(port of ``benchmarks/adaptation_cost.py``).

Reports, per accuracy constraint φ, the adaptation work (tiles split,
objects reorganized, index growth) and the cost amortization the batched
pipeline buys: raw-file read calls and kernel invocations per exploration
session drop from one-per-tile to one-per-round (the paper's "reduce the
costs associated with ... refining the index" claim, batched as in
crack-in-batch adaptive indexing). Every answer is gated against the
float64 oracle. The sequential arm splits one tile at a time: on the
card that is the path that launches ``bin_agg``."""
from __future__ import annotations

from .common import check_answer, emit, fresh_engine, workload

N_WINDOWS = 30


def run_session(phi: float, sequential: bool, device="cuda", backend=None):
    eng = fresh_engine(device=device, backend=backend)
    wins = workload(eng.dataset, N_WINDOWS)
    for w in wins:
        r = eng.query(w, "mean", "a0", phi=phi, sequential=sequential)
        check_answer(eng, r, w, "mean", "a0", phi)
    tot = eng.trace.totals()  # the trace aggregates read calls/rows now
    return (eng, tot["total_time_s"], tot["total_read_calls"],
            tot["total_objects_read"], tot["queries"])


def main(device="cuda", backend=None):
    out = {}
    for name, phi in (("exact", 0.0), ("phi1", 0.01), ("phi5", 0.05)):
        for mode, sequential in (("seq", True), ("batched", False)):
            eng, t, reads, rows, n = run_session(phi, sequential, device,
                                                 backend)
            a = eng.adapt_stats
            emit(f"adaptation_{name}_{mode}", t * 1e6 / n,
                 f"tiles_split={a.tiles_split};"
                 f"objects_reorganized={a.objects_reorganized};"
                 f"active_tiles={eng.index.n_active};"
                 f"read_calls={reads};"
                 f"rows_read={rows};"
                 f"kernel_calls={a.kernel_calls};"
                 f"batch_rounds={a.batch_rounds}",
                 time_s=t, read_calls=reads, rows_read=rows,
                 tiles_split=a.tiles_split)
            out[(name, mode)] = {"tiles_split": a.tiles_split,
                                 "read_calls": reads,
                                 "kernel_calls": a.kernel_calls,
                                 "time_s": t}
    return out


if __name__ == "__main__":
    main()
