"""Bench-compare gate: fail when a throughput row regresses (port of
``benchmarks/compare.py``).

    PYTHONPATH=src python -m repro_torch.benchmarks.compare \
        BASELINE.json experiments/BENCH_torch_smoke.json

Reads two ``BENCH_torch_*.json`` artifacts (``run.py``'s format),
extracts every row carrying a ``GB_s=<float>`` or ``rows_per_s=<float>``
term in its derived field (B3's kernel rows, B2's and B7's rows), and
exits non-zero if any row present in BOTH files dropped by more than
``TOLERANCE`` (30%) against the baseline. Rows only in one file are
reported but never fail the gate. Compare artifacts of one device only:
the file's ``device`` names it, and a baseline from another device (or
the CPU) says nothing about this one.
"""
from __future__ import annotations

import json
import re
import sys

TOLERANCE = 0.30

# gated throughput metrics: bandwidth rows (kernels) and row-throughput
# (B2, B7) — higher is better for both
_METRICS = (("GB_s", re.compile(r"(?:^|;)GB_s=([0-9.eE+-]+)")),
            ("rows_per_s", re.compile(r"(?:^|;)rows_per_s=([0-9.eE+-]+)")))


def load_metrics(path: str) -> dict:
    """``{(row_name, metric): value}`` for every gated metric present."""
    with open(path) as f:
        data = json.load(f)
    out = {}
    for row in data["rows"]:
        for metric, rx in _METRICS:
            m = rx.search(row.get("derived", ""))
            if m:
                out[(row["name"], metric)] = float(m.group(1))
    return out


def compare(baseline_path: str, current_path: str) -> int:
    base = load_metrics(baseline_path)
    cur = load_metrics(current_path)
    failures = []
    for key in sorted(base):
        name, metric = key
        if key not in cur:
            print(f"# {name} [{metric}]: only in baseline (skipped)")
            continue
        b, c = base[key], cur[key]
        drop = (b - c) / b if b > 0 else 0.0
        status = "FAIL" if drop > TOLERANCE else "ok"
        print(f"{name}: baseline={b:.6g} {metric} current={c:.6g} "
              f"{metric} ({-drop:+.1%}) {status}")
        if status == "FAIL":
            failures.append(f"{name}[{metric}]")
    for name, metric in sorted(set(cur) - set(base)):
        print(f"# {name}: new row, {cur[(name, metric)]:.6g} {metric} "
              f"(not gated)")
    if failures:
        print(f"# {len(failures)} throughput row(s) regressed more than "
              f"{TOLERANCE:.0%}: {', '.join(failures)}")
        return 1
    print(f"# bench-compare ok ({len(base)} baseline rows)")
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 3:
        print(__doc__)
        sys.exit(2)
    sys.exit(compare(sys.argv[1], sys.argv[2]))
