"""Shared benchmark plumbing (from ``benchmarks/common.py``): the smoke
switch and CSV emission. The dataset and engine helpers come with the
benches that use them (B1, B2)."""
from __future__ import annotations

SMOKE = False


def configure_smoke():
    """Shrink the workload to a tiny-n smoke (same code paths, seconds
    not minutes): ``run --smoke`` calls this BEFORE the benchmark
    modules read their sizes."""
    global SMOKE
    SMOKE = True


# every emit() is also recorded here so the runner can persist the whole
# sweep as a BENCH_torch_*.json artifact (see run.py); unrounded, since
# the card's rows are a few microseconds, with the derived numbers as
# fields of their own
EMITTED = []


def emit(name: str, us_per_call: float, derived: str, **numbers):
    EMITTED.append({"name": name, "us_per_call": us_per_call,
                    "derived": derived, **numbers})
    print(f"{name},{us_per_call:.1f},{derived}")
