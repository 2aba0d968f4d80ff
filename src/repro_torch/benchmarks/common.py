"""Shared benchmark plumbing (from ``benchmarks/common.py``): the
workload sizes, the smoke switch and CSV emission. The dataset and
engine helpers of B1/B2 (``fresh_engine``, ``workload``) come with the
benches that use them."""
from __future__ import annotations

# Paper setup, scaled as the reference's benches are: 4 M rows,
# ~20 K-object queries, an 8×8 crude grid (~62 K objects a tile, ≈3× the
# query size — the paper's regime); objects-read metrics are scale-free
N_ROWS = 4_000_000
N_QUERIES = 50
TARGET_OBJECTS = 20_000
SMOKE = False


def configure_smoke():
    """Shrink the workload to a tiny-n smoke (same code paths, seconds
    not minutes): ``run --smoke`` calls this BEFORE the benchmark
    modules read their sizes."""
    global N_ROWS, N_QUERIES, TARGET_OBJECTS, SMOKE
    N_ROWS = 120_000
    N_QUERIES = 12
    TARGET_OBJECTS = 2_000
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
