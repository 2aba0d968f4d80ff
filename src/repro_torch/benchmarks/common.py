"""Shared benchmark plumbing (from ``benchmarks/common.py``): the
workload sizes and their switches, the bench dataset and engine
helpers, CSV emission and the answer gates.

Placement. Every bench takes ``device`` (default ``"cuda"``) and
``backend`` (default ``"cuda"`` on the card, ``"torch"`` elsewhere);
``backend="np"`` runs the float64 host mirrors on host data, the
reference's own arithmetic, so its counters compare exactly. On the
host the bench dataset is the reference's ``storage="csv"`` file, whose
reads parse text records. The card has no CSV mode
(``data/rawfile.py``): there the columns are float32 tensors resident
in device memory, so a time on the card measures the device-resident
path, not text parsing. Reads, read calls and splits are counters and
do not depend on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import AQPEngine, IndexConfig
from ..data import make_synthetic_dataset
from ..data.synthetic import exploration_path

# Paper setup, scaled as the reference's benches are: 4 M rows,
# ~20 K-object queries, an 8×8 crude grid (~62 K objects a tile, ≈3× the
# query size — the paper's regime); objects-read metrics are scale-free
N_ROWS = 4_000_000
N_QUERIES = 50
TARGET_OBJECTS = 20_000
SEED = 7
SMOKE = False

# (seed, storage, device) -> dataset; engines adapt their own index, so
# each bench still starts from a crude index over a shared dataset
_DS_CACHE = {}
# a dataset handed over by use_dataset(): it stands for every seed a
# bench asks for on its device
_HANDED = {}


def configure_smoke():
    """Shrink the workload to a tiny-n smoke (same code paths, seconds
    not minutes): ``run --smoke`` calls this BEFORE the benchmark
    modules read their sizes."""
    global N_ROWS, N_QUERIES, TARGET_OBJECTS, SMOKE
    N_ROWS = 120_000
    N_QUERIES = 12
    TARGET_OBJECTS = 2_000
    SMOKE = True
    _DS_CACHE.clear()
    _HANDED.clear()


def configure(n_rows: int):
    """Run the benches over ``n_rows`` rows, keeping the reference's
    ≈3× crude-tile-to-query ratio on the 8×8 grid: ``TARGET_OBJECTS``
    scales with the rows (20 000 at 4·10⁶, 500 000 at 10⁸);
    ``N_QUERIES`` stays."""
    global N_ROWS, TARGET_OBJECTS
    N_ROWS = int(n_rows)
    TARGET_OBJECTS = 20_000 * N_ROWS // 4_000_000
    _DS_CACHE.clear()
    _HANDED.clear()


def use_dataset(ds, seed: int):
    """Hand a resident dataset over to the benches (``chip_smoke.py``'s
    phase 9 passes phase 3's, so no second 10⁸-row dataset is made).
    ``seed`` is the one ``ds`` was made from and becomes ``SEED``; the
    dataset then stands for every seed a bench asks for on its device,
    so B7's parity session, which the reference runs on ``SEED + 1``,
    runs on it too."""
    global SEED
    if ds.n != N_ROWS:
        raise ValueError(f"the dataset has {ds.n} rows, the benches are "
                         f"sized for {N_ROWS}: call configure({ds.n})")
    SEED = int(seed)
    _HANDED[_device_key(ds.device)] = ds


def _device_key(device):
    return None if device is None else str(torch.device(device))


def resolve(device, backend):
    """``(backend, data device)``: the backend defaults to ``"cuda"`` on
    the card and ``"torch"`` elsewhere; ``"np"`` keeps the data on the
    host (``device=None``)."""
    if backend is None:
        backend = "cuda" if torch.device(device).type == "cuda" else "torch"
    return backend, (None if backend == "np" else device)


def dataset(seed=None, device="cuda", storage="csv"):
    """The bench dataset of ``seed`` (default ``SEED``) at ``N_ROWS``
    rows, cached. ``storage`` applies on the host (``device=None``):
    ``"csv"`` is the reference's in-situ file, ``"array"`` B7's; on a
    device the columns are resident there."""
    seed = SEED if seed is None else seed
    dev = _device_key(device)
    if dev in _HANDED:
        return _HANDED[dev]
    storage = storage if device is None else "array"
    key = (seed, storage, dev)
    if key not in _DS_CACHE:
        _DS_CACHE[key] = make_synthetic_dataset(
            n=N_ROWS, seed=seed, device=device, storage=storage)
    return _DS_CACHE[key]


def bench_config(backend: str, **kw) -> IndexConfig:
    """The benches' index: an 8×8 crude grid, ``min_split_count=512``,
    ``a0`` metadata at init."""
    kw.setdefault("grid0", (8, 8))
    kw.setdefault("min_split_count", 512)
    kw.setdefault("init_metadata_attrs", ("a0",))
    return IndexConfig(backend=backend, **kw)


def fresh_engine(seed=None, backend=None, device="cuda", **kw):
    """An engine with a crude index over the bench dataset (see
    :func:`dataset`); ``kw`` goes to the ``IndexConfig``."""
    backend, data_device = resolve(device, backend)
    return AQPEngine(dataset(seed, data_device), bench_config(backend, **kw))


def workload(ds, n_queries=None, target=None):
    # None ⇒ the module globals AT CALL TIME (so configure_* applies)
    n_queries = N_QUERIES if n_queries is None else n_queries
    target = TARGET_OBJECTS if target is None else target
    return exploration_path(ds, n_queries=n_queries, target_objects=target,
                            seed=11)


def require(ok, what: str):
    """A bench gate: raises (also under ``python -O``) when ``ok`` is
    false."""
    if not ok:
        raise AssertionError(what)


def check_answer(eng, r, window, agg, attr, phi, tol=1e-9):
    """The answer gate of the scalar benches: a φ = 0 answer is exact
    and equals the float64 oracle within ``tol`` relative; a φ > 0
    answer meets φ (or is exact) and its interval contains the oracle
    (within ``tol`` of ``max(|oracle|, 1)``)."""
    truth = eng.oracle(window, agg, attr)
    if phi == 0:
        require(r.exact and abs(r.value - truth) <= tol * abs(truth),
                f"exact {agg}({attr}) over {window}: {r.value!r} != "
                f"oracle {truth!r}")
    else:
        t = tol * max(abs(truth), 1.0)
        require((r.exact or r.bound <= phi + 1e-12)
                and r.lo - t <= truth <= r.hi + t,
                f"{agg}({attr}) over {window} at phi={phi}: "
                f"[{r.lo!r}, {r.hi!r}] bound {r.bound!r} misses oracle "
                f"{truth!r}")
    return truth


# float64 values compared across two paths on a device, whose sums run
# in another (atomic) order: within this relative tolerance
VALUE_RTOL = 1e-12


def same_values(a, b, exact):
    """``a`` equals ``b``: tensors by ``torch.equal``; arrays and scalars
    with equal NaN positions and infinities, the finite float64 values
    equal when ``exact``, else within ``VALUE_RTOL`` relative."""
    if isinstance(a, torch.Tensor):
        return bool(torch.equal(a, b))
    a = np.atleast_1d(np.asarray(a, np.float64))
    b = np.atleast_1d(np.asarray(b, np.float64))
    if exact or a.shape != b.shape:
        return bool(np.array_equal(a, b, equal_nan=True))
    fin = np.isfinite(a)
    return bool(np.array_equal(fin, np.isfinite(b))
                and np.array_equal(a[~fin], b[~fin], equal_nan=True)
                and (np.abs(a[fin] - b[fin])
                     <= VALUE_RTOL * np.abs(b[fin])).all())


def same_index(a, b, exact):
    """Two tile indexes (or chunk forests, index by index) hold the same
    tiles: the tile table, the permutation and the metadata equal, the
    float64 sums within ``VALUE_RTOL`` relative unless ``exact``."""
    if hasattr(a, "_indexes"):
        return (sorted(a._indexes) == sorted(b._indexes)
                and all(same_index(a._indexes[k], b._indexes[k], exact)
                        for k in a._indexes))
    n = a.n_tiles
    if b.n_tiles != n or not same_values(a.perm, b.perm, True):
        return False
    if not all(np.array_equal(getattr(a, k)[:n], getattr(b, k)[:n])
               for k in ("bbox", "offset", "count", "active", "level",
                         "parent")):
        return False
    for k in ("meta_sum", "meta_min", "meta_max", "meta_valid"):
        ma, mb = getattr(a, k), getattr(b, k)
        if ma.keys() != mb.keys() or not all(
                same_values(ma[c][:n], mb[c][:n],
                            exact or k != "meta_sum") for c in ma):
            return False
    return True


def run_sequence(phi, agg="mean", attr="a0", n_queries=None,
                 device="cuda", backend=None):
    """One session along the exploration path on a fresh engine, every
    answer gated by :func:`check_answer`."""
    eng = fresh_engine(device=device, backend=backend)
    wins = workload(eng.dataset, n_queries)
    times, reads, bounds = [], [], []
    for w in wins:
        r = eng.query(w, agg, attr, phi=phi)
        check_answer(eng, r, w, agg, attr, phi)
        times.append(r.eval_time_s)
        reads.append(r.objects_read)
        bounds.append(r.bound)
    return {"times": np.array(times), "reads": np.array(reads),
            "bounds": np.array(bounds), "engine": eng}


# every emit() is also recorded here so the runner can persist the whole
# sweep as a BENCH_torch_*.json artifact (see run.py); unrounded, since
# the card's rows are a few microseconds, with the derived numbers as
# fields of their own
EMITTED = []


def emit(name: str, us_per_call: float, derived: str, **numbers):
    EMITTED.append({"name": name, "us_per_call": us_per_call,
                    "derived": derived, **numbers})
    print(f"{name},{us_per_call:.1f},{derived}")


def mixed_io_summary(tot, extra=None) -> str:
    """Attribute a session's I/O per query type from
    ``EngineTrace.totals()``'s scalar/heatmap breakdown (and the
    speculative-rows accounting). ``extra`` passes additional
    ``key=value`` parts through into the same derived field."""
    parts = [f"rows_read={tot['total_objects_read']}",
             f"read_calls={tot['total_read_calls']}",
             f"speculative_rows={tot['total_speculative_rows']}"]
    for kind in ("scalar", "heatmap"):
        if tot[f"{kind}_queries"]:
            parts.append(
                f"{kind}:q={tot[f'{kind}_queries']}"
                f";rows={tot[f'{kind}_objects_read']}"
                f";reads={tot[f'{kind}_read_calls']}"
                f";spec={tot[f'{kind}_speculative_rows']}")
    if extra:
        parts.extend([extra] if isinstance(extra, str) else list(extra))
    return ";".join(parts)
