"""Perf harness: run ONE (arch × shape) cell's step on fake tensors with
a named set of ``layers.OPT`` toggles off and print its roofline terms
— the measurement step of the hypothesis → change → measure loop (port
of ``repro/launch/perf_cell.py``).

The step runs as ``launch.dryrun`` runs a cell (a fake process group of
256 or 512 ranks, the production ``DeviceMesh``, ``FakeTensorMode``,
the trip-count extrapolation), and the terms are its per-device counts
over ``launch.roofline``'s H100 constants (``PEAK``, ``HBM``,
``LINK``): counts from a device-free run, not times.

    PYTHONPATH=src python -m repro_torch.launch.perf_cell \\
        --arch starcoder2-15b --shape train_4k \\
        [--off fsdp_use_hint,mamba_recompute] [--multi-pod] [--smoke]
"""
from __future__ import annotations

import argparse
import json
import time

from .. import configs as cfgreg
from ..models import layers as L
from .dryrun import fake_device_mesh, measure_cell
from .mesh import make_production_mesh
from .roofline import HBM, LINK, PEAK


def measure(arch: str, shape: str, *, multi_pod=False, off=(),
            smoke=False):
    """The cell's roofline terms with the ``OPT`` toggles in ``off``
    turned off; every toggle is restored on the way out."""
    for k in off:
        assert k in L.OPT, (k, list(L.OPT))
    saved = dict(L.OPT)
    for k in off:
        L.OPT[k] = False
    try:
        cfg = (cfgreg.get_smoke if smoke else cfgreg.get)(arch)
        mesh = fake_device_mesh(make_production_mesh(multi_pod=multi_pod))
        t0 = time.time()
        nums = measure_cell(cfg, shape, mesh)
        return {
            "arch": arch, "shape": shape,
            "opts_off": list(off),
            "compute_s": nums["matmul_flops"] / PEAK,
            "memory_s": nums["hbm_traffic_bytes"] / HBM,
            "collective_s": nums["collective_bytes"] / LINK,
            "collective_by_type": {k: round(v / 2**30, 3)
                                   for k, v in
                                   nums["collective_by_type"].items()},
            "mem_gib_per_dev": (nums["argument_bytes"] +
                                nums["temp_bytes"] +
                                nums["output_bytes"] -
                                nums["alias_bytes"]) / 2**30,
            "compile_s": round(time.time() - t0, 1),
        }
    finally:
        L.OPT.clear()
        L.OPT.update(saved)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--off", default="")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke configuration")
    a = ap.parse_args(argv)
    off = tuple(x for x in a.off.split(",") if x)
    print(json.dumps(measure(a.arch, a.shape, multi_pod=a.multi_pod,
                             off=off, smoke=a.smoke), indent=1))


if __name__ == "__main__":
    main()
