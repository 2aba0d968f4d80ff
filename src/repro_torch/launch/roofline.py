"""Roofline analysis on an NVIDIA H100 (port of
``repro/launch/roofline.py``).

Two modes, as in the reference:

1. **The LM cells' three-term analysis** (:func:`analyze_cell`). From a
   dry-run record of one (arch × shape × mesh) cell — its per-device
   matmul FLOPs, HBM traffic and collective bytes (the reference's
   ``launch.dryrun`` JSON records, which the port's
   ``repro_torch.launch.dryrun`` writes with the same keys, by default to
   ``experiments/dryrun_torch``) — the per-device time lower bounds

       compute    = matmul_FLOPs_per_device / PEAK
       memory     = HBM_traffic_per_device  / HBM
       collective = collective_bytes_per_device / LINK

   The dominant term is the bottleneck; ``roofline_fraction`` =
   compute / dominant says how close the cell is to compute-bound.
   MODEL_FLOPS = k·N·D with k = 6 (train) or 2 (inference), N = active
   parameters (MoE: shared + top-k routed), D = tokens a step; its ratio
   to the HLO matmul FLOPs × devices exposes remat and redundant work.

2. **The AQP kernels' bandwidth roofline** (:func:`aqp_kernel_roofline`):
   the selection/aggregation kernels stream their operand planes once
   and do O(1) operations per byte, so their bound is bytes streamed
   over the backend's bandwidth, and ``roofline_fraction`` = achieved /
   bound. The port's kernels bench
   (:mod:`repro_torch.benchmarks.kernels_bench`) scores every row with
   it. Bandwidths per backend: ``"cuda"`` (the hand-written kernels)
   and ``"torch"`` (their plain versions) HBM3 on the same card;
   ``"np"`` (the float64 host mirror) the reference's conservative
   single-socket stream bandwidth (``CPU_BW``), so the host rows score
   as the reference scores them.

Hardware constants, an H100 SXM5 80 GB (NVIDIA's H100 Tensor Core GPU
data sheet), in place of the reference's TPU v5e ones:
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

PEAK = 989e12      # bfloat16 dense tensor-core FLOP/s (1 979e12 is sparse)
HBM = 3.35e12      # HBM3 bytes/s
LINK = 450e9       # NVLink 4 bytes/s one way (900e9 both ways), per GPU
H100_HBM = HBM
CPU_BW = 25e9
AQP_BW = {"cuda": H100_HBM, "torch": H100_HBM, "np": CPU_BW}

_FACTOR = {"train": 6.0, "prefill": 2.0, "decode": 2.0}


def aqp_kernel_roofline(n_bytes: float, seconds: float,
                        backend: str) -> Dict:
    """Bandwidth-roofline verdict for one AQP kernel measurement.

    ``n_bytes`` is the kernel's minimum streamed traffic (each operand
    plane read once), ``seconds`` the measured time per call,
    ``backend`` one of ``AQP_BW``'s keys. Returns ``achieved_GB_s``,
    the backend's ``bound_GB_s`` and ``roofline_fraction`` =
    achieved / bound.
    """
    bound = AQP_BW[backend]
    achieved = (n_bytes / seconds) if seconds > 0 else float("nan")
    return {"backend": backend,
            "achieved_GB_s": achieved / 1e9,
            "bound_GB_s": bound / 1e9,
            "roofline_fraction": achieved / bound}


def _model_flops(arch: str, shape: str) -> Optional[float]:
    from .. import configs as cfgreg
    from ..configs.shapes import SHAPES
    from ..models.model import active_param_count
    try:
        cfg = cfgreg.get(arch)
    except KeyError:
        return None
    sh = SHAPES[shape]
    n_active = active_param_count(cfg)
    tokens = sh.batch * (sh.seq if sh.kind != "decode" else 1)
    return _FACTOR[sh.kind] * n_active * tokens


def load_cells(dryrun_dir: str) -> List[Dict]:
    cells = []
    for f in sorted(os.listdir(dryrun_dir)):
        if f.endswith(".json"):
            with open(os.path.join(dryrun_dir, f)) as fh:
                cells.append(json.load(fh))
    return cells


def analyze_cell(rec: Dict) -> Optional[Dict]:
    if rec.get("status") != "ok":
        return None
    ana = rec["hlo_analysis"]
    devices = rec["devices"]
    compute = ana["matmul_flops"] / PEAK
    memory = ana["hbm_traffic_bytes"] / HBM
    collective = ana["collective_bytes"] / LINK
    terms = {"compute": compute, "memory": memory,
             "collective": collective}
    dominant = max(terms, key=terms.get)
    t_dom = terms[dominant]
    mf = _model_flops(rec["arch"], rec["shape"])
    hlo_global = ana["matmul_flops"] * devices
    ratio = (mf / hlo_global) if (mf and hlo_global) else float("nan")
    mfu_at_roofline = (mf / devices / PEAK) / t_dom \
        if (mf and t_dom > 0) else float("nan")
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "compute_s": compute, "memory_s": memory,
        "collective_s": collective, "dominant": dominant,
        "roofline_fraction": compute / t_dom if t_dom else float("nan"),
        "mfu_at_roofline": mfu_at_roofline,
        "model_flops": mf, "hlo_flops_global": hlo_global,
        "useful_ratio": ratio,
        "mem_gib_per_dev": (rec["memory"]["total_bytes"] / 2**30)
        if rec.get("memory") else float("nan"),
        "fix_hint": _hint(dominant, rec),
    }


def _hint(dominant: str, rec: Dict) -> str:
    if dominant == "collective":
        top = max(rec["hlo_analysis"]["collective_by_type"].items(),
                  key=lambda kv: kv[1], default=("?", 0))
        return (f"reduce {top[0]} traffic (overlap with compute, coarser "
                f"grain, or reshard to avoid it)")
    if dominant == "memory":
        return ("raise arithmetic intensity: fuse elementwise chains, "
                "keep bf16 end-to-end, avoid re-materialized temps")
    return "compute-bound: improve MXU utilization / drop redundant FLOPs"


def print_table(dryrun_dir: str, mesh_filter: str = "pod16x16"):
    cells = load_cells(dryrun_dir)
    print(f"# Roofline (single-pod {mesh_filter}; H100 SXM: "
          f"{PEAK / 1e12:g} TF/s bf16, {HBM / 1e9:g} GB/s HBM, "
          f"{LINK / 1e9:g} GB/s NVLink)")
    hdr = ("arch,shape,compute_s,memory_s,collective_s,dominant,"
           "roofline_fraction,mfu_at_roofline,useful_flops_ratio,"
           "mem_GiB_per_dev")
    print(hdr)
    for rec in cells:
        if rec.get("mesh") != mesh_filter:
            continue
        if rec.get("status") == "skipped":
            print(f"{rec['arch']},{rec['shape']},,,,skipped:"
                  f"{rec['reason'][:60]},,,,")
            continue
        a = analyze_cell(rec)
        if a is None:
            continue
        print(f"{a['arch']},{a['shape']},{a['compute_s']:.4e},"
              f"{a['memory_s']:.4e},{a['collective_s']:.4e},"
              f"{a['dominant']},{a['roofline_fraction']:.3f},"
              f"{a['mfu_at_roofline']:.3f},{a['useful_ratio']:.2f},"
              f"{a['mem_gib_per_dev']:.2f}")


if __name__ == "__main__":
    import sys
    print_table(sys.argv[1] if len(sys.argv) > 1
                else "experiments/dryrun_torch")
