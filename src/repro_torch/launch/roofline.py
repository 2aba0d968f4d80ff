"""Bandwidth roofline of the AQP kernels on an NVIDIA H100.

The port of the AQP mode of ``repro/launch/roofline.py``
(``aqp_kernel_roofline``): the selection/aggregation kernels stream
their operand planes once and do O(1) operations per byte, so their
bound is bytes streamed over the backend's bandwidth, and
``roofline_fraction`` = achieved / bound. The port's kernels bench
(:mod:`repro_torch.benchmarks.kernels_bench`) scores every row with it.

Bandwidths per backend:

- ``"cuda"`` — the hand-written kernels on an H100 SXM: HBM3 at
  3.35 TB/s (NVIDIA's data sheet).
- ``"torch"`` — the plain PyTorch versions on the same card: the same
  bound.
- ``"np"`` — the float64 host mirror: the reference's conservative
  single-socket stream bandwidth (``CPU_BW``), kept so the host rows
  score as the reference scores them.

The reference's other mode, the three-term (compute, memory,
collective) analysis of the LM cells (``roofline.py:75-168``), reads
the LM substrate's dry-run artifacts; it comes with that substrate
(ROADMAP queue A item 11), and so do its hardware constants.
"""
from __future__ import annotations

from typing import Dict

H100_HBM = 3.35e12
CPU_BW = 25e9
AQP_BW = {"cuda": H100_HBM, "torch": H100_HBM, "np": CPU_BW}


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
