"""gx×gy binned aggregation of one tile — the sequential split's data
plane: plain PyTorch version and the CUDA kernel's wrapper.

The kernel is the S = 1 launch of ``csrc/segment_bin_agg.cu`` (TPU
original: ``repro/kernels/bin_agg.py`` ``bin_agg_pallas``); it keeps its
own op, plain version and launch count. Ownership is the host's float64
clip-binning rule (see :mod:`repro_torch.kernels.segment_agg`).
"""
from __future__ import annotations

import numpy as np
import torch

from . import build
from .segment_agg import agg4, bin_params, cell_keys, launch_segment_bin_agg

MAX_CELLS = 64   # the reference's bound on one tile's split grid


def _check_grid(gx: int, gy: int) -> None:
    if gx * gy > MAX_CELLS:
        raise ValueError(f"bin_agg grid {gx}x{gy} exceeds {MAX_CELLS} "
                         "cells")


def bin_agg_torch(xs, ys, vals, bbox, gx: int, gy: int):
    """Plain version: float64 ``(gx*gy, 4)`` on the input's device."""
    _check_grid(gx, gy)
    sid = torch.zeros(len(xs), dtype=torch.int64, device=xs.device)
    key = cell_keys(xs, ys, sid, bin_params(bbox, gx, gy), gx, gy)
    return agg4(key, vals, gx * gy)


def bin_agg_cuda(xs, ys, vals, bbox, gx: int, gy: int):
    """Launch ``bin_agg``, one kernel a call: float64 ``(gx*gy, 4)`` on
    the device."""
    _check_grid(gx, gy)
    out = launch_segment_bin_agg(xs, ys, vals,
                                 np.array([0, len(xs)], np.int64),
                                 bin_params(bbox, gx, gy), gx, gy)[0]
    build.LAUNCHES["bin_agg"] += 1
    return out
