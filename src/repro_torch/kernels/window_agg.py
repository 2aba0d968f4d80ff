"""One window's aggregate over a whole object stream: plain PyTorch
version and the CUDA kernel's wrapper.

Port of :mod:`repro.kernels.window_agg` (TPU original:
``window_agg_pallas``; here ``csrc/window_agg.cu``). Both functions
return the float64 row ``(count, sum, min, max)`` of the first ``n``
objects inside the closed window, on the tensors' device: the window
rounded to float32 (:func:`~repro_torch.kernels.segment_agg.window_f32`),
the count exact, the sum in float64, the extrema exact; an empty
selection is ``(0, 0, +inf, -inf)``. ``vals=None`` counts only: the row
is that of an all-zero value plane, and the kernel reads x and y alone.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build
from .segment_agg import agg4, check_planes, window_f32

# partials the kernel's scratch holds: its grid is what fits on the card
# at once (2048 blocks of 256 threads is 16 an SM on a 128-SM card)
MAX_PARTIALS = 2048
_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_float] * 4 \
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
_launch = None


def _length(xs, n) -> int:
    n = len(xs) if n is None else int(n)
    if not 0 <= n <= len(xs):
        raise ValueError(f"n = {n} outside [0, {len(xs)}]")
    return n


def window_agg_torch(xs, ys, vals, window, n=None):
    """Plain version: float64 ``(4,)`` on the tensors' device."""
    n = _length(xs, n)
    x0, y0, x1, y1 = window_f32(window)
    xs, ys = xs[:n], ys[:n]
    m = (xs >= x0) & (xs <= x1) & (ys >= y0) & (ys <= y1)
    v = torch.zeros_like(xs) if vals is None else vals[:n]
    sel = v[m]
    return agg4(torch.zeros(len(sel), dtype=torch.int64, device=sel.device),
                sel, 1)[0]


def window_agg_cuda(xs, ys, vals, window, n=None):
    """Launch ``window_agg``: float64 ``(4,)`` on the device. Launches on
    the current stream and does not synchronise. The planes must share
    their address mod 16 (the kernel's float4 loads), as planes sliced
    alike do."""
    global _launch
    n = _length(xs, n)
    planes = (xs, ys) if vals is None else (xs, ys, vals)
    dev = check_planes(np.array([0, n]), *planes)
    if len({p.data_ptr() % 16 for p in planes}) > 1:
        raise ValueError("window_agg: the planes' addresses differ mod 16 "
                         "(views cut at different offsets); pass planes "
                         "sliced alike")
    if _launch is None:
        _launch = build.load("window_agg", "window_agg_launch", _ARGS)
    buf = torch.empty(4 + 3 * MAX_PARTIALS, dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        rc = _launch(xs.data_ptr(), ys.data_ptr(),
                     None if vals is None else vals.data_ptr(), n,
                     *window_f32(window), buf.data_ptr() + 32, MAX_PARTIALS,
                     buf.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check("window_agg", rc)
    build.LAUNCHES["window_agg"] += 1
    return buf[:4]
