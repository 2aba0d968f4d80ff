"""Packed multi-segment aggregation: plain PyTorch versions and the
CUDA kernels' wrappers.

A batched refinement round gathers the object segments of its tiles into
ONE concatenated stream (``boundaries`` ``(S+1,)`` delimit segment s as
``[boundaries[s], boundaries[s+1])``) and needs, in one pass,

- ``segment_window_agg``: per-segment ``(count, sum, min, max)`` inside
  one closed window — every tile's exact in-window contribution (a ±inf
  window gives whole-segment enrichment statistics);
- ``segment_bin_agg``: per-(segment, cell) aggregates over each
  segment's own even ``gx × gy`` split of its bbox — the child metadata
  of every tile split in the round;
- ``segment_bin_agg_edges``: the same along explicit per-segment split
  edges — the child metadata of a bin-aligned heatmap split
  (``csrc/segment_bin_agg_edges.cu``);
- ``segment_window_bin_agg``: per-(segment, window-bin) aggregates of
  the objects inside one window, binned by one ``bx × by`` grid laid on
  it — a heatmap tile's exact per-bin contribution
  (``csrc/segment_window_bin_agg.cu``, shared with the fused select op
  of :mod:`repro_torch.kernels.fused_select`).
- ``segment_window_agg_multi`` / ``segment_window_bin_agg_multi``: the
  same two reads with each segment under its OWN window — the serving
  tick's packed pass over several queries' tiles
  (``csrc/segment_window_agg.cu``, ``csrc/segment_window_bin_agg.cu``).

Every function returns float64 rows ``(count, sum, min, max)`` on the
input's device: integer-valued counts, float64 sums, float32 extrema
widened exactly. The ``*_torch`` functions are the plain versions (any
device; the CPU tests run them); the ``*_cuda`` functions launch the
hand-written kernels and take CUDA tensors only.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build
from .ref import window_bin_params

# Control-plane constants of the reference (``repro/kernels/
# segment_agg.py:58``, ``repro/kernels/gridplan.py:37``). They size the
# driver's refinement rounds and validate ``IndexConfig``; the CUDA
# kernels have no unroll limit, but changing these would change
# ``read_calls`` and the index evolution against the reference.
MAX_SEGMENTS = 64
MAX_UNROLL = 512
# the kernels' block-private table (csrc/agg_common.cuh AGG_MAX_CELLS)
MAX_TABLE_CELLS = 2048

EVERYWHERE = (-np.inf, -np.inf, np.inf, np.inf)
_INT64_EDGE = 9.2233720368547758e18


# --------------------------------------------------------------------- #
# shared plumbing (plain versions and wrappers alike)
# --------------------------------------------------------------------- #

def window_f32(window):
    """The window's edges rounded to float32, as Python floats. A
    float32 coordinate compares against these the same way in float32
    or float64 — the reference's rule for Python-float windows
    (``repro/kernels/ops.py:574-577`` under numpy 2's weak scalars)."""
    return tuple(float(np.float32(w)) for w in window)


def host_bounds(boundaries) -> np.ndarray:
    """Segment boundaries as a host int64 vector, validated."""
    b = np.ascontiguousarray(boundaries, np.int64)
    if b.ndim != 1 or len(b) < 2 or (np.diff(b) < 0).any():
        raise ValueError("boundaries must be a non-decreasing (S+1,) "
                         "vector with S >= 1")
    return b


def bin_params(bboxes, gx: int, gy: int) -> np.ndarray:
    """Per-segment ``(x0, y0, cw, ch)`` float64 rows of the even split —
    ``cw = max((x1 - x0) / gx, 1e-30)``, the host rule of
    ``repro/core/index.py:820-821``."""
    bb = np.asarray(bboxes, np.float64).reshape(-1, 4)
    cw = np.maximum((bb[:, 2] - bb[:, 0]) / gx, 1e-30)
    ch = np.maximum((bb[:, 3] - bb[:, 1]) / gy, 1e-30)
    return np.ascontiguousarray(np.stack([bb[:, 0], bb[:, 1], cw, ch], 1))


def clip_cell(q: torch.Tensor, g: int) -> torch.Tensor:
    """numpy's ``clip(floor(q).astype(int64), 0, g - 1)``, including its
    out-of-range cast (INT64_MIN, clipped to 0)."""
    f = torch.floor(q)
    f = torch.where((f >= -_INT64_EDGE) & (f < _INT64_EDGE), f,
                    torch.zeros_like(f))
    return f.clamp(0, g - 1).to(torch.int64)


def check_edges(b: np.ndarray, x_edges, y_edges):
    """``(S, gx, gy)`` of per-segment split edges ``(S, gx+1)`` /
    ``(S, gy+1)``; anything else raises."""
    xe, ye = np.asarray(x_edges), np.asarray(y_edges)
    n_seg = len(b) - 1
    if xe.ndim != 2 or ye.ndim != 2 or len(xe) != n_seg \
            or len(ye) != n_seg or xe.shape[1] < 2 or ye.shape[1] < 2:
        raise ValueError("split edges must be (S, gx+1) and (S, gy+1) "
                         "with gx, gy >= 1")
    return n_seg, xe.shape[1] - 1, ye.shape[1] - 1


def segment_ids(b: np.ndarray, device) -> torch.Tensor:
    """Per-object segment id of the stream ``[b[0], b[-1])``."""
    counts = torch.from_numpy(np.diff(b)).to(device)
    return torch.repeat_interleave(
        torch.arange(len(b) - 1, device=device), counts,
        output_size=int(b[-1] - b[0]))


def cell_keys(xs, ys, sid, params: np.ndarray, gx: int,
              gy: int) -> torch.Tensor:
    """Ownership key ``sid·k + cy·gx + cx`` under the float64 split rule:
    ``((double)x − x0) / cw`` per object, IEEE subtract and divide of
    gathered per-object operands (never a scalar divisor, which PyTorch
    may turn into a multiply by the reciprocal)."""
    p = torch.from_numpy(params).to(xs.device)[sid]
    cx = clip_cell((xs.double() - p[:, 0]) / p[:, 2], gx)
    cy = clip_cell((ys.double() - p[:, 1]) / p[:, 3], gy)
    return sid * (gx * gy) + cy * gx + cx


def edge_cell_ids(xs, ys, sid, x_edges, y_edges) -> torch.Tensor:
    """Cell id ``cy·gx + cx`` under explicit per-segment split edges,
    the host rule of ``ref.edge_cell_ids_np``: ``cx = Σ_i 1[x ≥ e_i]``
    over segment ``sid``'s interior float64 edges, the float32
    coordinate widened to float64 (never the edges narrowed)."""
    dev = xs.device

    def cells(p, edges):
        e = torch.from_numpy(np.ascontiguousarray(
            np.asarray(edges, np.float64)[:, 1:-1])).to(dev)
        pd = p.double()
        c = torch.zeros(len(p), dtype=torch.int64, device=dev)
        for i in range(e.shape[1]):
            c += pd >= e[sid, i]
        return c

    gx = np.asarray(x_edges).shape[1] - 1
    return cells(ys, y_edges) * gx + cells(xs, x_edges)


def param_bin_ids(xs, ys, p: torch.Tensor, bx: int, by: int):
    """``(in_window_mask, bin_id)`` of float32 tensors under per-object
    contract params ``p`` (float32 ``(L, 6)`` rows ``(x0, y0, x1, y1,
    cw, ch)`` of ``ref.window_bin_params``, gathered or expanded to the
    objects): float32 compares, and ``clip(floor((x − x0) / cw))`` as
    IEEE float32 subtract and divide of tensor operands of the objects'
    own shape (never a scalar divisor, which PyTorch may turn into a
    multiply by the reciprocal)."""
    x0, y0, x1, y1, cw, ch = p.unbind(1)
    m = (xs >= x0) & (xs <= x1) & (ys >= y0) & (ys <= y1)
    cx = clip_cell((xs - x0) / cw, bx)
    cy = clip_cell((ys - y0) / ch, by)
    return m, cy * bx + cx


def window_bin_ids(xs, ys, window, bx: int, by: int):
    """``(in_window_mask, bin_id)`` of float32 tensors — the host rule
    ``ref.window_bin_ids_np`` through the binning contract
    ``ref.window_bin_params``: float32 window and cell sizes (the cell
    sizes derived in float64 first), then :func:`param_bin_ids`."""
    p = torch.from_numpy(window_bin_params(window, bx, by)).to(xs.device)
    return param_bin_ids(xs, ys, p.expand(len(xs), 6), bx, by)


def windows_f32(windows, n_seg: int) -> np.ndarray:
    """Per-segment windows as a float32 ``(S, 4)`` array, each rounded by
    :func:`window_f32` — the rule every device path compares under."""
    w = np.array([window_f32(v) for v in windows], np.float32).reshape(-1, 4)
    if len(w) != n_seg:
        raise ValueError(f"{len(w)} windows for {n_seg} segments")
    return w


def bin_params_multi(windows, n_seg: int, bx: int, by: int) -> np.ndarray:
    """Per-segment contract params, float32 ``(S, 6)``
    (``ref.window_bin_params`` of each segment's own window)."""
    if bx < 1 or by < 1:
        raise ValueError(f"an empty bin grid {bx}x{by}")
    p = window_bin_params(windows, bx, by)
    if len(p) != n_seg:
        raise ValueError(f"{len(p)} windows for {n_seg} segments")
    return np.ascontiguousarray(p)


def agg4(key: torch.Tensor, vals: torch.Tensor,
         n_cells: int) -> torch.Tensor:
    """Plain keyed reduction: float64 ``(n_cells, 4)``."""
    dev = vals.device
    cnt = torch.bincount(key, minlength=n_cells).to(torch.float64)
    s = torch.zeros(n_cells, dtype=torch.float64, device=dev).index_add_(
        0, key, vals.to(torch.float64))
    mn = torch.full((n_cells,), np.inf, dtype=torch.float32,
                    device=dev).scatter_reduce_(0, key, vals, "amin")
    mx = torch.full((n_cells,), -np.inf, dtype=torch.float32,
                    device=dev).scatter_reduce_(0, key, vals, "amax")
    return torch.stack([cnt, s, mn.to(torch.float64),
                        mx.to(torch.float64)], 1)


# --------------------------------------------------------------------- #
# plain PyTorch versions
# --------------------------------------------------------------------- #

def segment_window_agg_torch(xs, ys, vals, boundaries, window):
    """Plain version of :func:`segment_window_agg_cuda`: float64
    ``(S, 4)`` on the input's device."""
    b = host_bounds(boundaries)
    lo, hi = int(b[0]), int(b[-1])
    xs, ys, vals = xs[lo:hi], ys[lo:hi], vals[lo:hi]
    sid = segment_ids(b, vals.device)
    if tuple(window) == EVERYWHERE:
        return agg4(sid, vals, len(b) - 1)
    x0, y0, x1, y1 = window_f32(window)
    m = (xs >= x0) & (xs <= x1) & (ys >= y0) & (ys <= y1)
    return agg4(sid[m], vals[m], len(b) - 1)


def segment_bin_agg_torch(xs, ys, vals, boundaries, bboxes, gx: int,
                          gy: int):
    """Plain version of :func:`segment_bin_agg_cuda`: float64
    ``(S, gx*gy, 4)`` on the input's device."""
    b = host_bounds(boundaries)
    lo, hi = int(b[0]), int(b[-1])
    sid = segment_ids(b, vals.device)
    key = cell_keys(xs[lo:hi], ys[lo:hi], sid, bin_params(bboxes, gx, gy),
                    gx, gy)
    n_seg = len(b) - 1
    return agg4(key, vals[lo:hi], n_seg * gx * gy).reshape(
        n_seg, gx * gy, 4)


def segment_bin_agg_edges_torch(xs, ys, vals, boundaries, x_edges,
                                y_edges):
    """Plain version of :func:`segment_bin_agg_edges_cuda`: float64
    ``(S, gx*gy, 4)`` on the input's device."""
    b = host_bounds(boundaries)
    lo, hi = int(b[0]), int(b[-1])
    sid = segment_ids(b, vals.device)
    n_seg, gx, gy = check_edges(b, x_edges, y_edges)
    k = gx * gy
    key = sid * k + edge_cell_ids(xs[lo:hi], ys[lo:hi], sid, x_edges,
                                  y_edges)
    return agg4(key, vals[lo:hi], n_seg * k).reshape(n_seg, k, 4)


def segment_window_bin_agg_torch(xs, ys, vals, boundaries, window,
                                 bx: int, by: int):
    """Plain version of :func:`segment_window_bin_agg_cuda`: float64
    ``(S, bx*by, 4)`` on the input's device."""
    b = host_bounds(boundaries)
    lo, hi = int(b[0]), int(b[-1])
    sid = segment_ids(b, vals.device)
    n_seg, nb = len(b) - 1, bx * by
    m, cid = window_bin_ids(xs[lo:hi], ys[lo:hi], window, bx, by)
    return agg4((sid * nb + cid)[m], vals[lo:hi][m],
                n_seg * nb).reshape(n_seg, nb, 4)


def segment_window_agg_multi_torch(xs, ys, vals, boundaries, windows):
    """Plain version of :func:`segment_window_agg_multi_cuda`: float64
    ``(S, 4)`` on the input's device, segment s under ``windows[s]``
    rounded to float32."""
    b = host_bounds(boundaries)
    lo, hi = int(b[0]), int(b[-1])
    xs, ys, vals = xs[lo:hi], ys[lo:hi], vals[lo:hi]
    sid = segment_ids(b, vals.device)
    w = torch.from_numpy(windows_f32(windows, len(b) - 1)).to(
        vals.device)[sid]
    m = ((xs >= w[:, 0]) & (xs <= w[:, 2]) & (ys >= w[:, 1])
         & (ys <= w[:, 3]))
    return agg4(sid[m], vals[m], len(b) - 1)


def segment_window_bin_agg_multi_torch(xs, ys, vals, boundaries, windows,
                                       bx: int, by: int):
    """Plain version of :func:`segment_window_bin_agg_multi_cuda`:
    float64 ``(S, bx*by, 4)`` on the input's device, segment s binned by
    the contract params of its own ``windows[s]``."""
    b = host_bounds(boundaries)
    lo, hi = int(b[0]), int(b[-1])
    sid = segment_ids(b, vals.device)
    n_seg, nb = len(b) - 1, bx * by
    p = torch.from_numpy(bin_params_multi(windows, n_seg, bx, by)).to(
        vals.device)[sid]
    m, cid = param_bin_ids(xs[lo:hi], ys[lo:hi], p, bx, by)
    return agg4((sid * nb + cid)[m], vals[lo:hi][m],
                n_seg * nb).reshape(n_seg, nb, 4)


# --------------------------------------------------------------------- #
# CUDA kernel wrappers
# --------------------------------------------------------------------- #

_P = ctypes.c_void_p
_ONE_ARGS = [_P] * 9    # x, y, v, host args, ws, ticket, out, suffix, stream
_ROWS_ARGS = [_P] * 8   # x, y, v, host args, ws, ticket, out, stream


def check_planes(b: np.ndarray, *planes: torch.Tensor) -> torch.device:
    """The kernels take contiguous 1-D float32 CUDA planes covering the
    segments; anything else raises before a pointer is passed."""
    dev = planes[0].device
    for p in planes:
        if not isinstance(p, torch.Tensor) or p.device.type != "cuda":
            raise TypeError("the CUDA kernels take CUDA tensors; use the "
                            "'torch' backend for CPU tensors")
        if p.dtype != torch.float32 or p.dim() != 1 \
                or not p.is_contiguous() or p.device != dev:
            raise TypeError("kernel planes must be contiguous 1-D float32 "
                            "tensors on one device")
        if p.numel() < b[-1]:
            raise ValueError("a plane is shorter than the segments")
    if b[0] < 0:
        raise ValueError("negative segment boundary")
    return dev


# --- the one-launch kernels (rows 1-4 and 6-10 of PERF.md's kernel table):
# a cached launch function, one workspace per (device, stream) that every
# call leaves in its identity state, one output buffer a call. Each host
# argument block is a numpy record laid out as its C struct (no padding).

# csrc/segment_window_agg.cu SwaArgs: boundaries, windows, (S, mode)
_SWA_ARGS = np.dtype([("b", "<i8", MAX_SEGMENTS + 1),
                      ("w", "<f4", (MAX_SEGMENTS, 4)), ("i", "<i4", 2)])
# its entries' mode numbers (checked against ``segment_window_agg_modes``)
_SWA_WINDOW, _SWA_EVERYWHERE, _SWA_MULTI = 0, 1, 2
# csrc/segment_bin_agg.cu SbaArgs: boundaries, per-segment (x0, y0, cw,
# ch), (S, gx, gy, 0)
_SBA_ARGS = np.dtype([("b", "<i8", MAX_SEGMENTS + 1),
                      ("p", "<f8", (MAX_SEGMENTS, 4)), ("i", "<i4", 4)])
# csrc/segment_window_bin_agg.cu WinArgs, the one-window entry
_WIN_ARGS = np.dtype([("b", "<i8", MAX_SEGMENTS + 1),
                      ("dv", "<f8", MAX_SEGMENTS), ("w", "<f4", 6),
                      ("i", "<i4", 4)])
# its MultiArgs, the multi entry: per-segment contract rows, the query
# spans, (S, bx, by, select, spans)
_MULTI_ARGS = np.dtype([("b", "<i8", MAX_SEGMENTS + 1),
                        ("dv", "<f8", MAX_SEGMENTS),
                        ("w", "<f4", (MAX_SEGMENTS, 6)),
                        ("qb", "<i4", MAX_SEGMENTS + 1), ("i", "<i4", 5)])
# the split kernel's host arguments (csrc/segment_bin_agg_edges.cu
# EdgeHead, then the edges): the boundaries and (S, gx, gy, ne) in
# EDGE_HEAD float64 words, then the ne interior edges. Its launch takes at
# most EDGE_CAP of them.
EDGE_HEAD = (MAX_SEGMENTS + 1) + 2
EDGE_CAP = 4022
# per launch function, the export that reports its argument record's
# size, and that size
_ARGS_SIZE = {
    "segment_window_agg_one_launch": ("segment_window_agg_args_size",
                                      _SWA_ARGS.itemsize),
    "segment_bin_agg_one_launch": ("segment_bin_agg_args_size",
                                   _SBA_ARGS.itemsize),
    "segment_window_bin_agg_one_launch": ("segment_window_bin_agg_args_size",
                                          _WIN_ARGS.itemsize),
    "segment_window_bin_agg_multi_launch": (
        "segment_window_bin_agg_multi_args_size", _MULTI_ARGS.itemsize)}
# an empty cell's (min, max) word: the encodings of +inf and -inf
_EMPTY_EXTREMA = (0x007FFFFF << 32) | 0xFF800000

_FNS: dict = {}
_WORKSPACES: dict = {}


def _one_launch(lib: str, fn: str, argtypes):
    """The cached launch function ``fn`` of ``lib``; at first use, its
    host argument layout is checked against the library's."""
    f = _FNS.get(fn)
    if f is None:
        f = build.load(lib, fn, argtypes)
        dll = build.library(lib)
        if fn in _ARGS_SIZE:
            size_fn, size = _ARGS_SIZE[fn]
            ok = getattr(dll, size_fn)() == size
            if lib == "segment_window_agg":
                ok = ok and dll.segment_window_agg_modes() == (
                    _SWA_WINDOW | _SWA_EVERYWHERE << 8 | _SWA_MULTI << 16)
        else:
            head, cap = ctypes.c_int(), ctypes.c_int()
            dll.segment_bin_agg_edges_limits(ctypes.byref(head),
                                             ctypes.byref(cap))
            ok = (head.value, cap.value) == (8 * EDGE_HEAD, EDGE_CAP)
        if not ok:
            raise RuntimeError(f"{lib}: the library's argument layout "
                               "or mode numbers differ from the wrapper's")
        _FNS[fn] = f
    return f


def workspace(dev: torch.device, stream: int, cells: int) -> torch.Tensor:
    """The one-launch kernels' global workspace on ``(dev, stream)``:
    int64 words, three a cell (count, sum, then min and max, as
    ``csrc/agg_common.cuh`` ``Cell`` lies) and the ticket last, in
    identity state between calls (every call resets what it used). Calls
    on one stream are ordered, so they share it; another stream gets its
    own. Allocated and initialised when first needed, and again when a
    call needs more cells than it holds."""
    key = (dev.index, stream)
    ws = _WORKSPACES.get(key)
    if ws is None or ws.numel() < 3 * cells + 1:
        ws = torch.zeros(3 * cells + 1, dtype=torch.int64, device=dev)
        ws[2:3 * cells:3] = _EMPTY_EXTREMA
        _WORKSPACES[key] = ws
    return ws


def _run_one(name: str, fn, dev: torch.device, cells: int, planes, args,
             outs) -> None:
    """``fn(*planes, args, ws, ticket, *outs, stream)`` on the current
    stream with its workspace, without entering a device context when
    ``dev`` is current. A failed launch drops the workspace and raises."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = workspace(dev, stream, cells)
    call = (*planes, args, ws.data_ptr(),
            ws.data_ptr() + 8 * (ws.numel() - 1), *outs, stream)
    if dev.index == torch.cuda.current_device():
        rc = fn(*call)
    else:
        with torch.cuda.device(dev):
            rc = fn(*call)
    if rc != 0:
        _WORKSPACES.pop((dev.index, stream), None)
        build.check(name, rc)


def _launch_segment_window(xs, ys, vals, b: np.ndarray, windows,
                           mode: int) -> torch.Tensor:
    """One launch of ``csrc/segment_window_agg.cu`` (rows 1 and 8; the
    callers count their own launches). ``windows``: float32 ``(S, 4)``
    for the multi entry, ``(1, 4)`` for one window, ``None`` for the
    all-covering one. Returns float64 ``(S, 4)`` on the device."""
    n_seg = len(b) - 1
    if n_seg > MAX_SEGMENTS:
        raise ValueError(f"{n_seg} segments > MAX_SEGMENTS={MAX_SEGMENTS}")
    dev = check_planes(b, xs, ys, vals)
    args = np.zeros(1, _SWA_ARGS)
    args["b"][0, :n_seg + 1] = b
    if windows is not None:
        args["w"][0, :len(windows)] = windows
    args["i"][0] = (n_seg, mode)
    out = torch.empty((n_seg, 4), dtype=torch.float64, device=dev)
    fn = _one_launch("segment_window_agg", "segment_window_agg_one_launch",
                     _ROWS_ARGS)
    _run_one("segment_window_agg", fn, dev, n_seg,
             (xs.data_ptr(), ys.data_ptr(), vals.data_ptr()),
             args.ctypes.data, (out.data_ptr(),))
    return out


def segment_window_agg_cuda(xs, ys, vals, boundaries, window):
    """Launch ``segment_window_agg`` (TPU original:
    ``repro/kernels/segment_agg.py`` ``segment_window_agg_pallas``), one
    kernel a call. The all-covering window (all four edges ±inf, as the
    host mirror recognises it) takes the entry that reads ``vals`` alone
    and compares nothing: every object counts, NaN values too. Each entry
    keeps its own launch count (``segment_window_agg`` and
    ``segment_window_agg_everywhere``). Returns float64 ``(S, 4)`` on the
    device; launches on the current stream and does not synchronise."""
    b = host_bounds(boundaries)
    if tuple(window) == EVERYWHERE:
        out = _launch_segment_window(xs, ys, vals, b, None, _SWA_EVERYWHERE)
        build.LAUNCHES["segment_window_agg_everywhere"] += 1
    else:
        out = _launch_segment_window(
            xs, ys, vals, b, np.array([window_f32(window)], np.float32),
            _SWA_WINDOW)
        build.LAUNCHES["segment_window_agg"] += 1
    return out


def launch_segment_bin_agg(xs, ys, vals, b: np.ndarray, params: np.ndarray,
                           gx: int, gy: int) -> torch.Tensor:
    """One launch of the ``csrc/segment_bin_agg.cu`` kernel (shared by
    ``segment_bin_agg`` and its S = 1 case ``bin_agg``; the callers
    count their own launches)."""
    n_seg = len(b) - 1
    k = gx * gy
    if n_seg > MAX_SEGMENTS or n_seg * k > MAX_TABLE_CELLS:
        raise ValueError(f"{n_seg} segments x {k} cells exceeds the "
                         f"kernel's table ({MAX_SEGMENTS} segments, "
                         f"{MAX_TABLE_CELLS} cells)")
    dev = check_planes(b, xs, ys, vals)
    args = np.zeros(1, _SBA_ARGS)
    args["b"][0, :n_seg + 1] = b
    args["p"][0, :n_seg] = params
    args["i"][0, :3] = (n_seg, gx, gy)
    out = torch.empty((n_seg, k, 4), dtype=torch.float64, device=dev)
    fn = _one_launch("segment_bin_agg", "segment_bin_agg_one_launch",
                     _ROWS_ARGS)
    _run_one("segment_bin_agg", fn, dev, n_seg * k,
             (xs.data_ptr(), ys.data_ptr(), vals.data_ptr()),
             args.ctypes.data, (out.data_ptr(),))
    return out


def segment_bin_agg_cuda(xs, ys, vals, boundaries, bboxes, gx: int,
                         gy: int):
    """Launch ``segment_bin_agg`` (TPU original:
    ``repro/kernels/segment_agg.py`` ``segment_bin_agg_pallas``), one
    kernel a call. Returns float64 ``(S, gx*gy, 4)`` on the device."""
    b = host_bounds(boundaries)
    out = launch_segment_bin_agg(xs, ys, vals, b,
                                 bin_params(bboxes, gx, gy), gx, gy)
    build.LAUNCHES["segment_bin_agg"] += 1
    return out


def segment_bin_agg_edges_cuda(xs, ys, vals, boundaries, x_edges,
                               y_edges):
    """Launch ``segment_bin_agg_edges`` (TPU original:
    ``repro/kernels/segment_agg.py`` ``segment_bin_agg_edges_pallas``),
    one kernel a call. The edges stay float64 and travel in the launch's
    parameters: at most ``EDGE_CAP`` interior edges (``S·(gx + gy −
    2)``), else it raises before any launch. Returns float64
    ``(S, gx*gy, 4)`` on the device."""
    b = host_bounds(boundaries)
    n_seg, gx, gy = check_edges(b, x_edges, y_edges)
    ne = n_seg * (gx + gy - 2)
    if n_seg > MAX_SEGMENTS or ne > EDGE_CAP:
        raise ValueError(f"{n_seg} segments of {gx}x{gy} cells: more than "
                         f"{MAX_SEGMENTS} segments or {ne} interior edges, "
                         f"more than the kernel's {EDGE_CAP}")
    dev = check_planes(b, xs, ys, vals)
    k = gx * gy
    args = np.zeros(EDGE_HEAD + ne, np.float64)
    args[:n_seg + 1].view(np.int64)[:] = b
    args[MAX_SEGMENTS + 1:EDGE_HEAD].view(np.int32)[:] = (n_seg, gx, gy, ne)
    nx = EDGE_HEAD + n_seg * (gx - 1)
    args[EDGE_HEAD:nx] = np.asarray(x_edges, np.float64)[:, 1:-1].ravel()
    args[nx:] = np.asarray(y_edges, np.float64)[:, 1:-1].ravel()
    out = torch.empty((n_seg, k, 4), dtype=torch.float64, device=dev)
    fn = _one_launch("segment_bin_agg_edges",
                     "segment_bin_agg_edges_one_launch", _ROWS_ARGS)
    _run_one("segment_bin_agg_edges", fn, dev, n_seg * k,
             (xs.data_ptr(), ys.data_ptr(), vals.data_ptr()),
             args.ctypes.data, (out.data_ptr(),))
    build.LAUNCHES["segment_bin_agg_edges"] += 1
    return out


@functools.lru_cache(maxsize=256)
def _contract(window: tuple, bx: int, by: int) -> tuple:
    """``ref.window_bin_params`` of one window (a heatmap's rounds all
    bin by one)."""
    return tuple(window_bin_params(window, bx, by)[0].tolist())


def launch_segment_window_bin(xs, ys, vals, b: np.ndarray, window, bx: int,
                              by: int, dv=None):
    """One launch of the ``csrc/segment_window_bin_agg.cu`` one-window
    kernel (shared by ``segment_window_bin_agg`` and, with the
    per-segment float64 widths ``dv``, ``segment_window_bin_select``; the
    callers count their own launches). Returns ``(agg (S, bx*by, 4),
    suffix_w (S+1, bx*by) or None)``: views of one float64 buffer, the
    suffix rows behind the table's."""
    n_seg = len(b) - 1
    nb = bx * by
    if n_seg > MAX_SEGMENTS or bx < 1 or by < 1:
        raise ValueError(f"{n_seg} segments > MAX_SEGMENTS={MAX_SEGMENTS} "
                         f"or an empty bin grid {bx}x{by}")
    dev = check_planes(b, xs, ys, vals)
    args = np.zeros(1, _WIN_ARGS)
    args["b"][0, :n_seg + 1] = b
    args["w"][0] = _contract(tuple(float(w) for w in window), bx, by)
    args["i"][0] = (n_seg, bx, by, dv is not None)
    rows = 4 * n_seg * nb
    if dv is not None:
        dv = np.ascontiguousarray(dv, np.float64)
        if dv.shape != (n_seg,):
            raise ValueError(f"widths of shape {dv.shape}, want "
                             f"({n_seg},)")
        args["dv"][0, :n_seg] = dv
    buf = torch.empty(rows + (0 if dv is None else (n_seg + 1) * nb),
                      dtype=torch.float64, device=dev)
    fn = _one_launch("segment_window_bin_agg",
                     "segment_window_bin_agg_one_launch", _ONE_ARGS)
    _run_one("segment_window_bin_agg", fn, dev, n_seg * nb,
             (xs.data_ptr(), ys.data_ptr(), vals.data_ptr()),
             args.ctypes.data,
             (buf.data_ptr(),
              None if dv is None else buf.data_ptr() + 8 * rows))
    agg = buf[:rows].view(n_seg, nb, 4)
    return agg, (None if dv is None else buf[rows:].view(n_seg + 1, nb))


def segment_window_bin_agg_cuda(xs, ys, vals, boundaries, window, bx: int,
                                by: int):
    """Launch ``segment_window_bin_agg`` (TPU original:
    ``repro/kernels/segment_agg.py`` ``segment_window_bin_agg_pallas``).
    Returns float64 ``(S, bx*by, 4)`` on the device."""
    out, _ = launch_segment_window_bin(xs, ys, vals, host_bounds(boundaries),
                                       window, bx, by)
    build.LAUNCHES["segment_window_bin_agg"] += 1
    return out


def segment_window_agg_multi_cuda(xs, ys, vals, boundaries, windows):
    """Launch ``segment_window_agg_multi`` (TPU original:
    ``repro/kernels/segment_agg.py`` ``segment_window_agg_multi_pallas``),
    one kernel a call: segment s under its own ``windows[s]``, rounded to
    float32. Returns float64 ``(S, 4)`` on the device."""
    b = host_bounds(boundaries)
    out = _launch_segment_window(xs, ys, vals, b,
                                 windows_f32(windows, len(b) - 1),
                                 _SWA_MULTI)
    build.LAUNCHES["segment_window_agg_multi"] += 1
    return out


def check_spans(qbounds, n_seg: int) -> np.ndarray:
    """Query spans ``(n_q+1,)`` over the segments (default: one span),
    validated: ``0 = qb[0] <= … <= qb[-1] = S``."""
    qb = (np.array([0, n_seg], np.int64) if qbounds is None
          else np.ascontiguousarray(qbounds, np.int64))
    if qb.ndim != 1 or len(qb) < 2 or qb[0] != 0 or qb[-1] != n_seg \
            or (np.diff(qb) < 0).any():
        raise ValueError("query spans must be a non-decreasing (n_q+1,) "
                         f"vector from 0 to S={n_seg}")
    return qb


def launch_segment_window_bin_multi(xs, ys, vals, b: np.ndarray, windows,
                                    bx: int, by: int, dv=None,
                                    qbounds=None):
    """One launch of the multi-window entry of
    ``csrc/segment_window_bin_agg.cu`` (shared by
    ``segment_window_bin_agg_multi`` and, with the per-segment float64
    widths ``dv`` and the query spans, ``segment_window_bin_select_multi``;
    the callers count their own launches). Arguments are checked before
    the planes. Returns ``(agg (S, bx*by, 4), suffix_w (S, bx*by) or
    None)``: views of one float64 buffer, the suffix rows behind the
    table's."""
    n_seg = len(b) - 1
    nb = bx * by
    if n_seg > MAX_SEGMENTS:
        raise ValueError(f"{n_seg} segments > MAX_SEGMENTS={MAX_SEGMENTS}")
    args = np.zeros(1, _MULTI_ARGS)
    args["w"][0, :n_seg] = bin_params_multi(windows, n_seg, bx, by)
    n_q = 0
    if dv is not None:
        dv = np.ascontiguousarray(dv, np.float64)
        if dv.shape != (n_seg,):
            raise ValueError(f"widths of shape {dv.shape}, want "
                             f"({n_seg},)")
        qb = check_spans(qbounds, n_seg)
        n_q = len(qb) - 1
        if n_q > MAX_SEGMENTS:
            raise ValueError(f"{n_q} query spans > "
                             f"MAX_SEGMENTS={MAX_SEGMENTS}")
        args["dv"][0, :n_seg] = dv
        args["qb"][0, :n_q + 1] = qb
    dev = check_planes(b, xs, ys, vals)
    args["b"][0, :n_seg + 1] = b
    args["i"][0] = (n_seg, bx, by, dv is not None, n_q)
    rows = 4 * n_seg * nb
    buf = torch.empty(rows + (0 if dv is None else n_seg * nb),
                      dtype=torch.float64, device=dev)
    fn = _one_launch("segment_window_bin_agg",
                     "segment_window_bin_agg_multi_launch", _ONE_ARGS)
    _run_one("segment_window_bin_agg", fn, dev, n_seg * nb,
             (xs.data_ptr(), ys.data_ptr(), vals.data_ptr()),
             args.ctypes.data,
             (buf.data_ptr(),
              None if dv is None else buf.data_ptr() + 8 * rows))
    agg = buf[:rows].view(n_seg, nb, 4)
    return agg, (None if dv is None else buf[rows:].view(n_seg, nb))


def segment_window_bin_agg_multi_cuda(xs, ys, vals, boundaries, windows,
                                      bx: int, by: int):
    """Launch ``segment_window_bin_agg_multi`` (TPU original:
    ``repro/kernels/segment_agg.py``
    ``segment_window_bin_agg_multi_pallas``), binning each segment by its
    own window's contract params (the Pallas kernel recomputes the cell
    sizes in float32, ROADMAP C.3). Returns float64 ``(S, bx*by, 4)`` on
    the device."""
    out, _ = launch_segment_window_bin_multi(
        xs, ys, vals, host_bounds(boundaries), windows, bx, by)
    build.LAUNCHES["segment_window_bin_agg_multi"] += 1
    return out
