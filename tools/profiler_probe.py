"""How often ``torch.profiler`` loses a kernel event of a one-launch op.

``tests/test_torch_cuda.py::test_one_launch_kernels_launch_once_a_call``
counts the kernels ``torch.profiler`` records over five calls of a
one-launch op. This probe runs that count many times (``--windows``
profiling windows of ``--calls`` calls each) for a few ops, in three
ways, and prints, for each, how many windows saw a number of the op's
kernels other than ``--calls``, of the two marker kernels (a small
``torch`` op just before the first call and just after the last), and
of the host's kernel-launch records (the CUDA launch API calls the
profiler records on the calling thread: ``--calls`` + 2 expected):

- ``bare``: the test's window as it was — the profiler entered, the
  calls, a synchronise, the profiler left;
- ``accumulate``: the same with ``acc_events=True``;
- ``margins``: the calls kept a few milliseconds away from the
  profiler's start and stop (``--margin-ms``), the card idle then.

A kernel that the profiler drops at the edges of its window shows as a
lost marker under ``bare`` and as nothing lost under ``margins``. Each
window whose counts are off is printed: its device events (name, start
µs, duration µs) and the kernel-launch API calls the profiler recorded
on the host.

    PYTHONPATH=src python tools/profiler_probe.py [--windows 200]
        [--calls 5] [--margin-ms 2]

Needs the card; prints one JSON line, then one a window whose counts
are off.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.kernels import ops

OPS = ("segment_window_agg_multi", "segment_window_agg", "segment_bin_agg")


def planes(seed=17, n_seg=8, rows=20_000):
    """The test's planes (``tests/test_torch_cuda.py:_case``)."""
    rng = np.random.default_rng(seed)
    b = np.arange(0, n_seg * rows + 1, rows, dtype=np.int64)
    x0 = rng.uniform(0, 500, (n_seg, 2))
    bb = np.concatenate([x0, x0 + rng.uniform(10, 300, (n_seg, 2))], 1)
    sid = np.repeat(np.arange(n_seg), rows)
    xs = rng.uniform(bb[sid, 0], bb[sid, 2]).astype(np.float32)
    ys = rng.uniform(bb[sid, 1], bb[sid, 3]).astype(np.float32)
    vals = rng.normal(0, 30, len(xs)).astype(np.float32)
    dev = torch.device("cuda")
    return (*(torch.from_numpy(a).to(dev) for a in (xs, ys, vals)), b, bb)


def op_call(name, xs, ys, vals, b, bb):
    w = (100.3, 100.7, 400.1, 400.9)
    wins = [tuple(float(v) + 0.3 for v in (
        r[0] + 0.25 * (r[2] - r[0]), r[1] + 0.25 * (r[3] - r[1]),
        r[0] + 0.75 * (r[2] - r[0]), r[1] + 0.75 * (r[3] - r[1])))
        for r in bb]
    return {
        "segment_window_agg_multi": lambda: ops.segment_window_agg_multi(
            xs, ys, vals, b, wins, backend="cuda"),
        "segment_window_agg": lambda: ops.segment_window_agg(
            xs, ys, vals, b, w, backend="cuda"),
        "segment_bin_agg": lambda: ops.segment_bin_agg(
            xs, ys, vals, b, bb, gx=4, gy=4, backend="cuda"),
    }[name]


def window(call, marker, calls, how, margin_s, detail):
    """One profiling window: ``(op kernels, marker kernels, launch
    records)`` seen; a window whose counts are off is appended to
    ``detail``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kw = {"acc_events": True} if how == "accumulate" else {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 **kw) as prof:
        if how == "margins":
            time.sleep(margin_s)
        marker.add_(1.0)
        for _ in range(calls):
            call()
        marker.add_(1.0)
        torch.cuda.synchronize()
        if how == "margins":
            time.sleep(margin_s)
    evs = prof.events()
    ks = [e.name for e in evs if e.device_type == DeviceType.CUDA
          and not e.name.lower().startswith(("memset", "memcpy"))]
    mine = [k for k in ks if "at::" not in k]
    launches = [e.name for e in evs if e.device_type == DeviceType.CPU
                and e.name.startswith("cu") and "Launch" in e.name]
    if len(mine) != calls or len(ks) - len(mine) != 2:
        detail.append({
            "how": how, "op_kernels": len(mine),
            "markers": len(ks) - len(mine),
            "device_events": [(e.name[:40], e.time_range.start,
                               e.time_range.elapsed_us()) for e in evs
                              if e.device_type == DeviceType.CUDA],
            "launch_api_events": len(launches),
            "launch_api_names": sorted(set(launches))})
    return len(mine), len(ks) - len(mine), len(launches)


def main(windows=200, calls=5, margin_ms=2.0):
    if not torch.cuda.is_available():
        raise RuntimeError("the profiler probe needs the card")
    xs, ys, vals, b, bb = planes()
    marker = torch.zeros(1, device="cuda")
    out, detail = {}, []
    for name in OPS:
        call = op_call(name, xs, ys, vals, b, bb)
        call()
        torch.cuda.synchronize()
        for how in ("bare", "accumulate", "margins"):
            lost_op = lost_marker = launches_wrong = 0
            for _ in range(windows):
                n_op, n_marker, n_launch = window(call, marker, calls, how,
                                                  margin_ms * 1e-3, detail)
                lost_op += n_op != calls
                lost_marker += n_marker != 2
                launches_wrong += n_launch != calls + 2
            out[f"{name}/{how}"] = {"windows": windows,
                                    "op_count_wrong": lost_op,
                                    "marker_count_wrong": lost_marker,
                                    "launch_count_wrong": launches_wrong}
    print(json.dumps({"profiler_probe": out,
                      "device": torch.cuda.get_device_name(0)}))
    for d in detail:
        print(json.dumps({"window_off": d}))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=int, default=200)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--margin-ms", type=float, default=2.0)
    a = ap.parse_args()
    main(a.windows, a.calls, a.margin_ms)
