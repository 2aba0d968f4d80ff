"""Multi-pod dry run: every (arch × shape × mesh) cell's step, run once
on fake tensors over a fake process group (port of
``repro/launch/dryrun.py``).

Proves the distribution config is coherent without hardware: for each
cell, ``launch.steps.build_step``'s step runs once under
``FakeTensorMode`` (shapes and dtypes, no data, no device) on the
production meshes

    single-pod:  (data=16, model=16)          — 256 ranks
    multi-pod:   (pod=2, data=16, model=16)   — 512 ranks

each a real ``DeviceMesh`` (``launch.mesh.make_production_mesh``'s
names and sizes) over a ``"fake"`` process group of that world
(``torch.testing._internal.distributed.fake_pg.FakeStore``: this
process is rank 0, and every collective returns at once). Parameters,
optimizer state, batch and serve state are DTensors placed by the rule
tables (``models.sharding``), each rank its own chunk. The step runs
under ``launch.hlo_analysis.StepCounter``, which records the cell's
per-device collective bytes, matmul FLOPs and HBM traffic that
``launch.roofline`` reads.

Each cell writes the reference's record (``arch``, ``shape``, ``mesh``,
``devices``, ``status``, ``compile_s``, ``memory``, ``cost_analysis``,
``hlo_analysis``) to ``<out>/<arch>__<shape>__<mesh>.json``; a cell that
``configs.shapes.supports`` refuses gets its ``skipped`` record. The
port's own estimates stand in for XLA's ``memory_analysis``, per device:

- ``argument_bytes``: the local shards of the step's inputs —
  parameters, optimizer moments and batch (train), parameters, tokens,
  state and extras (serving) — exact;
- ``output_bytes``: the local shards of the step's results (the train
  step updates parameters and moments in place and returns them);
- ``temp_bytes``: the peak of the bytes held at once by the tensors the
  step made (``analyze_step``'s peak of live fake storage);
- ``alias_bytes``: the donated buffers, the reference's donation —
  train arguments 0 and 1 (parameters, moments), serving argument 2
  (the state);
- ``total_bytes`` = argument + temp + output − alias, the reference's sum.

A cell's numbers come as the reference's trip-count correction makes
its own (``measure_cell``): the step runs at 1 and 2 superblocks — and,
where Mamba or RWKV scans run over a sequence, at two scan lengths
(``layers.SCAN_STEPS``) — and each number is extrapolated linearly to
the configuration's depth and sequence. FLOPs, collectives and
arguments come out exact (a superblock and a scan step cost the same
every time); HBM traffic within ~3 % (a 128-step check, rwkv6 smoke);
the peak is an estimate, extrapolated over superblocks only and never
below the runs' own.

``compile_s`` is the seconds to build and run the cell's step.
``cost_analysis`` holds the step's ``flops_static`` and
``bytes_accessed_static``: the port unrolls its loops, so they equal
``hlo_analysis``'s matmul FLOPs and HBM traffic.

A cell that fails (an input spec that does not divide its dimension —
the check ``jax.jit`` makes of its ``in_shardings`` —, an op DTensor
refuses) is a fault of the port, and the run exits nonzero. There is no
rank-count fallback.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        [--archs a,b] [--shapes s1,s2] [--mesh single|multi|both]
        [--out experiments/dryrun_torch] [--smoke] [--mesh-shape 2x4]

``--smoke`` takes the smoke configurations and ``--mesh-shape DxM`` a
``(data=D, model=M)`` mesh instead of the production ones (the tests'
cells); ``--keep-hlo`` is accepted and keeps nothing.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict

import numpy as np
import torch

from .. import configs as cfgreg
from ..configs.shapes import SHAPES, supports
from ..core.mesh import AbstractMesh, axis_names, axis_sizes
from ..models import sharding as SH
from ..models.model import Model
from . import steps as steps_mod
from .hlo_analysis import analyze_step, planning, tensor_bytes
from .mesh import make_production_mesh

OUT = "experiments/dryrun_torch"


def fake_device_mesh(abstract):
    """A ``DeviceMesh`` of ``abstract``'s names and sizes over a
    ``"fake"`` process group of that many ranks (this process rank 0);
    a group of another world is torn down first."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    sizes = axis_sizes(abstract)
    world = int(np.prod(list(sizes.values())))
    if dist.is_initialized() and dist.get_world_size() != world:
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    return init_device_mesh("cpu", tuple(sizes.values()),
                            mesh_dim_names=axis_names(abstract))


def check_spec(name: str, shape, spec, mesh):
    """Raise where ``spec`` cannot place a ``shape`` input on ``mesh``:
    more entries than dims, an axis the mesh lacks or named twice, or a
    dim its axes do not divide."""
    sizes = axis_sizes(mesh)
    if len(spec) > len(shape):
        raise ValueError(f"{name}: spec {spec} has more entries than the "
                         f"{len(shape)} dims of {tuple(shape)}")
    seen = set()
    for dim, ax in zip(shape, spec):
        names = () if ax is None else (ax,) if isinstance(ax, str) \
            else tuple(ax)
        for a in names:
            if a not in sizes or a in seen:
                raise ValueError(f"{name}: spec {spec} names axis {a!r} "
                                 f"{'twice' if a in seen else 'absent'} "
                                 f"on the mesh {sizes}")
            seen.add(a)
        n = int(np.prod([sizes[a] for a in names])) if names else 1
        if dim % n:
            raise ValueError(f"{name}: spec {spec} implies that dim of "
                             f"size {dim} of {tuple(shape)} divides by "
                             f"{n}")


@contextlib.contextmanager
def strided_sizes_on_host():
    """DTensor sizes a ``_StridedShard`` (a dim sharded over two mesh
    axes in turn, which its cost model meets when it weighs a
    reshape's redistribution) by splitting a ``torch.arange`` of the dim
    and reading the pieces' lengths, which a fake tensor cannot give.
    Within this context that arithmetic runs on real host tensors,
    outside ``FakeTensorMode``; it is planning, not the step's work, and
    ``StepCounter`` leaves it out."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor.placement_types import _StridedShard
    orig = _StridedShard.local_shard_size_and_offset

    def on_host(self, *args, **kwargs):
        with unset_fake_temporarily(), planning():
            return orig(self, *args, **kwargs)
    _StridedShard.local_shard_size_and_offset = on_host
    try:
        yield
    finally:
        _StridedShard.local_shard_size_and_offset = orig


def _placed(name, like, spec, mesh):
    """A zero fake tensor like ``like`` (a ``meta`` tensor), distributed
    by ``spec`` on ``mesh``."""
    check_spec(name, like.shape, spec, mesh)
    t = torch.zeros(like.shape, dtype=like.dtype, device="cpu")
    return SH.distribute(t, mesh, SH.placements(spec, mesh))


def _tree(name, like, specs, mesh):
    if isinstance(like, dict):
        return {k: _tree(f"{name}.{k}", v, specs[k], mesh)
                for k, v in like.items()}
    if isinstance(like, list):
        return [_tree(f"{name}[{i}]", v, s, mesh)
                for i, (v, s) in enumerate(zip(like, specs))]
    if not isinstance(like, torch.Tensor):
        return like
    return _placed(name, like, specs, mesh)


def _model(cfg, pspecs, mesh):
    model = Model(cfg, "cpu")
    for n, p in model.named_parameters():
        check_spec(n, p.shape, pspecs[n], mesh)
    return SH.distribute_params(model, mesh, {
        n: SH.placements(s, mesh) for n, s in pspecs.items()})


def placed_args(cfg, kind: str, args, in_specs, mesh):
    """The step's inputs as fake DTensors placed by ``in_specs``
    (``build_step``'s abstract ``args``), under an active
    ``FakeTensorMode``."""
    model = _model(cfg, in_specs[0], mesh)
    if kind == "train":
        _, opt_abs, batch_abs = args
        opt = {k: _tree(k, opt_abs[k], in_specs[1][k], mesh)
               for k in ("m", "v")}
        opt["step"] = torch.zeros((), dtype=torch.int32)
        return (model, opt, _tree("batch", batch_abs, in_specs[2], mesh))
    rest = (_tree("tokens", args[1], in_specs[1], mesh),
            _tree("state", args[2], in_specs[2], mesh))
    if kind == "prefill":
        rest += (_tree("extras", args[3], in_specs[3], mesh),)
    return (model,) + rest


def local_bytes(tree) -> int:
    from ..models.layers import is_dtensor
    if isinstance(tree, torch.nn.Module):
        return sum(local_bytes(p) for p in tree.parameters())
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tensor_bytes(tree.to_local() if is_dtensor(tree) else tree)
    return 0


K1, K2 = 16, 32      # the scans' two trip counts (multiples of CHUNK)


def _measure(cfg, shape_name: str, mesh, size_of) -> Dict[str, Any]:
    """One run of the cell's step: its numbers, flat (the memory
    estimates and the Analysis)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    kind = SHAPES[shape_name].kind
    fn, args, in_specs, _ = steps_mod.build_step(cfg, shape_name, mesh,
                                                 size_of=size_of)
    donate = (0, 1) if kind == "train" else (2,)
    with FakeTensorMode(allow_non_fake_inputs=True), \
            strided_sizes_on_host():
        real = placed_args(cfg, kind, args, in_specs, mesh)
        arg_bytes = [local_bytes(a) for a in real]
        out, ana, peak = analyze_step(fn, *real)
        out_bytes = local_bytes(out)
    del out, real
    nums = {"argument_bytes": sum(arg_bytes), "output_bytes": out_bytes,
            "temp_bytes": peak,
            "alias_bytes": sum(arg_bytes[i] for i in donate)}
    nums.update({k: v for k, v in ana.to_dict().items()
                 if k != "trip_counts"})
    return nums


def _comb(*terms):
    """Σ coef · numbers over ``(coef, numbers)`` terms, the numbers
    nested dicts (a missing key is 0)."""
    if any(isinstance(t, dict) for _, t in terms):
        keys = dict.fromkeys(k for _, t in terms for k in t)
        return {k: _comb(*((c, t.get(k, 0)) for c, t in terms))
                for k in keys}
    return sum(c * t for c, t in terms)


def _cut(cfg, blocks: int):
    """``cfg`` with ``blocks`` superblocks (whisper: as many encoder
    layers)."""
    kw = {"n_layers": cfg.n_head_layers + blocks * cfg.super_period}
    if cfg.encoder_layers:
        kw["encoder_layers"] = blocks
    return dataclasses.replace(cfg, **kw)


def measure_cell(cfg, shape_name: str, mesh) -> Dict[str, Any]:
    """The cell's numbers at full depth and sequence, by the reference's
    trip-count rule. A superblock costs the same at every depth, and a
    Mamba or RWKV scan step (``layers.SCAN_STEPS``) the same at every
    step. So the step runs at 1 and 2 superblocks, and each number is
    extrapolated linearly to ``n_super``; with scans over a sequence of
    ``seq`` steps, the runs take K1 steps, a third run takes 2
    superblocks at K2 steps, and a number is ``base + n_super ·
    per(seq)`` with per-block ``per`` linear in the steps. The peak
    (``temp_bytes``) is extrapolated over superblocks only (at K1 steps
    with scans: a peak is no sum over steps) and never taken below a
    peak measured: an estimate.
    Whisper's encoder has as many layers as its decoder's superblocks
    and is cut with them."""
    from ..models import layers as L
    n = cfg.n_super
    shape = SHAPES[shape_name]
    scans = cfg.mixer in ("rwkv", "mamba_hybrid") and \
        shape.kind != "decode" and shape.seq > K2
    if cfg.encoder_layers and cfg.encoder_layers != n:
        raise ValueError(f"{cfg.name}: {cfg.encoder_layers} encoder layers "
                         f"for {n} superblocks: no trip count")

    def run(blocks, steps=None):
        L.SCAN_STEPS = steps
        try:
            return _measure(_cut(cfg, blocks), shape_name, mesh, cfg)
        finally:
            L.SCAN_STEPS = None
    if not scans and n <= 2:
        return run(n)
    if not scans:
        c11, c21 = run(1), run(2)
        out = _comb((2 - n, c11), (n - 1, c21))
    else:
        t = (shape.seq - K1) / (K2 - K1)
        c11, c21, c22 = run(1, K1), run(2, K1), run(2, K2)
        # base = 2·c11 − c21; per(K1) = c21 − c11; per(K2) = (c22 − base)/2
        out = _comb((2 - n, c11), (n * (1 - t / 2) - 1, c21),
                    (n * t / 2, c22))
    # a peak is no sum over steps: over superblocks only (at K1 steps),
    # and never below a peak measured
    out["temp_bytes"] = max(_comb((2 - n, c11["temp_bytes"]),
                                  (n - 1, c21["temp_bytes"])),
                            c11["temp_bytes"], c21["temp_bytes"])
    return out


def run_cell(cfg, shape_name: str, mesh, mesh_name: str,
             out_dir: str) -> Dict[str, Any]:
    """Measure one cell on ``mesh`` (a ``DeviceMesh``), write its record,
    and return it."""
    t0 = time.time()
    nums = measure_cell(cfg, shape_name, mesh)
    t1 = time.time()
    mem = {k: int(round(nums[k])) for k in ("argument_bytes",
                                            "output_bytes", "temp_bytes",
                                            "alias_bytes")}
    mem["total_bytes"] = mem["argument_bytes"] + mem["temp_bytes"] + \
        mem["output_bytes"] - mem["alias_bytes"]
    ana = {"collective_bytes": float(nums["collective_bytes"]),
           "collective_by_type": {k: float(v) for k, v in
                                  nums["collective_by_type"].items()},
           "collective_count": int(round(nums["collective_count"])),
           "matmul_flops": float(nums["matmul_flops"]),
           "hbm_traffic_bytes": float(nums["hbm_traffic_bytes"]),
           "trip_counts": {}}
    rec = {
        "arch": cfg.name, "shape": shape_name, "mesh": mesh_name,
        "devices": int(mesh.size()),
        "status": "ok", "compile_s": round(t1 - t0, 2),
        "memory": mem,
        "cost_analysis": {
            "flops_static": ana["matmul_flops"],
            "bytes_accessed_static": ana["hbm_traffic_bytes"],
        },
        "hlo_analysis": ana,
    }
    _write(out_dir, rec)
    return rec


def _write(out_dir: str, rec: Dict[str, Any]):
    os.makedirs(out_dir, exist_ok=True)
    base = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}"
    with open(os.path.join(out_dir, base + ".json"), "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default="all")
    ap.add_argument("--shapes", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--keep-hlo", action="store_true",
                    help="accepted for the reference's CLI; the port "
                    "makes no HLO, so nothing is kept")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke configurations (on the same meshes)")
    ap.add_argument("--mesh-shape", default=None,
                    help="DxM: a (data=D, model=M) mesh instead of the "
                    "production meshes (named meshDxM)")
    args = ap.parse_args(argv)
    if args.keep_hlo:
        print("[note] --keep-hlo: the port makes no HLO; nothing is kept")

    get = cfgreg.get_smoke if args.smoke else cfgreg.get
    archs = cfgreg.list_archs() if args.archs == "all" \
        else [a.strip() for a in args.archs.split(",")]
    shapes = list(SHAPES) if args.shapes == "all" \
        else [s.strip() for s in args.shapes.split(",")]
    if args.mesh_shape:
        d, m = (int(v) for v in args.mesh_shape.lower().split("x"))
        meshes = [(f"mesh{d}x{m}", AbstractMesh((d, m), ("data", "model")))]
    else:
        meshes = [("pod2x16x16" if multi else "pod16x16",
                   make_production_mesh(multi_pod=multi))
                  for multi in {"single": [False], "multi": [True],
                                "both": [False, True]}[args.mesh]]

    failures, rows = [], []
    for mesh_name, abstract in meshes:
        mesh = fake_device_mesh(abstract)
        for arch in archs:
            cfg = get(arch)
            for shape_name in shapes:
                ok, reason = supports(cfg, shape_name)
                cell = f"{cfg.name} × {shape_name} × {mesh_name}"
                if not ok:
                    rows.append({"arch": cfg.name, "shape": shape_name,
                                 "mesh": mesh_name, "status": "skipped",
                                 "reason": reason})
                    _write(args.out, rows[-1])
                    print(f"[skip] {cell}: {reason}")
                    continue
                try:
                    rec = run_cell(cfg, shape_name, mesh, mesh_name,
                                   args.out)
                    rows.append(rec)
                    mb = rec["memory"]["total_bytes"] / 2**30
                    coll = rec["hlo_analysis"]["collective_bytes"] / 2**20
                    print(f"[ok]   {cell}: {mb:.2f} GiB/dev, "
                          f"compile {rec['compile_s']}s, "
                          f"coll {coll:.1f} MiB/dev", flush=True)
                except Exception as e:  # noqa: BLE001
                    failures.append((cell, e))
                    print(f"[FAIL] {cell}: {e}", flush=True)
                    traceback.print_exc()

    print(f"\n{len(rows)} cells processed, {len(failures)} failures")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
