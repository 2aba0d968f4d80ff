"""Dry run of the paper's technique on the production mesh (port of
``repro/launch/dryrun_aqp.py``): the SPMD session engine's two programs
— the scalar selection step over the persistent ``ShardedTileState``
(``core.distributed.make_session_query_step``) and the bin-aligned
sharded refine epoch (``make_refine_epoch``, ``bins=(8, 8)``) — run once
on fake tensors for 256 and 512 ranks, ``DistConfig(grid=(64, 64),
capacity=8192)``, 10⁶ objects a rank.

Each rank count is a ``"fake"`` process group of that world
(``launch.dryrun.fake_device_mesh``), and the engine's mesh is
``core.mesh.ProcessGroupMesh`` over it: this process is rank 0, holds
its own shard of the objects and of ``cell``, and reduces with
``all_reduce``, which returns at once on the fake group. The programs
run under ``FakeTensorMode`` (with a ``ShapeEnv``: a ``nonzero`` has a
size that depends on the data, counted at its upper bound, every
object of the shard) and
``launch.hlo_analysis.StepCounter``; each writes the reference's record
(``experiments/dryrun_torch/aqp_query__objects_1000000per_dev__pod16x16.json``
and so on), with ``memory`` estimated as ``launch.dryrun`` estimates it
(no buffer is donated).

    PYTHONPATH=src python -m repro_torch.launch.dryrun_aqp [--ranks 256,512]
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict

import torch

from ..core.distributed import (DistConfig, ShardedTileState,
                                make_refine_epoch, make_session_query_step)
from ..core.mesh import AbstractMesh, ProcessGroupMesh
from .dryrun import OUT, local_bytes, fake_device_mesh
from .hlo_analysis import analyze_step
from .mesh import make_production_mesh

WINDOW = (0.1, 0.2, 0.6, 0.7)
PHI = 0.05


def _mesh_name(world: int) -> str:
    return {256: "pod16x16", 512: "pod2x16x16"}.get(world, f"ranks{world}")


def _abstract(world: int):
    if world in (256, 512):
        return make_production_mesh(multi_pod=world == 512)
    return AbstractMesh((world,), ("data",))


def run(world: int = 256, n_per_dev: int = 1_000_000,
        out_dir: str = OUT) -> Dict[str, Any]:
    """Both programs on a fake group of ``world`` ranks, ``n_per_dev``
    objects a rank: their records, keyed by name."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.symbolic_shapes import ShapeEnv
    fake_device_mesh(_abstract(world))
    mesh = ProcessGroupMesh("cpu")
    assert mesh.n_shards == world, (mesh.n_shards, world)
    cap = 8192
    cfg = DistConfig(grid=(64, 64), capacity=cap)
    step = make_session_query_step(mesh, cfg)
    epoch = make_refine_epoch(mesh, cfg, bins=(8, 8))
    mesh_name = _mesh_name(world)
    recs = {}
    with FakeTensorMode(shape_env=ShapeEnv(), allow_non_fake_inputs=True):
        def f32(*s):
            return torch.zeros(s, dtype=torch.float32)
        state = ShardedTileState(
            cell=torch.zeros(n_per_dev, dtype=torch.int32),
            bbox=f32(cap, 4), active=torch.zeros(cap, dtype=torch.bool),
            level=torch.zeros(cap, dtype=torch.int32),
            count=torch.zeros(cap, dtype=torch.int64), vmin=f32(cap),
            vmax=f32(cap), n_tiles=torch.zeros((), dtype=torch.int64))
        obj = (f32(n_per_dev), f32(n_per_dev), f32(n_per_dev))
        sel = torch.zeros(cap, dtype=torch.bool)
        for name, fn, args in (
                ("aqp_query", step, (state,) + obj + (WINDOW, PHI)),
                ("aqp_refine", epoch, (state,) + obj + (WINDOW, sel))):
            t0 = time.time()
            out, ana, peak = analyze_step(fn, *args)
            arg_bytes = local_bytes([a for a in args
                                      if isinstance(a, torch.Tensor)]
                                     + list(state))
            mem = {"argument_bytes": int(arg_bytes),
                   "output_bytes": int(local_bytes(out)),
                   "temp_bytes": int(peak), "alias_bytes": 0}
            mem["total_bytes"] = mem["argument_bytes"] + \
                mem["temp_bytes"] + mem["output_bytes"]
            rec = {
                "arch": name, "shape": f"objects_{n_per_dev}per_dev",
                "mesh": mesh_name, "devices": world, "status": "ok",
                "compile_s": round(time.time() - t0, 2),
                "memory": mem, "cost_analysis": {},
                "hlo_analysis": ana.to_dict(),
            }
            os.makedirs(out_dir, exist_ok=True)
            base = f"{name}__{rec['shape']}__{mesh_name}"
            with open(os.path.join(out_dir, base + ".json"), "w") as f:
                json.dump(rec, f, indent=1)
            kib = {k: round(v / 2**10, 1)
                   for k, v in ana.collective_by_type.items()}
            print(f"[ok] {name} × {mesh_name}: "
                  f"{mem['total_bytes'] / 2**30:.2f} GiB/dev, "
                  f"coll {ana.collective_bytes / 2**20:.2f} MiB/dev "
                  f"{kib} KiB", flush=True)
            recs[name] = rec
    return recs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", default="256,512")
    ap.add_argument("--objects-per-rank", type=int, default=1_000_000)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    for world in (int(w) for w in args.ranks.split(",")):
        run(world, args.objects_per_rank, args.out)


if __name__ == "__main__":
    main()
