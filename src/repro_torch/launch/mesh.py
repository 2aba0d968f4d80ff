"""Production mesh construction (port of ``repro/launch/mesh.py``).

``make_production_mesh`` is a FUNCTION (not a module-level constant) and
returns a device-free ``core.mesh.AbstractMesh``: importing this module
touches no device and starts no process group.

Topology of the reference's production meshes: pods of 256 chips
arranged (data=16, model=16); the multi-pod mesh prepends a ``pod``
axis (2 × 256 = 512 chips). ``model`` is the innermost axis (TP/EP
collectives per layer); ``data`` carries FSDP all-gathers and the
per-step gradient reduce-scatter; ``pod`` only the once-per-step
cross-pod gradient reduction. The specs and abstract step inputs of
those meshes are computed on the abstract mesh (``launch.steps``).

``make_host_mesh`` is the mesh this host has: a ``(data=1, model=world)``
``DeviceMesh`` over the ranks of the ``torch.distributed`` group, one
card a rank (NCCL), or the CPU (gloo) when asked.
"""
from __future__ import annotations

import os
import tempfile

from ..core.mesh import AbstractMesh
from ..data.rawfile import resolve_device


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def make_host_mesh(device="cuda"):
    """A ``(1, world)`` ``DeviceMesh`` named ``("data", "model")`` over the
    initialised process group's ranks. With no group initialised, a group
    of this one rank is made on a file store in a temporary directory
    (NCCL on the card, gloo for ``device="cpu"``). The default
    ``"cuda"`` raises without a card."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    if not dist.is_initialized():
        store = os.path.join(tempfile.mkdtemp(prefix="host_mesh_"), "store")
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"file://{store}",
                                world_size=1, rank=0)
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(dev.type, (1, dist.get_world_size()),
                            mesh_dim_names=("data", "model"))
