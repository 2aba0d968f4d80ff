"""Rules the port keeps apart from any behaviour test.

- No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports
  ``jax`` or the reference package ``repro``.
- The entry points run on the card unless asked for the CPU: without
  CUDA they raise instead of running on the CPU.
- Importing the kernel modules needs neither ``nvcc`` nor a GPU, and
  ``chip_smoke.py`` exits non-zero, printing no result, without a card
  or without the repository beside it.
"""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import AccuracyPolicy, AQPEngine, IndexConfig
from repro_torch.data import RawDataset, make_synthetic_dataset

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    for mod in imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_synthetic_dataset(n=1000)
    with pytest.raises(RuntimeError):
        RawDataset(np.zeros(3), np.zeros(3), {"a0": np.zeros(3)})
    ds = make_synthetic_dataset(n=1000, device="cpu")
    with pytest.raises(TypeError):
        AQPEngine(ds)                       # default backend is "cuda"
    with pytest.raises(TypeError):
        AQPEngine(make_synthetic_dataset(n=1000, device=None),
                  IndexConfig(backend="torch"))
    assert AQPEngine(ds, IndexConfig(backend="torch")).index.n_tiles == 256
    # the LM substrate: models, serving state, the launchers, the
    # training loop over a default-device model and the example
    from repro_torch import configs
    from repro_torch.examples import train_lm
    from repro_torch.launch import serve, train
    from repro_torch.models.model import Model, init_params
    from repro_torch.models.serving import init_serve_state
    from repro_torch.optim import OptConfig
    from repro_torch.runtime import TrainLoopConfig, train_loop
    cfg = configs.get_smoke("granite-8b")
    for build in (lambda: Model(cfg), lambda: init_params(cfg),
                  lambda: init_serve_state(cfg, 1, 8),
                  lambda: serve.main(["--arch", "granite-8b", "--smoke"]),
                  lambda: train.main(["--arch", "granite-8b", "--smoke"]),
                  lambda: train_loop(cfg, OptConfig(),
                                     TrainLoopConfig(steps=1), Model(cfg),
                                     lambda step: {}),
                  lambda: train_lm.main([])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    assert init_params(cfg, device="cpu").tok_embed.device.type == "cpu"


def test_sharding_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch,
                                                               tmp_path):
    """The model sharding's entry points — the host mesh, the in-process
    mesh, ``load_for_mesh`` and ``build_step`` on the host mesh — want
    the card by default and raise without one; the production meshes are
    device-free."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.core.mesh import NamedMesh
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import steps
    from repro_torch.runtime.elastic import load_for_mesh
    cfg = configs.get_smoke("granite-8b")
    for build in (lambda: lmesh.make_host_mesh(),
                  lambda: NamedMesh((1, 1), ("data", "model")),
                  lambda: load_for_mesh(str(tmp_path), None, cfg,
                                        NamedMesh((1, 1),
                                                  ("data", "model"))),
                  lambda: steps.build_step(cfg, "train_4k",
                                           lmesh.make_host_mesh())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    assert not dist.is_initialized()
    assert NamedMesh((1, 1), ("data", "model"), "cpu").device.type == "cpu"
    fn, args, _, _ = steps.build_step(cfg, "train_4k",
                                      lmesh.make_production_mesh())
    assert args[0].tok_embed.device.type == "meta"


def test_sharding_modules_import_without_a_device_or_a_group(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path), CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    code = ("import torch.distributed as d, repro_torch.launch.mesh, "
            "repro_torch.launch.steps, repro_torch.models.sharding, "
            "repro_torch.runtime.elastic, repro_torch.launch.hlo_analysis, "
            "repro_torch.launch.dryrun, repro_torch.launch.dryrun_aqp, "
            "repro_torch.launch.perf_cell; "
            "assert not d.is_initialized()")
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)


@pytest.mark.parametrize("device,backend", [(None, "np"), ("cpu", "torch")])
def test_prediction_entry_points_match_reference(device, backend,
                                                 monkeypatch):
    """The prediction entry points — a learned-salience heatmap,
    ``prefetch``, ``serve(prefetch_rows=)`` and a learned-salience
    ticket — answer as the reference's do, with each session's model on
    its dataset's device (the host for host data); a predictor asked for
    nothing else wants the card and raises without one."""
    from repro.core import (AccuracyPolicy as RefPolicy,
                            AQPEngine as RefEngine, IndexConfig as RefConfig)
    from repro.data import make_synthetic_dataset as ref_dataset
    from repro_torch.core import ViewportPredictor

    got = []
    for eng, pol in (
            (RefEngine(ref_dataset(n=5000, seed=2),
                       RefConfig(init_metadata_attrs=("a0",))),
             RefPolicy(salience="learned", eps_abs=0.5)),
            (AQPEngine(make_synthetic_dataset(n=5000, seed=2, device=device),
                       IndexConfig(init_metadata_attrs=("a0",),
                                   backend=backend)),
             AccuracyPolicy(salience="learned", eps_abs=0.5))):
        out = []
        for i in range(3):
            w = (100.0 + 50 * i, 200.0, 500.0 + 50 * i, 600.0)
            r = eng.heatmap(w, "count", "a0", bins=(2, 2), phi=0.05,
                            policy=pol)
            out.append((r.objects_read, r.values.tolist(), r.phi_b.tolist(),
                        eng.prefetch(1000)))
        server = eng.serve(prefetch_rows=1000)
        session = server.open_session("s")
        for i in range(3):
            session.heatmap((300.0 + 40 * i, 300.0, 700.0 + 40 * i, 700.0),
                            "count", "a0", bins=(2, 2), phi=0.05, policy=pol)
            r = server.tick()[0]
            out.append((r.objects_read, r.values.tolist(), r.phi_b.tolist(),
                        server.last_prefetch))
        got.append(out)
        if not isinstance(eng, RefEngine):
            for p in (eng.predictor, session.predictor):
                assert all(t.device.type == "cpu"
                           for t in p._params.values())
    assert got[0] == got[1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((RuntimeError, AssertionError)):
        ViewportPredictor()


def test_kernel_modules_import_without_nvcc_or_gpu(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path), CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    code = ("import repro_torch.kernels.ops, repro_torch.core, "
            "repro_torch.kernels.build as b; "
            "assert not b._LIBS and sum(b.LAUNCHES.values()) == 0")
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_chip_smoke_fails_without_card_or_repo(tmp_path, alone):
    script = ROOT / "chip_smoke.py"
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, str(script)], env=env,
                       capture_output=True, text=True, timeout=120,
                       cwd=tmp_path)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


CORE_FILES = sorted(
    p for d in ("core", "benchmarks", "examples", "launch")
    for p in (ROOT / "src" / "repro_torch" / d).glob("*.py")) + [
    ROOT / "src" / "repro_torch" / "data" / "chunked.py"]
KERNEL_MODULES = ("segment_agg", "fused_select", "bin_agg", "window_agg")
# helpers of the kernel modules that are no kernel's plain version: the
# core may import them (the oracles, the axis-only counts, the split
# ownership rule)
SHARED_HELPERS = {"agg4", "window_bin_ids", "edge_cell_ids", "segment_ids"}


@pytest.mark.parametrize("path", CORE_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_core_reaches_kernels_through_ops(path):
    """No module of ``repro_torch/core``, ``repro_torch/benchmarks``,
    ``repro_torch/examples`` or ``repro_torch/launch`` (nor the chunked
    storage of
    ``repro_torch/data``) imports a plain kernel version
    (a name ending in ``_torch`` from a kernel module) or reaches one as
    an attribute: the core reaches every kernel through ``ops`` with its
    backend, so the card's path runs no plain version."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module.split(".")[-1] in KERNEL_MODULES:
            for a in node.names:
                assert a.name in SHARED_HELPERS \
                    or not a.name.endswith("_torch"), (path.name, a.name)
        if isinstance(node, ast.Attribute):
            assert not node.attr.endswith("_torch"), (path.name, node.attr)


KERNEL_PY = sorted((ROOT / "src" / "repro_torch" / "kernels").glob("*.py"))


def test_kernel_libraries_load_only_in_the_cached_launchers():
    """``build.load`` (which sets a launch function's ctypes ``argtypes``)
    is reached only from the launch-function caches: ``_one_launch``,
    which every keyed kernel's wrapper goes through, and ``window_agg``'s
    own. No wrapper loads its function on every call."""
    found = set()
    for path in KERNEL_PY:
        tree = ast.parse(path.read_text())
        calls = {id(n) for n in ast.walk(tree) if isinstance(n, ast.Call)
                 and isinstance(n.func, ast.Attribute)
                 and n.func.attr == "load"
                 and isinstance(n.func.value, ast.Name)
                 and n.func.value.id == "build"}
        inside = set()
        for fn in ast.walk(tree):
            if isinstance(fn, ast.FunctionDef):
                for n in ast.walk(fn):
                    if id(n) in calls:
                        found.add((path.name, fn.name))
                        inside.add(id(n))
        assert inside == calls, f"{path.name}: build.load at module level"
    assert found == {("segment_agg.py", "_one_launch"),
                     ("window_agg.py", "window_agg_cuda")}
