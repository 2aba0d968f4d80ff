"""Expert parallelism (``moe_ffn_sharded``) on the in-process mesh against
the reference.

- The ``(1,1)`` mesh against the reference's ``_moe_ffn_local`` (its
  ``tests/test_models_smoke.py`` case): within 1e-5.
- The ``(2,4)`` mesh against the reference's ``moe_ffn_sharded`` on 8
  fake jax devices (its ``tests/test_distributed.py`` case, in a
  subprocess: XLA fixes the device count at first use): ``out`` within
  2e-4, ``aux`` within 1e-5.
- Gradients through the expert-parallel path against the local path, in
  the no-drop regime, on 2- and 3-axis meshes: within 1e-4 of each
  leaf's largest |g|.
- ``moe_ffn``'s dispatch follows the bound mesh as the reference's does.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as REF
from repro_torch.core.mesh import NamedMesh
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_moe(ref_params, d, dims):
    p = MOE.MoE(d, dims, torch.float32, "cpu")
    with torch.no_grad():
        for n, t in p.named_parameters():
            t.copy_(torch.from_numpy(np.asarray(ref_params[n])))
    return p


def port_dims(ref_dims):
    return MOE.MoEDims(**{f: getattr(ref_dims, f) for f in (
        "n_experts", "top_k", "d_expert", "n_shared", "capacity_factor",
        "mlp_kind")})


def test_one_by_one_mesh_equals_reference_local():
    dims = REF.MoEDims(n_experts=4, top_k=2, d_expert=32, n_shared=1)
    params = REF.init_moe(jax.random.key(0), 16, dims, jnp.float32)
    x = jax.random.normal(jax.random.key(1), (2, 8, 16), jnp.float32)
    want, want_aux = REF._moe_ffn_local(params, x, dims)
    p = port_moe(params, 16, port_dims(dims))
    out, aux = MOE.moe_ffn_sharded(
        p, torch.from_numpy(np.asarray(x)), port_dims(dims),
        NamedMesh((1, 1), ("data", "model"), "cpu"))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


REF8 = """
    import jax, numpy as np
    import jax.numpy as jnp
    from repro.models import moe as MOE

    dims = MOE.MoEDims(n_experts=8, top_k=2, d_expert=32, n_shared=1,
                       capacity_factor=8.0)
    params = MOE.init_moe(jax.random.key(0), 16, dims, jnp.float32)
    x = jax.random.normal(jax.random.key(1), (4, 8, 16), jnp.float32)
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    out, aux = MOE.moe_ffn_sharded(params, x, dims, mesh)
    np.savez(OUT, x=np.asarray(x), out=np.asarray(out),
             aux=np.asarray(aux), **{k: np.asarray(v)
                                     for k, v in params.items()})
"""


def test_two_by_four_mesh_equals_reference_on_eight_devices(tmp_path):
    path = str(tmp_path / "ref8.npz")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"))
    code = f"OUT = {path!r}\n" + textwrap.dedent(REF8)
    p = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-4000:]
    ref = dict(np.load(path))
    dims = MOE.MoEDims(n_experts=8, top_k=2, d_expert=32, n_shared=1,
                       capacity_factor=8.0)
    moe = port_moe(ref, 16, dims)
    out, aux = MOE.moe_ffn_sharded(moe, torch.from_numpy(ref["x"]), dims,
                                   NamedMesh((2, 4), ("data", "model"),
                                             "cpu"))
    np.testing.assert_allclose(out.detach().numpy(), ref["out"], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(float(aux), float(ref["aux"]), rtol=1e-5)


def leafwise(got, want):
    return max(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
               for g, w in zip(got, want))


@pytest.mark.parametrize("shape,names", [
    ((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
    ((4, 2), ("data", "model")), ((1, 8), ("data", "model")),
    ((2, 2, 2), ("pod", "data", "model"))],
    ids=["1x1", "2x4", "4x2", "1x8", "2x2x2"])
def test_expert_parallel_gradients_equal_local(shape, names):
    dims = MOE.MoEDims(n_experts=8, top_k=2, d_expert=32, n_shared=1,
                       capacity_factor=8.0, mlp_kind="swiglu")
    p = MOE.init_moe(16, dims, torch.float32, device="cpu",
                     gen=torch.Generator().manual_seed(4))
    x0 = torch.from_numpy(np.random.default_rng(5).normal(
        size=(4, 8, 16)).astype(np.float32))
    r = torch.from_numpy(np.random.default_rng(6).normal(
        size=(4, 8, 16)).astype(np.float32))
    params = list(p.parameters())
    grads = []
    for mesh in (None, NamedMesh(shape, names, "cpu")):
        x = x0.clone().requires_grad_(True)
        out, aux = MOE._moe_ffn_local(p, x, dims) if mesh is None \
            else MOE.moe_ffn_sharded(p, x, dims, mesh)
        grads.append(torch.autograd.grad((out * r).sum(), [x] + params,
                                         retain_graph=True))
        if mesh is not None:
            # aux differentiates too (the router's gradient)
            g_aux = torch.autograd.grad(aux, p.router)[0]
            assert torch.isfinite(g_aux).all() and g_aux.abs().sum() > 0
    assert leafwise(grads[1], grads[0]) <= 1e-4


@pytest.mark.parametrize("shape,sharded", [
    ((2, 4), True), ((1, 8), True), ((4, 1), False), ((2, 3), False)])
def test_moe_ffn_dispatch_follows_the_bound_mesh(shape, sharded,
                                                 monkeypatch):
    dims = MOE.MoEDims(n_experts=8, top_k=2, d_expert=8)
    p = MOE.init_moe(16, dims, torch.float32, device="cpu",
                     gen=torch.Generator().manual_seed(0))
    calls = []
    real = MOE.moe_ffn_sharded
    monkeypatch.setattr(MOE, "moe_ffn_sharded",
                        lambda *a: calls.append(1) or real(*a))
    x = torch.randn(4, 4, 16)
    MOE.moe_ffn(p, x, dims)
    assert not calls
    with L.activation_mesh_scope(NamedMesh(shape, ("data", "model"),
                                           "cpu")):
        MOE.moe_ffn(p, x, dims)
    assert bool(calls) == sharded
