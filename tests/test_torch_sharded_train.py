"""The sharded LM path on 8 gloo ranks: one ``torch.multiprocessing``
spawn of a ``(data=2, model=4)`` ``DeviceMesh`` runs every case of
``tests/torch_shard_cases.py`` once (module fixture), and these tests
read rank 0's record.

For granite, deepseek-moe, jamba and rwkv6 (float32 smoke): one
``make_train_step`` with ``grad_shardings`` (granite and deepseek-moe
in 2 microbatches with ``mb_shardings``) — its loss (the sharded loss
of each microbatch, averaged) and
grad_norm within 1e-5 relative, and its first moments (0.1 × the
clipped accumulated gradient) within 1e-4 of each leaf's largest |m|
(a gradient leaf's rule; RWKV's recurrence reaches ~1e-4), of the
port's step in one process; its loss within 1e-4 of the reference's.
"In one process" is the unsharded port for the dense configurations.
The MoE layers under a mesh whose ``model`` axis divides E take the
expert-parallel path, which routes each data shard's tokens at that
shard's capacity and averages the aux loss over the data shards (the
reference's semantics, ``repro/models/moe.py:151-262``): there it is
the port's in-process ``(2,4)`` mesh, and the reference's loss is its
own sharded loss on 8 fake jax devices (a mesh of ``Auto`` axes, built
here) — against the unsharded reference they stay within the
reference's own ``test_model_train_step_8dev_mesh`` tolerance (5e-2).

For starcoder2-3b, starcoder2-15b, whisper-small and gemma-7b (float32
smoke; ROADMAP C.17, C.15c, and C.18's vocab-parallel tied head and
cross entropy): the sharded loss within 1e-5 relative and
every gradient within 1e-4 of its leaf's largest |g| of the plain CPU
path, and the loss within 1e-4 of the reference's sharded loss.

Also: one ``opt_update`` on the DTensor leaves equals the plain one
(1e-6 of each leaf's largest |p|); the ranks' expert-parallel MoE layer
equals the in-process mesh's (1e-6); the ``fsdp_use_hint`` toggle leaves
the sharded loss within 1e-5; a sharded state saved and restored onto
the ranks' mesh by ``load_for_mesh`` equals itself byte for byte on
every rank.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import torch_shard_cases as cases
from repro_torch.core.mesh import NamedMesh
from repro_torch.models.layers import activation_mesh_scope
from repro_torch.models.model import params_from_numpy
from repro_torch.models.moe import moe_ffn_sharded
from repro_torch.optim import OptConfig, init_opt_state, opt_update
from repro_torch.runtime.train_loop import make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOE_ARCHS = ("deepseek-moe-16b", "jamba-1.5-large-398b")
# the reference's sharded loss is computed for these, in one microbatch
REF_ARCHS = MOE_ARCHS + cases.GRAD_ARCHS
REF_MICROBATCHES = {**cases.MICROBATCHES,
                    **{a: 1 for a in cases.GRAD_ARCHS}}

REF_SHARDED = """
    import jax, numpy as np
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding
    from repro import configs
    from repro.models.layers import activation_mesh_scope
    from repro.models.model import loss_fn
    from repro.models.sharding import batch_specs, param_specs

    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    out = {}
    for arch in ARCHS:
        cfg = configs.get_smoke(arch)
        cfg = cfg.__class__(**{**cfg.__dict__, "dtype": "float32"})
        flat = dict(np.load(f"{DIR}/{arch}.npz"))
        tree = {}
        for k, v in flat.items():
            node = tree
            *head, last = k.split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = jnp.asarray(v)
        pshard = jax.tree.map(lambda s: NamedSharding(mesh, s),
                              param_specs(cfg, mesh))
        params = jax.tree.map(jax.device_put, tree, pshard)

        def f(p, b):
            with activation_mesh_scope(mesh):
                return loss_fn(cfg, p, b)[0]
        losses = []
        m = MICROBATCHES[arch]
        for part in range(m):
            n = 4 // m
            b = {k: flat_b[part * n:(part + 1) * n] for k, flat_b in
                 np.load(f"{DIR}/{arch}.batch.npz").items()}
            bs = batch_specs(cfg, mesh, n)
            b = {k: jax.device_put(
                     jnp.asarray(v, jnp.float32 if k == "frames"
                                 else jnp.int32),
                     NamedSharding(mesh, bs[k]))
                 for k, v in b.items()}
            with mesh:
                losses.append(float(jax.jit(f)(params, b)))
        out[arch] = np.mean(losses)
    np.savez(f"{DIR}/ref.npz", **out)
"""


def flat_tree(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat_tree(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.fixture(scope="module")
def record(tmp_path_factory):
    """Rank 0's record of the 8-rank spawn, and the reference's sharded
    losses of the MoE and ``GRAD_ARCHS`` configurations (a subprocess on
    8 fake devices, run beside the spawn)."""
    import torch.multiprocessing as mp
    d = tmp_path_factory.mktemp("sharded")
    for arch in REF_ARCHS:
        cfg = cases.smoke_cfg(arch)
        np.savez(d / f"{arch}.npz", **dict(flat_tree(cases.model_np(cfg))))
        np.savez(d / f"{arch}.batch.npz", **cases.grad_batch_np(cfg))
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"))
    code = f"ARCHS = {REF_ARCHS!r}\nDIR = {str(d)!r}\n" \
        f"MICROBATCHES = {REF_MICROBATCHES!r}\n" + \
        textwrap.dedent(REF_SHARDED)
    ref = subprocess.Popen([sys.executable, "-c", code], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        mp.spawn(cases.rank_main, args=(8, str(d / "store"),
                                        str(d / "rank0.npz")),
                 nprocs=8, join=True)
        _, err = ref.communicate(timeout=420)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, err[-4000:]
    rec = dict(np.load(d / "rank0.npz"))
    rec.update({f"{k}:ref_sharded_loss": v
                for k, v in np.load(d / "ref.npz").items()})
    return rec


def in_one_process(arch):
    """The port's step of ``arch`` in one process: its loss, grad_norm
    and first moments (MoE configurations on the in-process mesh)."""
    cfg = cases.smoke_cfg(arch)
    ocfg = OptConfig(**cases.OPT)
    model = params_from_numpy(cfg, cases.model_np(cfg), "cpu")
    opt = init_opt_state(model, ocfg)
    batch = {k: torch.from_numpy(v) for k, v in cases.batch_np(cfg).items()}
    mesh = NamedMesh(cases.MESH, ("data", "model"), "cpu") \
        if arch in MOE_ARCHS else None
    step = make_train_step(cfg, ocfg, cases.MICROBATCHES[arch])
    if mesh is None:
        _, opt, met = step(model, opt, batch)
    else:
        with activation_mesh_scope(mesh):
            _, opt, met = step(model, opt, batch)
    return met, opt


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def leaf_err(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


@pytest.mark.parametrize("arch", cases.ARCHS)
def test_sharded_step_equals_one_process(record, arch):
    met, opt = in_one_process(arch)
    assert rel(record[f"{arch}:step:loss"], met["loss"]) <= 1e-5
    assert rel(record[f"{arch}:step:grad_norm"], met["grad_norm"]) <= 1e-5
    for n, m in opt["m"].items():
        assert leaf_err(record[f"{arch}:step:m:{n}"], m.numpy()) <= 1e-4, n


def ref_unsharded_loss(arch):
    import jax
    import jax.numpy as jnp
    from repro import configs
    from repro.models.model import loss_fn
    cfg = configs.get_smoke(arch)
    cfg = cfg.__class__(**{**cfg.__dict__, "dtype": "float32"})
    tree = jax.tree.map(jnp.asarray, cases.model_np(cases.smoke_cfg(arch)))
    b = cases.batch_np(cfg)
    m = cases.MICROBATCHES[arch]
    n = 4 // m
    return np.mean([float(jax.jit(lambda p, bb: loss_fn(cfg, p, bb)[0])(
        tree, {k: jnp.asarray(v[h * n:(h + 1) * n], jnp.int32)
               for k, v in b.items()})) for h in range(m)])


@pytest.mark.parametrize("arch", cases.ARCHS)
def test_sharded_loss_equals_reference(record, arch):
    got = record[f"{arch}:step:loss"]
    unsharded = ref_unsharded_loss(arch)
    if arch in MOE_ARCHS:
        assert rel(got, record[f"{arch}:ref_sharded_loss"]) <= 1e-4
        assert rel(got, unsharded) <= 5e-2
    else:
        assert rel(got, unsharded) <= 1e-4


@pytest.mark.parametrize("arch", cases.ARCHS)
def test_opt_update_on_dtensor_leaves_equals_plain(record, arch):
    cfg = cases.smoke_cfg(arch)
    ocfg = OptConfig(**cases.OPT)
    model = params_from_numpy(cfg, cases.model_np(cfg), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in cases.batch_np(cfg).items()}
    _, grads = cases.batch_grads(cfg, model, batch)
    opt_update(model, grads, init_opt_state(model, ocfg), ocfg)
    for n, p in model.named_parameters():
        assert leaf_err(record[f"{arch}:opt:param:{n}"],
                        p.detach().numpy()) <= 1e-6, n


def test_ranks_expert_parallel_equals_in_process(record):
    dims, p, x = cases.moe_case()
    out, aux = moe_ffn_sharded(p, x, dims, NamedMesh(
        cases.MESH, ("data", "model"), "cpu"))
    np.testing.assert_allclose(record["moe:out"], out.detach().numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(record["moe:aux"], float(aux), rtol=1e-6)


def test_fsdp_use_hint_off_keeps_the_sharded_loss(record):
    on = record["granite:loss:fsdp_use_hint=True"]
    off = record["granite:loss:fsdp_use_hint=False"]
    assert rel(off, on) <= 1e-5


def test_sharded_state_restores_on_the_ranks_byte_for_byte(record):
    assert int(record["elastic:equal"][0]) == 1


def plain_grads(arch):
    cfg = cases.smoke_cfg(arch)
    model = params_from_numpy(cfg, cases.model_np(cfg), "cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in cases.grad_batch_np(cfg).items()}
    return cases.batch_grads(cfg, model, batch)


@pytest.mark.parametrize("arch", cases.GRAD_ARCHS)
def test_sharded_gradients_equal_plain(record, arch):
    loss, grads = plain_grads(arch)
    assert rel(record[f"{arch}:grad:loss"], loss) <= 1e-5
    for n, g in grads.items():
        assert leaf_err(record[f"{arch}:grad:{n}"], g.numpy()) <= 1e-4, n


@pytest.mark.parametrize("arch", cases.GRAD_ARCHS)
def test_sharded_gradient_loss_equals_reference(record, arch):
    assert rel(record[f"{arch}:grad:loss"],
               record[f"{arch}:ref_sharded_loss"]) <= 1e-4
