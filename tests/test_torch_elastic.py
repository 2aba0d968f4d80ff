"""Elastic restore (``runtime.elastic``) and ``load_checkpoint``'s
``shardings``: checkpoints hold logical arrays, so a state saved under
one mesh restores onto another.

- The port's state (granite smoke: bfloat16 parameters, float32 moments
  after a step) saved, then restored with ``load_for_mesh`` onto the
  in-process ``(1,1)`` and ``(2,4)`` meshes: every leaf equal byte for
  byte, each under its own name. (On a ``DeviceMesh`` of 8 gloo ranks:
  ``tests/test_torch_sharded_train.py``.)
- A reference checkpoint restores onto a port mesh byte for byte.
- The reference's ``test_elastic_reshard_roundtrip`` case, on the port.
"""
import jax
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.core.mesh import AbstractMesh, NamedMesh
from repro_torch.models import sharding as SH
from repro_torch.models.model import (abstract_params, host_numpy,
                                      init_params, params_from_numpy,
                                      stack_named, unstack_named)
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.runtime.elastic import _stacked_specs, load_for_mesh, \
    reshard_tree
from repro_torch.runtime.train_loop import make_train_step, train_state_tree

INTS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def same_bytes(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(INTS[a.element_size()]),
        b.contiguous().view(INTS[b.element_size()]))


def stepped_state():
    cfg = configs.get_smoke("granite-8b")
    ocfg = OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    model = init_params(cfg, 0, device="cpu")
    opt = init_opt_state(model, ocfg)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16)))
             for k in ("tokens", "labels")}
    make_train_step(cfg, ocfg, 2)(model, opt, batch)
    return cfg, ocfg, model, opt


def template(cfg, ocfg):
    meta = abstract_params(cfg)
    return train_state_tree(meta, init_opt_state(meta, ocfg), "meta")


@pytest.mark.parametrize("shape", [(1, 1), (2, 4)], ids=["1x1", "2x4"])
def test_saved_state_restores_onto_a_mesh_byte_for_byte(tmp_path, shape):
    cfg, ocfg, model, opt = stepped_state()
    save_checkpoint(str(tmp_path), 7, train_state_tree(model, opt),
                    meta={"model": cfg.name})
    mesh = NamedMesh(shape, ("data", "model"), "cpu")
    params, moments, step, meta = load_for_mesh(
        str(tmp_path), template(cfg, ocfg), cfg, mesh)
    assert step == 7 and meta == {"model": cfg.name}
    assert int(moments["step"]) == int(opt["step"]) == 1
    names = [n for n, _ in model.named_parameters()]
    assert list(params) == names
    for n, p in model.named_parameters():
        assert same_bytes(params[n], p.detach()), n
        for k in ("m", "v"):
            assert same_bytes(moments[k][n], opt[k][n]), (k, n)
    # the restored parameters make the same model
    again = params_from_numpy(cfg, stack_named(
        ((n, host_numpy(params[n])) for n in names), np.stack), "cpu")
    for a, b in zip(again.parameters(), model.parameters()):
        assert same_bytes(a.detach(), b.detach())


def test_reference_checkpoint_restores_onto_a_port_mesh(tmp_path):
    from repro import configs as ref_configs
    from repro.checkpoint import save_checkpoint as ref_save
    from repro.models.model import init_params as ref_init
    from repro.optim import OptConfig as RefOpt, init_opt_state as ref_opt
    cfg = configs.get_smoke("deepseek-moe-16b")
    rcfg = ref_configs.get_smoke("deepseek-moe-16b")
    params = ref_init(rcfg, jax.random.key(3))
    opt = ref_opt(params, RefOpt())
    # moments that are not zeros: the parameters, halved and squared
    opt = {"m": jax.tree.map(lambda p: p.astype(np.float32) * 0.5, params),
           "v": jax.tree.map(lambda p: p.astype(np.float32) ** 2, params),
           "step": opt["step"] + 5}
    ref_save(str(tmp_path), 11, (params, opt), meta={"from": "reference"})
    mesh = NamedMesh((2, 4), ("data", "model"), "cpu")
    got, moments, step, meta = load_for_mesh(
        str(tmp_path), template(cfg, OptConfig()), cfg, mesh)
    assert step == 11 and meta == {"from": "reference"}
    assert int(moments["step"]) == 5
    names = list(got)
    for tree, mine in ((params, got), (opt["m"], moments["m"]),
                       (opt["v"], moments["v"])):
        want = unstack_named(jax.tree.map(np.asarray, tree), names)
        for n in names:
            w = want[n]
            if w.dtype.name == "bfloat16":
                assert mine[n].dtype == torch.bfloat16, n
                assert np.array_equal(mine[n].view(torch.int16).numpy(),
                                      w.view(np.int16)), n
            else:
                assert np.array_equal(mine[n].numpy(), w), n


def test_elastic_reshard_roundtrip(tmp_path):
    """The reference's ``tests/test_substrate.py`` case: save under one
    mesh, restore under another."""
    cfg = configs.get_smoke("granite_8b")
    model = init_params(cfg, 0, device="cpu")
    params = stack_named((n, p.detach()) for n, p in
                         model.named_parameters())
    save_checkpoint(str(tmp_path), 5, params)
    mesh = NamedMesh((1, 1), ("data", "model"), "cpu")
    restored, _, _ = load_checkpoint(str(tmp_path), params)
    names = [n for n, _ in model.named_parameters()]
    specs = _stacked_specs(names, SH.param_specs(cfg, mesh))
    resharded = reshard_tree(restored, mesh, specs)
    flat = dict(jax.tree_util.tree_leaves_with_path(params))
    for path, leaf in jax.tree_util.tree_leaves_with_path(resharded):
        np.testing.assert_array_equal(leaf.float().numpy(),
                                      flat[path].float().numpy())
    with pytest.raises(TypeError):
        SH.NamedSharding(AbstractMesh((1, 1), ("data", "model")),
                         SH.P()).place(torch.zeros(()))


def test_a_corrupted_checkpoint_raises(tmp_path):
    """A byte flipped in a stored member fails the member's CRC-32."""
    tree = {"w": torch.arange(4096, dtype=torch.float32)}
    save_checkpoint(str(tmp_path), 1, tree)
    path = tmp_path / "step_00000001" / "arrays.npz"
    data = bytearray(path.read_bytes())
    data[len(data) // 3] ^= 0xFF
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        load_checkpoint(str(tmp_path), tree)
