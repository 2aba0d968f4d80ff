"""The port's checkpoints (``repro_torch.checkpoint``) on the CPU: the
reference's format, its crash and keep-k behaviour, and checkpoints that
cross between the packages with equal keys, dtypes and bytes."""
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.checkpoint import load_checkpoint as ref_load
from repro.checkpoint import save_checkpoint as ref_save
from repro.models import model as RMODEL
from repro.optim import adamw as RADAM
from repro_torch import configs
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    load_checkpoint, save_checkpoint)
from repro_torch.models.model import params_from_numpy
from repro_torch.optim import OptConfig, opt_state_from_numpy
from repro_torch.runtime.train_loop import train_state_tree


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((16, 8), generator=g),
            "b": {"c": torch.randn((4,), generator=g).to(torch.bfloat16),
                  "step": torch.tensor(7, dtype=torch.int32)},
            "l": [torch.arange(3, dtype=torch.int64)]}


def _leaves(tree):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _assert_same(got, want):
    for a, b in zip(_leaves(got), _leaves(want), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 42, t, meta={"note": "x"})
    restored, step, meta = load_checkpoint(str(tmp_path), t)
    assert step == 42 and meta["note"] == "x"
    _assert_same(restored, t)


def test_checkpoint_shape_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    bad = _tree()
    bad["a"] = torch.zeros((8, 16))
    with pytest.raises(ValueError, match="a: checkpoint shape"):
        load_checkpoint(str(tmp_path), bad)


def test_checkpoint_atomicity_partial_write(tmp_path):
    """A crashed writer's ``.tmp`` directory is invisible to readers and
    removed by the next save."""
    t = _tree()
    save_checkpoint(str(tmp_path), 1, t)
    crash = os.path.join(str(tmp_path), "step_00000002.tmp")
    os.makedirs(crash)
    with open(os.path.join(crash, "arrays.npz"), "wb") as f:
        f.write(b"garbage")
    assert latest_step(str(tmp_path)) == 1
    save_checkpoint(str(tmp_path), 3, t)
    assert not os.path.exists(crash)
    assert latest_step(str(tmp_path)) == 3


def test_checkpoint_manager_async_keep_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    for s in (10, 20, 30, 40):
        mgr.save(s, t)
    mgr.wait()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("step_"))
    assert steps == [30, 40] and mgr.last_saved == 40


def test_manager_save_survives_in_place_update(tmp_path):
    """The manager copies the tree before its thread writes: an in-place
    update right after ``save`` does not reach the checkpoint."""
    t = _tree()
    want = {k: v.clone() for k, v in t.items() if k == "a"}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, t)
    t["a"].add_(1.0)
    t["b"]["c"].zero_()
    mgr.wait()
    restored, _, _ = load_checkpoint(str(tmp_path), t)
    assert torch.equal(restored["a"], want["a"])
    assert torch.equal(restored["b"]["c"], _tree()["b"]["c"])


def _reference_state():
    """The reference's ``(params, opt_state)`` of granite's smoke
    configuration (bfloat16 parameters, float32 moments) after one
    update, so no moment is zero."""
    cfg = ref_configs.get_smoke("granite_8b")
    params = jax.jit(lambda k: RMODEL.init_params(cfg, k))(
        jax.random.key(0))
    ocfg = RADAM.OptConfig()
    opt = RADAM.init_opt_state(params, ocfg)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype)
                         * (1 + jnp.arange(p.size).reshape(p.shape)
                            % 7).astype(p.dtype), params)
    _, opt, _ = jax.jit(lambda p, g, o: RADAM.opt_update(p, g, o, ocfg))(
        params, grads, opt)
    return cfg, params, opt


def _raw(base, step):
    d = os.path.join(base, f"step_{step:08d}")
    with np.load(os.path.join(d, "arrays.npz")) as z:
        return {k: z[k].tobytes() for k in z.files}


def test_checkpoints_cross_between_packages(tmp_path):
    """The same ``(params, opt_state)`` saved by each package: equal
    manifests and equal bytes per key; each package loads the other's
    with equal keys, dtypes and bytes."""
    cfg, params, opt = _reference_state()
    np_params = jax.tree.map(np.asarray, params)
    model = params_from_numpy(configs.get_smoke("granite-8b"), np_params,
                              "cpu")
    popt = opt_state_from_numpy(model, jax.tree.map(np.asarray, opt),
                                OptConfig())
    tree = train_state_tree(model, popt)
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_save(ref_dir, 3, (params, opt), meta={"model": cfg.name})
    save_checkpoint(port_dir, 3, tree, meta={"model": cfg.name})

    import json
    manifests = [json.load(open(os.path.join(d, "step_00000003",
                                             "manifest.json")))
                 for d in (ref_dir, port_dir)]
    assert manifests[0] == manifests[1]
    assert "0/blocks/s0/attn/wq" in manifests[0]["leaves"]
    assert manifests[0]["leaves"]["1/step"] == {"dtype": "int32",
                                                "shape": []}
    assert manifests[0]["leaves"]["0/tok_embed"]["dtype"] == "bfloat16"
    assert _raw(ref_dir, 3) == _raw(port_dir, 3)

    # the port loads the reference's checkpoint ...
    got, step, meta = load_checkpoint(ref_dir, train_state_tree(
        model, popt, "meta"))
    assert step == 3 and meta == {"model": cfg.name}
    _assert_same(got, tree)
    # ... and the reference loads the port's
    rgot, _, _ = ref_load(port_dir, (params, opt))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(
            (params, opt)), jax.tree.leaves(rgot), strict=True):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    assert any(np.asarray(l).dtype == ml_dtypes.bfloat16
               for l in jax.tree.leaves(rgot))
