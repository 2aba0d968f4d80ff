"""The port's gradients (``torch.autograd`` of ``models.model.loss_fn``)
against the reference's (``jax.value_and_grad`` of its ``loss_fn``) on
the CPU, for the ten architectures' smoke configurations in float32.

Parameters are drawn by the port and carried to the reference's tree
(``params_to_numpy``); batches are numpy, some labels masked. The
reference's value and gradient are jitted once per architecture.
Tolerances: the loss and its ``ce``/``aux`` terms within 1e-5 (as the
forward tests hold them), and every gradient leaf within 1e-4 of that
leaf's largest |g|: XLA and PyTorch sum in other orders, and a leaf's
small entries carry the rounding of its large ones. In the port,
``remat=True`` (each superblock under ``torch.utils.checkpoint``) gives
the same loss and gradients as ``remat=False``, bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import model as RMODEL
from repro_torch import configs as port_configs
from repro_torch.models import model as PMODEL

ARCHS = ref_configs.list_archs()
B, S = 2, 12
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4


def _inputs(cfg):
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    batch["labels"][1, -4:] = -100                      # masked labels
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(
            size=(B, cfg.vision_patches, cfg.vision_d)).astype(np.float32)
    return batch


def port_grads(cfg, model, batch):
    """The port's loss, metrics and gradients (a dict by parameter name)."""
    names, params = zip(*model.named_parameters())
    loss, met = PMODEL.loss_fn(cfg, model, batch)
    grads = torch.autograd.grad(loss, params)
    return loss.detach(), {k: v.detach() for k, v in met.items()}, \
        dict(zip(names, grads))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    rcfg = dataclasses.replace(ref_configs.get_smoke(arch), dtype="float32")
    pcfg = dataclasses.replace(port_configs.get_smoke(arch),
                               dtype="float32")
    tree = PMODEL.params_to_numpy(PMODEL.init_params(pcfg, 0, device="cpu"))
    model = PMODEL.params_from_numpy(pcfg, tree, "cpu")
    batch = _inputs(rcfg)

    (rloss, rmet), rgrads = jax.jit(jax.value_and_grad(
        lambda p, b: RMODEL.loss_fn(rcfg, p, b), has_aux=True))(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch))

    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    runs = {r: port_grads(dataclasses.replace(pcfg, remat=r), model, tbatch)
            for r in (True, False)}
    loss, met, grads = runs[True]
    for g, w in ((loss, rloss), (met["ce"], rmet["ce"]),
                 (met["aux"], rmet["aux"])):
        assert abs(float(g) - float(w)) <= LOSS_TOL, (float(g), float(w))

    got = PMODEL.stack_named(((n, g.numpy()) for n, g in grads.items()),
                             np.stack)
    assert jax.tree.structure(got) == jax.tree.structure(rgrads)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(rgrads),
                            jax.tree.leaves(got)):
        w = np.asarray(w)
        scale = np.abs(w).max()
        assert scale > 0, path
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_TOL * scale,
                                   err_msg=jax.tree_util.keystr(path))

    rl, rm, rg = runs[False]
    assert torch.equal(rl, loss) and torch.equal(rm["aux"], met["aux"])
    for n in grads:
        assert torch.equal(rg[n], grads[n]), n
