"""The port's optimizer and gradient compression (``repro_torch.optim``)
against the reference's (``repro.optim``) on the CPU.

Parameters, gradients and moments are numpy arrays fed to both. The
reference's calls are jitted. Tolerances: ``lr_at_step`` and three
successive ``opt_update`` s within 1e-6 relative (XLA and PyTorch may
round a ``pow``, ``cos`` or reduction one ulp apart), a float32 leaf
of parameters or moments within 1e-6 of its largest |value|, since
``p − lr·delta`` and ``b1·m + (1 − b1)·g`` cancel where their terms are
close and a one-ulp difference in a term is then many ulps of the
result; bfloat16 leaves within one bfloat16 ulp, since one
float32 ulp can move a bfloat16 rounding. Inside ``shard_map`` XLA
computes the int8 scale ``max|x| / 127`` as ``max|x| · float32(1/127)``,
one float32 ulp from the port's division (ROADMAP C.14).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from repro.optim import adamw as RADAM
from repro.optim import compression as RCOMP
from repro_torch.core.mesh import ShardMesh
from repro_torch.optim import (OptConfig, init_opt_state, lr_at_step,
                               opt_state_from_numpy, opt_state_to_numpy,
                               opt_update)
from repro_torch.optim.compression import (compressed_psum,
                                           compressed_psum_tree,
                                           dequantize_int8, init_error_state,
                                           quantize_int8)

RTOL = 1e-6


@functools.lru_cache(maxsize=None)
def _ref_update(cfg):
    return jax.jit(functools.partial(RADAM.opt_update, cfg=cfg))


def _module(tree):
    """The port's parameters of a flat numpy tree (names = keys)."""
    return torch.nn.ParameterDict({
        k: torch.nn.Parameter(torch.from_numpy(
            np.asarray(v, np.float32)).to(torch.bfloat16)
            if v.dtype.name == "bfloat16" else torch.from_numpy(v.copy()))
        for k, v in tree.items()})


def _np(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


def _close(got, want, what):
    """float32 leaves within RTOL of the leaf's largest |value|; bfloat16
    leaves within one bfloat16 ulp of the reference's."""
    want_f = np.asarray(want, np.float32)
    if np.asarray(want).dtype.name == "bfloat16":
        ulp = np.spacing(np.abs(want_f).astype(np.float32)) * 2 ** 16
        assert np.all(np.abs(got - want_f) <= ulp), what
    else:
        np.testing.assert_allclose(got, want_f, rtol=0,
                                   atol=RTOL * np.abs(want_f).max(),
                                   err_msg=what)


@pytest.mark.parametrize("cfg", [OptConfig(), OptConfig(
    lr=1e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)],
    ids=["default", "short"])
def test_lr_schedule_matches_reference(cfg):
    rcfg = RADAM.OptConfig(**vars(cfg))
    want = np.asarray(jax.jit(jax.vmap(
        functools.partial(RADAM.lr_at_step, rcfg)))(jnp.arange(121)))
    got = lr_at_step(cfg, torch.arange(121)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    assert got.dtype == np.float32


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_three_updates_match_reference(state_dtype):
    """Three AdamW steps from the same parameters and gradients (the
    second clipped, the bfloat16 parameter too): parameters, moments,
    step, lr and the pre-clip norm."""
    import ml_dtypes
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(0, 1, (16, 8)).astype(np.float32),
              "b": rng.normal(0, 0.1, (40,)).astype(np.float32),
              "w16": rng.normal(0, 1, (8, 8)).astype(ml_dtypes.bfloat16)}
    cfg = OptConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                    state_dtype=state_dtype)
    rcfg = RADAM.OptConfig(**vars(cfg))
    rparams = jax.tree.map(jnp.asarray, params)
    ropt = RADAM.init_opt_state(rparams, rcfg)
    model = _module(params)
    opt = init_opt_state(model, cfg)
    assert {t.dtype for t in opt["m"].values()} == {
        getattr(torch, state_dtype)}
    for i in range(3):
        grads = {k: (rng.normal(0, 30.0 if i == 1 else 0.3, v.shape)
                     ).astype(v.dtype) for k, v in params.items()}
        rparams, ropt, rm = _ref_update(rcfg)(
            rparams, jax.tree.map(jnp.asarray, grads), ropt)
        opt, m = opt_update(model, {
            k: torch.from_numpy(np.asarray(g, np.float32)).to(
                model[k].dtype) for k, g in grads.items()}, opt, cfg)
        for k in params:
            _close(_np(model[k]), rparams[k], f"step {i} param {k}")
            _close(_np(opt["m"][k]), ropt["m"][k], f"step {i} m {k}")
            _close(_np(opt["v"][k]), ropt["v"][k], f"step {i} v {k}")
        assert int(opt["step"]) == int(ropt["step"]) == i + 1
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(rm[key]),
                                       rtol=RTOL, atol=0)
    assert float(m["grad_norm"]) > 0


def test_opt_state_carries_across():
    """``opt_state_to_numpy`` gives the reference's tree (superblocks
    stacked); ``opt_state_from_numpy`` takes it back."""
    from repro import configs as ref_configs
    from repro.models import model as RMODEL
    from repro_torch import configs
    from repro_torch.models.model import init_params, params_to_numpy
    cfg = configs.get_smoke("deepseek-moe-16b")
    model = init_params(cfg, 0, device="cpu")
    ocfg = OptConfig()
    opt = init_opt_state(model, ocfg)
    rng = np.random.default_rng(1)
    for k in ("m", "v"):
        for t in opt[k].values():
            t.copy_(torch.from_numpy(rng.normal(size=t.shape)))
    opt["step"].fill_(5)
    tree = opt_state_to_numpy(opt)
    ref = RADAM.init_opt_state(RMODEL.abstract_params(
        ref_configs.get_smoke("deepseek_moe_16b")), RADAM.OptConfig())
    assert jax.tree.structure(tree) == jax.tree.structure(
        jax.tree.map(np.asarray, ref))
    assert jax.tree.structure(tree["m"]) == jax.tree.structure(
        params_to_numpy(model))
    back = opt_state_from_numpy(model, tree, ocfg)
    for k in ("m", "v"):
        assert back[k].keys() == opt[k].keys()
        for n in opt[k]:
            assert torch.equal(back[k][n], opt[k][n])
    assert back["step"].dtype == torch.int32 and int(back["step"]) == 5


# ------------------------------------------------------------------ #
# the reference's optimizer tests on the port (tests/test_substrate.py)
# ------------------------------------------------------------------ #
def test_adamw_reduces_quadratic_loss():
    cfg = OptConfig(lr=0.1, warmup_steps=0, total_steps=200,
                    weight_decay=0.0, grad_clip=0)
    model = _module({"w": np.asarray([5.0, -3.0, 2.0], np.float32)})
    opt = init_opt_state(model, cfg)
    loss = lambda: torch.sum(torch.square(model["w"]))
    l0 = float(loss().detach())
    for _ in range(100):
        g, = torch.autograd.grad(loss(), [model["w"]])
        opt, _ = opt_update(model, {"w": g}, opt, cfg)
    assert float(loss().detach()) < 1e-2 * l0


def test_lr_schedule_shape():
    cfg = OptConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                    min_lr_frac=0.1)
    lrs = [float(lr_at_step(cfg, s)) for s in range(101)]
    assert lrs[0] == 0.0
    assert abs(lrs[10] - 1e-3) < 1e-9
    assert lrs[100] == pytest.approx(1e-4, rel=1e-3)
    assert all(a >= b - 1e-12 for a, b in zip(lrs[10:], lrs[11:]))


def test_grad_clipping_scales_update():
    cfg = OptConfig(lr=1.0, warmup_steps=0, grad_clip=1.0,
                    weight_decay=0.0)
    model = _module({"w": np.zeros(4, np.float32)})
    opt = init_opt_state(model, cfg)
    _, m = opt_update(model, {"w": torch.full((4,), 1e6)}, opt, cfg)
    assert float(m["grad_norm"]) > 1e5          # the pre-clip norm


def test_bf16_opt_state_dtype():
    cfg = OptConfig(state_dtype="bfloat16")
    model = torch.nn.ParameterDict({"w": torch.nn.Parameter(
        torch.zeros((8, 8), dtype=torch.bfloat16))})
    assert init_opt_state(model, cfg)["m"]["w"].dtype == torch.bfloat16


# ------------------------------------------------------------------ #
# gradient compression
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("scale", [3.0, 1e-3, 0.0])
def test_quantize_int8_equals_reference(scale):
    x = np.random.default_rng(0).normal(0, 1, (256,)).astype(np.float32) \
        * np.float32(scale)
    rq, rs = jax.jit(RCOMP.quantize_int8)(jnp.asarray(x))
    q, s = quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)
    np.testing.assert_array_equal(
        dequantize_int8(q, s).numpy(),
        np.asarray(RCOMP.dequantize_int8(rq, rs)))


def test_int8_quant_roundtrip_error_bounded():
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 3, (256,))
                         .astype(np.float32))
    q, s = quantize_int8(x)
    assert float((dequantize_int8(q, s) - x).abs().max()) \
        <= float(s) / 2 + 1e-6


def test_error_feedback_accumulates_residual():
    """Sum of (transmitted + residual) equals the true running sum."""
    rng = np.random.default_rng(1)
    g_true_sum = np.zeros(64, np.float32)
    sent_sum = np.zeros(64, np.float32)
    err = torch.zeros(64)
    mesh = ShardMesh(1, "cpu")
    for _ in range(20):
        g = torch.from_numpy(rng.normal(0, 1, 64).astype(np.float32))
        sent, (err,) = compressed_psum([g], [err], mesh)
        g_true_sum += g.numpy()
        sent_sum += sent.numpy()
    np.testing.assert_allclose(sent_sum + err.numpy(), g_true_sum,
                               rtol=1e-5, atol=1e-4)


def test_compressed_psum_one_shard_equals_reference():
    mesh = jax.make_mesh((1,), ("pod",))
    rng = np.random.default_rng(2)
    g = rng.normal(0, 1, (8,)).astype(np.float32)
    e = rng.normal(0, 0.01, (8,)).astype(np.float32)
    f = shard_map(lambda g, e: RCOMP.compressed_psum(g, e, "pod"),
                  mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()),
                  check_rep=False)
    rout, rerr = jax.jit(f)(jnp.asarray(g), jnp.asarray(e))
    out, (err,) = compressed_psum([torch.from_numpy(g)],
                                  [torch.from_numpy(e)], ShardMesh(1, "cpu"))
    # the same int8 codes; the scale one float32 ulp apart (C.14)
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), rtol=RTOL,
                               atol=0)
    np.testing.assert_allclose((out + err).numpy(),
                               np.asarray(rout + rerr), rtol=RTOL, atol=0)
    np.testing.assert_allclose(err.numpy(), np.asarray(rerr),
                               atol=RTOL * np.abs(g).max(), rtol=0)


def test_compressed_psum_eight_shards_recovers_the_mean():
    """The reference's multi-device contract
    (``tests/test_distributed.py::test_compressed_psum_multidev``) on 8
    in-process shards: the mean within one quantization scale, and each
    shard's residual what its quantization dropped."""
    rng = np.random.default_rng(0)
    g = rng.normal(0, 1, (8, 64)).astype(np.float32)
    gs = [torch.from_numpy(r) for r in g]
    grads = [{"w": t} for t in gs]
    errs = [init_error_state(d) for d in grads]
    mean, new_errs = compressed_psum_tree(grads, errs, ShardMesh(8, "cpu"))
    scale = np.abs(g).max() / 127
    assert np.abs(mean["w"].numpy() - g.mean(axis=0)).max() <= scale + 1e-5
    for t, e in zip(gs, new_errs):
        q, s = quantize_int8(t)
        np.testing.assert_array_equal(e["w"].numpy(),
                                      (t - dequantize_int8(q, s)).numpy())
