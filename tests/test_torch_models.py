"""The port's LM layers and mixers (``repro_torch.models``) against the
reference's (``repro.models``) on the CPU.

Inputs come from numpy seeds; parameters are drawn by the reference and
copied into the port's modules. Every reference call is jitted once per
module (the ``ref`` fixture). Tolerances: float32 outputs within
``rtol = atol = 2e-5`` (XLA and PyTorch sum in other orders, and their
``tanh``/``exp`` differ in the last bits, ROADMAP C.10); bfloat16 norm
outputs within one bfloat16 ulp (``rtol = 2**-7``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import layers as RL
from repro.models import mamba as RM
from repro.models import model as RMODEL
from repro.models import moe as RMOE
from repro.models import rwkv6 as RR
from repro_torch import configs as port_configs
from repro_torch.models import layers as PL
from repro_torch.models import mamba as PM
from repro_torch.models import model as PMODEL
from repro_torch.models import moe as PMOE
from repro_torch.models import rwkv6 as PR

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


@pytest.fixture(scope="module")
def ref():
    """The reference's layer functions, each jitted once."""
    return {
        "attn": jax.jit(RL.attention, static_argnames=(
            "dims", "causal", "chunked", "use_rope")),
        "mlp": jax.jit(RL.mlp, static_argnames=("kind",)),
        "moe": jax.jit(RMOE._moe_ffn_local, static_argnames=("dims",)),
        "mamba": jax.jit(RM.mamba_block, static_argnames=("dims",)),
        "tmix": jax.jit(RR.rwkv_tmix, static_argnames=("dims",)),
        "cmix": jax.jit(RR.rwkv_cmix),
    }


def _load(module, tree):
    """Copy a reference parameter dict into one of the port's modules."""
    names = {n for n, _ in module.named_parameters()}
    assert names == set(tree), (names, set(tree))
    for name, p in module.named_parameters():
        p.copy_(PMODEL.to_torch(np.asarray(tree[name])))
    return module


def _np(a):
    return np.asarray(a, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), _np(want), **(tol or TOL))


# ------------------------------------------------------------------ #
# norms and RoPE
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", ["rms", "layer", "group"])
def test_norms(norm, dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(2.0, 3.0, (2, 5, 48)).astype(np.float32)
    w = rng.normal(1.0, 0.2, 48).astype(np.float32)
    b = rng.normal(0.0, 0.2, 48).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    tx = _t(x).to(getattr(torch, dtype))
    if norm == "rms":
        want = jax.jit(RL.rms_norm)(jx, w)
        got = PL.rms_norm(tx, _t(w))
    elif norm == "layer":
        want = jax.jit(RL.layer_norm)(jx, w, b)
        got = PL.layer_norm(tx, _t(w), _t(b))
    else:
        want = jax.jit(RL.group_norm_heads, static_argnums=3)(jx, w, b, 4)
        got = PL.group_norm_heads(tx, _t(w), _t(b), 4)
    assert got.dtype == tx.dtype
    if dtype == "float32":
        _close(got, want, rtol=1e-6, atol=1e-6)
    else:
        _close(got, want, rtol=2 ** -7, atol=0)


@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_rope(theta):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 7, 16)).astype(np.float32)
    pos = np.arange(1000, 1007)
    want = jax.jit(RL.apply_rope, static_argnums=2)(
        jnp.asarray(x), jnp.asarray(pos), theta)
    got = PL.apply_rope(_t(x), _t(pos), theta)
    _close(got, want)


# ------------------------------------------------------------------ #
# attention, each route at its threshold
# ------------------------------------------------------------------ #
DIMS = RL.AttnDims(4, 2, 8)
PDIMS = PL.AttnDims(4, 2, 8)


def _attn_params(d=16, seed=3):
    p = RL.init_attention(jax.random.key(seed), d, DIMS, jnp.float32)
    tree = jax.tree.map(np.asarray, p)
    return p, _load(PL.Attention(d, PDIMS, torch.float32, "cpu"), tree)


def _routes(monkeypatch):
    """Count the port's attention routes."""
    calls = {}
    for name in ("_gqa_scores_full", "_gqa_decode", "chunked_attention"):
        fn = getattr(PL, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(PL, name, counted)
    return calls


# no cache: s * t > 2**22 switches the full matrix to chunks
@pytest.mark.parametrize("s,route", [(2048, "_gqa_scores_full"),
                                     (2049, "chunked_attention")])
def test_attention_without_cache(ref, monkeypatch, s, route):
    rp, pp = _attn_params()
    x = np.random.default_rng(4).normal(size=(1, s, 16)).astype(np.float32)
    want, _ = ref["attn"](rp, jnp.asarray(x), DIMS,
                          positions=jnp.arange(s), causal=True,
                          chunked=None)
    calls = _routes(monkeypatch)
    got, cache = PL.attention(pp, _t(x), PDIMS, positions=torch.arange(s),
                              causal=True, chunked=None)
    assert calls == {route: 1} and cache is None
    _close(got, want)


# a cache: a block of s <= 8 takes the masked full-cache pass, more the
# chunked pass with q_chunk = max(8, s)
@pytest.mark.parametrize("s,route", [(1, "_gqa_decode"), (8, "_gqa_decode"),
                                     (9, "chunked_attention")])
def test_attention_with_cache(ref, monkeypatch, s, route):
    rp, pp = _attn_params()
    rng = np.random.default_rng(5)
    x0 = rng.normal(size=(2, 5, 16)).astype(np.float32)
    x1 = rng.normal(size=(2, s, 16)).astype(np.float32)
    t = 24
    rc = RL.init_cache(2, DIMS, t, jnp.float32)
    pc = PL.init_cache(2, PDIMS, t, torch.float32, device="cpu")
    _, rc = ref["attn"](rp, jnp.asarray(x0), DIMS, positions=jnp.arange(5),
                        cache=rc, cache_pos=0)
    PL.attention(pp, _t(x0), PDIMS, positions=torch.arange(5), cache=pc,
                 cache_pos=0)
    want, rc = ref["attn"](rp, jnp.asarray(x1), DIMS,
                           positions=5 + jnp.arange(s), cache=rc,
                           cache_pos=5)
    calls = _routes(monkeypatch)
    got, pc = PL.attention(pp, _t(x1), PDIMS,
                           positions=5 + torch.arange(s), cache=pc,
                           cache_pos=5)
    assert calls == {route: 1}
    _close(got, want)
    _close(pc["k"], rc["k"])
    _close(pc["v"], rc["v"])


def test_cache_overflow_raises():
    """The port refuses a block that runs past the cache's end; the
    reference's ``dynamic_update_slice`` would clamp it (ROADMAP C.11),
    so the reference is not driven there."""
    _, pp = _attn_params()
    cache = PL.init_cache(1, PDIMS, 4, torch.float32, device="cpu")
    x = torch.zeros((1, 2, 16))
    PL.attention(pp, x, PDIMS, positions=torch.arange(2, 4), cache=cache,
                 cache_pos=2)
    with pytest.raises(ValueError, match="overflow"):
        PL.attention(pp, x, PDIMS, positions=torch.arange(3, 5),
                     cache=cache, cache_pos=3)


# ------------------------------------------------------------------ #
# MLPs and MoE
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp(ref, kind):
    p = RL.init_mlp(jax.random.key(6), 16, 40, kind, jnp.float32)
    pp = _load(PL.init_mlp(16, 40, kind, torch.float32, device="cpu"),
               jax.tree.map(np.asarray, p))
    x = np.random.default_rng(7).normal(size=(2, 5, 16)).astype(np.float32)
    _close(PL.mlp(pp, _t(x), kind), ref["mlp"](p, jnp.asarray(x), kind))


@pytest.mark.parametrize("kind,n_shared", [("swiglu", 2), ("gelu", 0)])
def test_moe_local_with_overflow(ref, kind, n_shared):
    """The sort-based dispatch and the aux loss, with a router biased to
    expert 0 so that its assignments overflow the capacity."""
    dims = RMOE.MoEDims(n_experts=4, top_k=2, d_expert=24,
                        n_shared=n_shared, mlp_kind=kind)
    p = RMOE.init_moe(jax.random.key(8), 16, dims, jnp.float32)
    tree = jax.tree.map(np.asarray, p)
    rng = np.random.default_rng(9)
    x = (rng.normal(size=(2, 32, 16)) + 1.0).astype(np.float32)
    tree["router"] = tree["router"].copy()
    tree["router"][:, 0] += 0.5
    p = jax.tree.map(jnp.asarray, tree)
    probs = jax.nn.softmax(jnp.asarray(x.reshape(-1, 16)) @ p["router"])
    top = np.asarray(jax.lax.top_k(probs, 2)[1])
    assert np.bincount(top.ravel(), minlength=4).max() \
        > RMOE.capacity(64, dims)                     # some are dropped
    want, want_aux = ref["moe"](p, jnp.asarray(x), dims)
    pp = _load(PMOE.init_moe(16, PMOE.MoEDims(**dataclasses.asdict(dims)),
                             torch.float32, device="cpu"), tree)
    got, aux = PMOE._moe_ffn_local(pp, _t(x), PMOE.MoEDims(
        **dataclasses.asdict(dims)))
    _close(got, want)
    assert abs(float(aux) - float(want_aux)) <= 1e-6


# ------------------------------------------------------------------ #
# the scans at s = 64 (the reference's chunked form without state)
# ------------------------------------------------------------------ #
def _state_pair(ref_state):
    tree = jax.tree.map(np.asarray, ref_state)
    return ref_state, jax.tree.map(lambda a: _t(a), tree)


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_block(ref, with_state):
    d = 16
    dims = RM.mamba_dims(d, d_state=8)
    p = RM.init_mamba(jax.random.key(10), d, dims, jnp.float32)
    pp = _load(PM.Mamba(d, PM.MambaDims(**dataclasses.asdict(dims)),
                        torch.float32, "cpu"), jax.tree.map(np.asarray, p))
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 64, d)).astype(np.float32)
    rs = ps = None
    if with_state:
        rs, ps = _state_pair({
            "conv": jnp.asarray(rng.normal(size=(2, 3, dims.d_inner)),
                                jnp.float32),
            "h": jnp.asarray(rng.normal(size=(2, dims.d_inner, 8)),
                             jnp.float32)})
    want, wst = ref["mamba"](p, jnp.asarray(x), dims, state=rs)
    got, gst = PM.mamba_block(pp, _t(x), PM.MambaDims(
        **dataclasses.asdict(dims)), state=ps)
    _close(got, want)
    if with_state:
        _close(gst["conv"], wst["conv"])
        _close(gst["h"], wst["h"])
    else:
        assert gst is None and wst is None


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv_tmix_and_cmix(ref, with_state):
    d = 32
    dims = RR.RWKVDims(n_heads=2, head_size=16, d_ff=48, lora_r=8)
    pdims = PR.RWKVDims(**dataclasses.asdict(dims))
    pt = RR.init_rwkv_tmix(jax.random.key(12), d, dims, jnp.float32)
    pc = RR.init_rwkv_cmix(jax.random.key(13), d, dims, jnp.float32)
    ppt = _load(PR.RWKVTmix(d, pdims, torch.float32, "cpu"),
                jax.tree.map(np.asarray, pt))
    ppc = _load(PR.RWKVCmix(d, pdims, torch.float32, "cpu"),
                jax.tree.map(np.asarray, pc))
    rng = np.random.default_rng(14)
    x = rng.normal(size=(2, 64, d)).astype(np.float32)
    rs = ps = rshift = pshift = None
    if with_state:
        rs, ps = _state_pair({
            "shift": jnp.asarray(rng.normal(size=(2, d)), jnp.float32),
            "S": jnp.asarray(rng.normal(size=(2, 2, 16, 16)), jnp.float32)})
        rshift = jnp.asarray(rng.normal(size=(2, d)), jnp.float32)
        pshift = _t(np.asarray(rshift))
    want, wst = ref["tmix"](pt, jnp.asarray(x), dims, state=rs)
    got, gst = PR.rwkv_tmix(ppt, _t(x), pdims, state=ps)
    _close(got, want)
    wc, wcs = ref["cmix"](pc, jnp.asarray(x), state=rshift)
    gc, gcs = PR.rwkv_cmix(ppc, _t(x), state=pshift)
    _close(gc, wc)
    if with_state:
        _close(gst["S"], wst["S"], rtol=1e-4, atol=1e-4)
        _close(gst["shift"], wst["shift"])
        _close(gcs, wcs)
    else:
        assert gst is None and wst is None and gcs is None


# ------------------------------------------------------------------ #
# the ten full configurations
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("arch", ref_configs.list_archs())
def test_full_config_param_counts(arch, monkeypatch):
    """The port's configurations are the reference's, field for field,
    and its counts, taken on the meta device, equal the reference's
    (whose two counts share one traced ``abstract_params``)."""
    monkeypatch.setattr(RMODEL, "abstract_params",
                        functools.lru_cache(RMODEL.abstract_params))
    rcfg, pcfg = ref_configs.get(arch), port_configs.get(arch)
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(pcfg)
    assert dataclasses.asdict(ref_configs.get_smoke(arch)) == \
        dataclasses.asdict(port_configs.get_smoke(arch))
    total = RMODEL.param_count(rcfg)
    assert PMODEL.param_count(pcfg) == total
    # the reference's active count is its total without experts
    assert PMODEL.active_param_count(pcfg) == (
        RMODEL.active_param_count(rcfg) if rcfg.n_experts else total)
