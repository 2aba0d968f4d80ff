"""The port's model sharding against the reference's rules.

- ``param_specs``, ``batch_specs`` and ``serve_state_specs`` equal the
  reference's on the ``(1,1)``, ``(2,4)``, ``(16,16)`` and
  ``(2,16,16)`` meshes for the ten full and ten smoke configurations
  (the reference on ``jax.sharding.AbstractMesh``; a stacked leaf's spec
  without its leading ``None`` is the port's spec of each of its
  superblocks).
- ``build_step``'s abstract inputs (shapes, dtypes) and in/out specs
  equal the reference's on both production meshes, every full
  configuration and every shape ``configs.shapes.supports`` allows.
- ``analyze_cell`` equals the reference's field for field on synthetic
  dry-run records, with the port's hardware constants set to the
  reference's v5e ones.
- The hints are the identity with no mesh bound (and on plain tensors
  under the in-process mesh), and ``OPT`` has the reference's keys and
  defaults.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.steps as ref_steps
import repro.models.model as ref_model
import repro.models.sharding as ref_sh
from repro import configs as ref_configs
from repro.configs.shapes import SHAPES as REF_SHAPES, supports
from repro.models.serving import init_serve_state as ref_serve_state
from repro_torch import configs
from repro_torch.core.mesh import AbstractMesh, NamedMesh
from repro_torch.launch import roofline, steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import layers as L
from repro_torch.models import sharding as SH
from repro_torch.models.serving import init_serve_state

ARCHS = configs.list_archs()
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
VARIANTS = ("full", "smoke")

# the reference rebuilds its abstract parameters in every call; these
# tests ask for the same configurations many times
_ref_abstract = functools.lru_cache(maxsize=None)(ref_model.abstract_params)


@pytest.fixture(autouse=True)
def cached_reference(monkeypatch):
    for mod in (ref_model, ref_sh, ref_steps):
        monkeypatch.setattr(mod, "abstract_params", _ref_abstract)


def cfgs(arch, variant):
    if variant == "full":
        return configs.get(arch), ref_configs.get(arch)
    return configs.get_smoke(arch), ref_configs.get_smoke(arch)


def meshes(name):
    shape, names = MESHES[name]
    return AbstractMesh(shape, names), jax.sharding.AbstractMesh(shape,
                                                                 names)


def ref_leaf(tree, name):
    """The reference tree's leaf for a port name, and whether it is
    stacked (``blocks.<i>.…``, ``encoder.<i>.…``)."""
    parts = name.split(".")
    stacked = parts[0] in ("blocks", "encoder")
    if stacked:
        parts.pop(1)
    for p in parts:
        tree = tree[p]
    return tree, stacked


def unstacked(spec, stacked):
    spec = tuple(spec)
    if stacked:
        assert spec[0] is None, spec
        return spec[1:]
    return spec


def assert_param_specs(got, want_tree):
    assert got, "no parameters"
    n_ref = len(jax.tree.leaves(
        want_tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    seen = set()
    for name, spec in got.items():
        want, stacked = ref_leaf(want_tree, name)
        assert tuple(spec) == unstacked(want, stacked), name
        seen.add(name if not stacked else ".".join(
            p for i, p in enumerate(name.split(".")) if i != 1))
    assert len(seen) == n_ref


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, variant, mesh):
    cfg, rcfg = cfgs(arch, variant)
    pm, rm = meshes(mesh)
    assert_param_specs(SH.param_specs(cfg, pm), ref_sh.param_specs(rcfg, rm))


@pytest.mark.parametrize("mesh", MESHES)
def test_batch_specs_equal_reference(mesh):
    pm, rm = meshes(mesh)
    for arch in ARCHS:
        for variant in VARIANTS:
            cfg, rcfg = cfgs(arch, variant)
            for b in (1, 4, 32, 256):
                got = SH.batch_specs(cfg, pm, b)
                want = ref_sh.batch_specs(rcfg, rm, b)
                assert got.keys() == want.keys()
                for k in got:
                    assert tuple(got[k]) == tuple(want[k]), (arch, b, k)


@functools.lru_cache(maxsize=None)
def ref_state(rcfg, batch, seq):
    return jax.eval_shape(lambda: ref_serve_state(rcfg, batch, seq,
                                                  dtype=jnp.bfloat16))


def assert_state_specs(got, want, path=()):
    """The port's state spec tree (``blocks``/``cross`` lists of
    superblocks) against the reference's (stacked)."""
    if isinstance(got, dict):
        assert got.keys() == want.keys(), path
        for k in got:
            if k in ("blocks", "cross"):
                for sub in got[k]:
                    assert_state_specs(sub, want[k], path + (k, "*"))
            else:
                assert_state_specs(got[k], want[k], path + (k,))
        return
    stacked = "*" in path
    assert tuple(got) == unstacked(want, stacked), path


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_state_specs_equal_reference(arch, variant, mesh):
    cfg, rcfg = cfgs(arch, variant)
    pm, rm = meshes(mesh)
    batch, seq = 32, 16
    state = init_serve_state(cfg, batch, seq, torch.bfloat16, device="meta")
    got = SH.serve_state_specs(cfg, pm, state)
    want = ref_sh.serve_state_specs(rcfg, rm, ref_state(rcfg, batch, seq))
    assert_state_specs(got, want)


def same_struct(t, ref, what):
    assert tuple(t.shape) == tuple(ref.shape), (what, t.shape, ref.shape)
    assert str(t.dtype).replace("torch.", "") == str(np.dtype(ref.dtype)), \
        (what, t.dtype, ref.dtype)
    assert t.device.type == "meta", what


def assert_params_abs(model, ref_tree, what):
    for name, p in model.named_parameters():
        leaf, stacked = ref_leaf(ref_tree, name)
        shape = leaf.shape[1:] if stacked else leaf.shape
        same_struct(p, jax.ShapeDtypeStruct(shape, leaf.dtype),
                    f"{what} {name}")


def assert_state_abs(state, ref, path=()):
    if isinstance(state, dict):
        assert state.keys() == ref.keys(), path
        for k in state:
            if k in ("blocks", "cross"):
                for sub in state[k]:
                    assert_state_abs(sub, ref[k], path + (k, "*"))
            elif k != "pos":
                assert_state_abs(state[k], ref[k], path + (k,))
        return
    shape = ref.shape[1:] if "*" in path else ref.shape
    same_struct(state, jax.ShapeDtypeStruct(shape, ref.dtype), path)


def spec_of(sh):
    return sh.spec if sh is not None else None


CELLS = [(arch, shape, mesh) for arch in ARCHS for shape in REF_SHAPES
         if supports(configs.get(arch), shape)[0]
         for mesh in ("16x16", "2x16x16")]


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_build_step_equals_reference(arch, shape, mesh):
    cfg, rcfg = cfgs(arch, "full")
    pm = make_production_mesh(multi_pod=mesh == "2x16x16")
    assert pm.shape == dict(zip(MESHES[mesh][1], MESHES[mesh][0]))
    _, rm = meshes(mesh)
    fn, args, in_s, out_s = steps.build_step(cfg, shape, pm)
    rfn, rargs, rin, rout = ref_steps.build_step(rcfg, shape, rm)
    assert callable(fn)
    rin = jax.tree.map(spec_of, rin,
                       is_leaf=lambda x: x is None
                       or isinstance(x, jax.sharding.NamedSharding))
    rout = jax.tree.map(spec_of, rout,
                        is_leaf=lambda x: x is None
                        or isinstance(x, jax.sharding.NamedSharding))
    assert_params_abs(args[0], rargs[0], "params")
    assert_param_specs(in_s[0], rin[0])
    if REF_SHAPES[shape].kind == "train":
        assert_param_specs(out_s[0], rout[0])
        opt, ropt = args[1], rargs[1]
        for k in ("m", "v"):
            for name, t in opt[k].items():
                leaf, stacked = ref_leaf(ropt[k], name)
                shape_ = leaf.shape[1:] if stacked else leaf.shape
                same_struct(t, jax.ShapeDtypeStruct(shape_, leaf.dtype),
                            f"opt {k} {name}")
            assert_param_specs(in_s[1][k], rin[1][k])
            assert_param_specs(out_s[1][k], rout[1][k])
        same_struct(opt["step"], ropt["step"], "opt step")
        assert tuple(in_s[1]["step"]) == tuple(rin[1]["step"]) == ()
        assert args[2].keys() == rargs[2].keys() == in_s[2].keys()
        for k in args[2]:
            same_struct(args[2][k], rargs[2][k], f"batch {k}")
            assert tuple(in_s[2][k]) == tuple(rin[2][k]), k
        assert out_s[2] is None and rout[2] is None
        return
    same_struct(args[1], rargs[1], "tokens")
    assert tuple(in_s[1]) == tuple(rin[1])
    assert_state_abs(args[2], rargs[2])
    assert_state_specs(in_s[2], rin[2])
    assert tuple(out_s[0]) == tuple(rout[0])
    assert_state_specs(out_s[1], rout[1])
    if REF_SHAPES[shape].kind == "prefill":
        assert args[3].keys() == rargs[3].keys() == in_s[3].keys()
        for k in args[3]:
            same_struct(args[3][k], rargs[3][k], f"extras {k}")
            assert tuple(in_s[3][k]) == tuple(rin[3][k]), k
    else:
        assert len(args) == len(rargs) == 3


def dryrun_records():
    """Synthetic dry-run records: each term dominant once, a MoE cell, a
    decode cell, an unknown architecture, a skipped and a failed cell."""
    def rec(arch, shape, flops, hbm, coll, devices=256, mem=True):
        r = {"status": "ok", "arch": arch, "shape": shape,
             "mesh": "pod16x16", "devices": devices,
             "hlo_analysis": {"matmul_flops": flops,
                              "hbm_traffic_bytes": hbm,
                              "collective_bytes": coll,
                              "collective_by_type": {
                                  "all-gather": coll * 0.25,
                                  "all-reduce": coll * 0.75}}}
        if mem:
            r["memory"] = {"total_bytes": 3.5 * 2**30}
        return r
    return [rec("granite-8b", "train_4k", 4.1e15, 2.0e12, 1.0e10),
            rec("deepseek_moe_16b", "train_4k", 1.0e14, 9.0e12, 1.0e10),
            rec("jamba-1.5-large-398b", "prefill_32k", 2.0e14, 1.0e12,
                9.0e11, devices=512, mem=False),
            rec("rwkv6-7b", "long_500k", 1.0e9, 4.0e10, 2.0e8),
            rec("gpt-nonesuch", "decode_32k", 1.0e12, 1.0e9, 1.0e6),
            {"status": "skipped", "arch": "granite-8b", "shape": "long_500k",
             "mesh": "pod16x16", "reason": "quadratic"},
            {"status": "error", "arch": "granite-8b", "shape": "train_4k",
             "mesh": "pod16x16"}]


def test_analyze_cell_equals_reference_with_v5e_constants(monkeypatch):
    from repro.launch import roofline as ref_roofline
    for name in ("PEAK", "HBM", "LINK"):
        monkeypatch.setattr(roofline, name, getattr(ref_roofline, name))
    for rec in dryrun_records():
        got, want = roofline.analyze_cell(rec), ref_roofline.analyze_cell(rec)
        if want is None:
            assert got is None
            continue
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_equal(got[k], want[k], err_msg=k)


def test_roofline_constants_are_the_h100s():
    assert (roofline.PEAK, roofline.HBM, roofline.LINK) == \
        (989e12, 3.35e12, 450e9)
    assert roofline.AQP_BW["cuda"] == roofline.HBM


def test_print_table_reads_dryrun_records(tmp_path, capsys):
    import json
    for i, rec in enumerate(dryrun_records()):
        (tmp_path / f"{i}.json").write_text(json.dumps(rec))
    roofline.print_table(str(tmp_path))
    lines = capsys.readouterr().out.splitlines()
    assert "H100 SXM" in lines[0]
    rows = [ln.split(",") for ln in lines[2:]]
    assert [r[:2] for r in rows] == [
        ["granite-8b", "train_4k"], ["deepseek_moe_16b", "train_4k"],
        ["jamba-1.5-large-398b", "prefill_32k"], ["rwkv6-7b", "long_500k"], ["gpt-nonesuch", "decode_32k"],
        ["granite-8b", "long_500k"]]
    assert rows[-1][5].startswith("skipped:")


def test_hints_are_identity_without_mesh():
    from repro.models import layers as ref_layers
    assert L.OPT == ref_layers.OPT
    x = torch.randn(4, 6, 8)
    w = torch.randn(8, 12)
    assert L._ACT_MESH is None
    assert L.shard_hint(x, ("pod", "data"), None, "model") is x
    assert L.fsdp_use(w, None, "model") is w
    assert L._hint_model_dim(x, (1, 2)) is x
    assert L.gathered(torch.add, x, 1.0).equal(x + 1)
    with L.activation_mesh_scope(NamedMesh((2, 4), ("data", "model"),
                                           "cpu")):
        assert L.shard_hint(x, ("pod", "data"), None, "model") is x
        assert L.fsdp_use(w, None, "model") is w
        assert L._hint_model_dim(x, (1, 2)) is x
        assert L._model_axis() == 4
    assert L._ACT_MESH is None and L._model_axis() == 1


def test_named_mesh_views_and_reductions():
    m = NamedMesh((2, 2, 3), ("pod", "data", "model"), "cpu")
    t = torch.arange(4 * 6, dtype=torch.float32).reshape(4, 6)
    spec = (("pod", "data"), "model")
    parts = {c: m.local(t, spec, c) for c in m.coords()}
    assert all(p.untyped_storage().data_ptr()
               == t.untyped_storage().data_ptr() for p in parts.values())
    assert torch.equal(parts[(1, 0, 2)], t[2:3, 4:6])
    summed = m.reduce(parts, "model")
    assert torch.equal(summed[(1, 1, 0)], t[3:4, 0:2] + t[3:4, 2:4]
                       + t[3:4, 4:6])
    mean = m.reduce({c: torch.tensor(float(sum(c))) for c in m.coords()},
                    ("pod", "data"), "mean")
    assert float(mean[(0, 0, 2)]) == 3.0
    assert m.index((1, 1, 2), ("pod", "data")) == (3, 4)
    assert torch.cat([parts[(0, 0, j)] for j in range(3)], 1).equal(t[0:1])
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}
