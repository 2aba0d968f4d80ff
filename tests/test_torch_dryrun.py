"""The port's dry runs and its ``Analysis`` of a step
(``repro_torch.launch.{hlo_analysis,dryrun,dryrun_aqp,perf_cell}``).

Every program that needs a process group runs in a subprocess (a module
fixture starts them together, ~20-40 s), so that the pytest worker's
process group stays clean:

- the reference's two ``tests/test_hlo_analysis.py`` programs, counted
  by the port's ``StepCounter``: the 11-step ``tanh(h @ w)`` loop gives
  ``2·4·32·32·11`` FLOPs, equal to the reference's ``analyze_hlo`` of
  the same compiled scan within 1 % (in this process, no group); and on
  a 2-rank fake group an all-gather outside a 5-step loop and an
  all-reduce inside it give the golden test's bytes and FLOPs. One
  sharded product counts 1/TP of the unsharded one;
- the CLI on three smoke cells: starcoder2-3b's train cell (6 heads on a
  16-way model axis: ROADMAP C.17's guard) on the single-pod mesh, and
  granite-8b's decode cell and gemma-7b's train cell on a ``(2, 4)``
  mesh. Each record has the reference's keys and ``status`` "ok",
  ``roofline.analyze_cell`` reads it, and its matmul FLOPs × devices lie
  within 5 % of the count the step's products must make
  (``expected_flops``: the work split over every device, ROADMAP C.18);
- the reference's dry run of the same three cells
  (``tools/reference_dryrun.py``: XLA's fake CPU devices, ``Auto``
  axes, in one subprocess beside the others): the port's matmul FLOPs a
  device within 10 % of the reference's, cell by cell;
- the loss on a ``(2, 4)`` mesh (gemma-7b smoke, tied head): no
  collective moves a tensor of the logits' (B, S, V) elements, and the
  loss's own are the (B, S) reductions (ROADMAP C.18);
- the peak rule (``dryrun.peak_rule``): for a training, a prefill (with
  RWKV scans) and a decode cell at 4 superblocks, the estimate from 1-3
  superblocks equals a direct run at 4 within 1 %;
- a spec forced not to divide its dim makes the CLI exit nonzero;
- ``perf_cell.measure`` with ``fsdp_use_hint`` off, the toggle restored;
- the AQP dry run on a fake group of 8 ranks.
"""
import json
import math
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import roofline
from repro_torch.launch.hlo_analysis import analyze_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"arch", "shape", "mesh", "devices", "status", "compile_s",
        "memory", "cost_analysis", "hlo_analysis"}
MEM_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
            "total_bytes"}
ANA_KEYS = {"collective_bytes", "collective_by_type", "collective_count",
            "matmul_flops", "hbm_traffic_bytes", "trip_counts"}

GOLDEN = """
    import json, torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.hlo_analysis import analyze_step
    from repro_torch.launch.perf_cell import measure
    from repro_torch.launch.dryrun_aqp import run
    from repro_torch.models import layers as L

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=2)
    out = {}
    F, g = torch.ops._c10d_functional, dist.group.WORLD.group_name
    mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    with FakeTensorMode():
        x, w = torch.zeros(8, 16), torch.zeros(16, 32)

        def prog(x, w):
            wg = F.wait_tensor(F.all_gather_into_tensor(w, 2, g))[:16]
            for _ in range(5):
                d = F.wait_tensor(F.all_reduce(x @ wg, "sum", g))
            return d
        _, a, _ = analyze_step(prog, x, w)
        out["golden"] = a.to_dict()
        a_, b_ = torch.zeros(64, 128), torch.zeros(128, 256)
        _, whole, _ = analyze_step(lambda: a_ @ b_)
        A = distribute_tensor(a_, mesh, (Replicate(), Replicate()),
                              src_data_rank=None)
        B = distribute_tensor(b_, mesh, (Replicate(), Shard(1)),
                              src_data_rank=None)
        _, shard, _ = analyze_step(lambda: A @ B)
        out["tp"] = [whole.matmul_flops, shard.matmul_flops]
    dist.destroy_process_group()
    before = dict(L.OPT)
    out["perf"] = measure("granite-8b", "decode_32k", off=("fsdp_use_hint",),
                          smoke=True)
    out["opt_restored"] = L.OPT == before
    out["aqp"] = run(8, 4096, OUT)
    print(json.dumps(out))
"""

MISMATCH = """
    from repro_torch.launch import dryrun
    from repro_torch.models import sharding as SH
    batch_specs = SH.batch_specs

    def forced(cfg, mesh, b):    # tokens' length 1 sharded 4 ways
        return {k: SH.P(None, "model", *v[2:])
                for k, v in batch_specs(cfg, mesh, b).items()}
    SH.batch_specs = forced
    dryrun.main(["--smoke", "--archs", "granite-8b", "--shapes",
                 "decode_32k", "--mesh-shape", "2x4", "--out", OUT])
"""


LOSS = """
    import collections, json
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.core.mesh import AbstractMesh
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.hlo_analysis import StepCounter

    mesh = dryrun.fake_device_mesh(AbstractMesh((2, 4), ("data", "model")))
    cfg = dryrun._cut(configs.get_smoke("gemma-7b"), 1)
    cell = ShapeCell("loss", "train", 64, 8)
    fn, args, specs, _ = steps.build_step(cfg, cell, mesh, microbatches=1)
    with FakeTensorMode(allow_non_fake_inputs=True), \\
            dryrun.strided_sizes_on_host():
        real = dryrun.placed_args(cfg, "train", args, specs, mesh)
        counter = StepCounter()
        with counter:
            fn(*real)
    print(json.dumps({"vocab": cfg.vocab, "shapes": counter.coll_shapes}))
"""

PEAKS = """
    import json
    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.core.mesh import AbstractMesh
    from repro_torch.launch import dryrun
    from repro_torch.models import layers as L

    mesh = dryrun.fake_device_mesh(AbstractMesh((2, 4), ("data", "model")))
    out = {}
    for arch, shape, mb, scans in (
            ("granite-8b", ShapeCell("train", "train", 256, 16), 2, False),
            ("rwkv6-7b", "prefill_32k", None, True),
            ("granite-8b", "decode_32k", None, False)):
        cfg = dryrun._cut(configs.get_smoke(arch), 4)
        est = dryrun.measure_cell(cfg, shape, mesh, microbatches=mb)
        L.SCAN_STEPS = dryrun.K1 if scans else None
        direct = dryrun._measure(cfg, shape, mesh, cfg, mb)["temp_bytes"]
        L.SCAN_STEPS = None
        out[arch + ":" + dryrun.steps_mod.shape_of(shape).kind] = [
            est["temp_bytes"], est["temp_bytes_1_2"], direct]
    print(json.dumps(out))
"""

REFERENCE = """
    import runpy
    tool = runpy.run_path(TOOL)["main"]
    tool(["--smoke", "--archs", "starcoder2-3b", "--shapes", "train_4k",
          "--mesh", "single", "--out", OUT])
    for arch, shape in (("granite-8b", "decode_32k"),
                        ("gemma-7b", "train_4k")):
        tool(["--smoke", "--archs", arch, "--shapes", shape,
              "--mesh-shape", "2x4", "--out", OUT])
"""


def _py(code, out):
    tool = os.path.join(ROOT, "tools", "reference_dryrun.py")
    return [sys.executable, "-c", f"OUT = {str(out)!r}\nTOOL = {tool!r}\n"
            + textwrap.dedent(code)]


def _cli(out, *args):
    return [sys.executable, "-m", "repro_torch.launch.dryrun", "--smoke",
            "--out", str(out), *args]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    cmds = {
        "train": _cli(d / "train", "--archs", "starcoder2-3b", "--shapes",
                      "train_4k", "--mesh", "single"),
        "decode": _cli(d / "decode", "--archs", "granite-8b", "--shapes",
                       "decode_32k", "--mesh-shape", "2x4"),
        "gemma": _cli(d / "gemma", "--archs", "gemma-7b", "--shapes",
                      "train_4k", "--mesh-shape", "2x4"),
        "golden": _py(GOLDEN, d / "aqp"),
        "loss": _py(LOSS, d / "loss"),
        "peaks": _py(PEAKS, d / "peaks"),
        "mismatch": _py(MISMATCH, d / "mismatch"),
        "reference": _py(REFERENCE, d / "reference"),
    }
    jax_env = dict(env, JAX_PLATFORMS="cpu")
    procs = {k: subprocess.Popen(c, env=jax_env if k == "reference" else env,
                                 cwd=str(d),
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, c in cmds.items()}
    out = {}
    try:
        for k, p in procs.items():
            so, se = p.communicate(timeout=400)
            out[k] = (p.returncode, so, se)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    out["dir"] = d
    return out


def _record(runs, name, fname):
    rc, so, se = runs[name]
    assert rc == 0, (so[-2000:], se[-4000:])
    with open(runs["dir"] / name / fname) as f:
        return json.load(f)


def _golden(runs):
    rc, so, se = runs["golden"]
    assert rc == 0, se[-4000:]
    return json.loads(so.strip().splitlines()[-1])


def test_scan_flops_equal_the_reference_hlo_count():
    import jax
    import jax.numpy as jnp

    from repro.launch.hlo_analysis import analyze_hlo

    def f(w, x):
        def body(h, _):
            return jnp.tanh(h @ w), None
        h, _ = jax.lax.scan(body, x, None, length=11)
        return h.sum()
    ref = analyze_hlo(jax.jit(f).lower(
        jax.ShapeDtypeStruct((32, 32), jnp.float32),
        jax.ShapeDtypeStruct((4, 32), jnp.float32)).compile().as_text())

    def g(w, x):
        h = x
        for _ in range(11):
            h = torch.tanh(h @ w)
        return h.sum()
    _, a, _ = analyze_step(g, torch.zeros(32, 32), torch.zeros(4, 32))
    assert a.matmul_flops == 2 * 4 * 32 * 32 * 11
    assert a.matmul_flops == pytest.approx(ref.matmul_flops, rel=0.01)
    assert a.trip_counts == {}


def test_golden_collectives_on_a_fake_group(runs):
    a = _golden(runs)["golden"]
    assert a["matmul_flops"] == 2 * 8 * 32 * 16 * 5
    assert a["collective_by_type"]["all-gather"] == 16 * 32 * 4
    assert a["collective_by_type"]["all-reduce"] == 8 * 32 * 4 * 5
    assert a["collective_count"] == 6


def test_a_sharded_product_counts_its_share(runs):
    whole, shard = _golden(runs)["tp"]
    assert whole == 2 * 64 * 128 * 256
    assert shard == whole / 2


def expected_flops(cfg, shape_name):
    """The FLOPs the cell's products make over all devices, 2 a
    multiply-add: each weight matrix's product per token (fwd; train:
    also the superblocks' remat forward and the backward's two), and
    attention's QKᵀ and PV over the whole key length (the port scores
    every key and masks), each counted once: the layout splits the work
    over the model axis whether or not the heads divide it."""
    sh = SHAPES[shape_name]
    from repro_torch.models.model import abstract_params
    model = abstract_params(cfg)
    dense = sum(p.numel() for n, p in model.named_parameters()
                if p.dim() == 2 and not n.endswith("tok_embed"))
    blocks = sum(p.numel() for n, p in model.named_parameters()
                 if p.dim() == 2 and n.startswith("blocks."))
    b, h, hd, layers = sh.batch, cfg.n_heads, cfg.hd, cfg.n_layers
    if sh.kind == "train":
        tok = b * sh.seq
        attn = 2 * 2 * b * sh.seq * sh.seq * h * hd * layers
        return 6 * dense * tok + 2 * blocks * tok + 4 * attn
    attn = 2 * 2 * b * sh.seq * h * hd * layers
    return 2 * dense * b + attn


# (run, record, arch, shape, the mesh's model axis)
CELLS = [("train", "starcoder2-3b-smoke__train_4k__pod16x16.json",
          "starcoder2-3b", "train_4k", 16),
         ("decode", "granite-smoke__decode_32k__mesh2x4.json",
          "granite-8b", "decode_32k", 4),
         ("gemma", "gemma-smoke__train_4k__mesh2x4.json", "gemma-7b",
          "train_4k", 4)]


@pytest.mark.parametrize("name,fname,arch,shape,tp", CELLS)
def test_smoke_cell_records(runs, name, fname, arch, shape, tp):
    rec = _record(runs, name, fname)
    assert set(rec) == KEYS and rec["status"] == "ok"
    assert rec["mesh"].endswith(f"x{tp}")
    assert set(rec["memory"]) == MEM_KEYS
    assert set(rec["hlo_analysis"]) == ANA_KEYS
    assert rec["devices"] == (256 if name == "train" else 8)
    mem = rec["memory"]
    assert mem["total_bytes"] == mem["argument_bytes"] + \
        mem["temp_bytes"] + mem["output_bytes"] - mem["alias_bytes"] > 0
    assert roofline.analyze_cell(rec)["dominant"] in (
        "compute", "memory", "collective")
    assert rec["hlo_analysis"]["collective_bytes"] > 0
    cfg = configs.get_smoke(arch)
    got = rec["hlo_analysis"]["matmul_flops"] * rec["devices"]
    assert got == pytest.approx(expected_flops(cfg, shape), rel=0.05)


@pytest.mark.parametrize("name,fname,arch,shape,tp", CELLS)
def test_smoke_cell_flops_equal_the_reference(runs, name, fname, arch,
                                              shape, tp):
    """The port splits each cell's work over the devices as the
    reference's compiled step does (ROADMAP C.18)."""
    port = _record(runs, name, fname)["hlo_analysis"]["matmul_flops"]
    ref = _record(runs, "reference", fname)["hlo_analysis"]["matmul_flops"]
    assert port == pytest.approx(ref, rel=0.10)


def _printed(runs, name):
    rc, so, se = runs[name]
    assert rc == 0, se[-4000:]
    return json.loads(so.strip().splitlines()[-1])


def test_loss_gathers_no_logits_over_model(runs):
    """The head and the cross entropy are vocab-parallel (ROADMAP C.18):
    on the (2, 4) mesh a microbatch of 4 sequences of 64 tokens a data
    rank holds (4, 64, V/4) logits; no collective of the step (forward
    and backward) moves that many elements, and the loss combines the
    ranks' logsumexps, (4, 64, 1) each, and their label picks, (4, 64)."""
    got = _printed(runs, "loss")
    shapes = [(kind, tuple(shape)) for kind, shape in got["shapes"]]
    logits = 4 * 64 * got["vocab"] // 4
    big = [s for s in shapes if math.prod(s[1]) >= logits]
    assert not big, big
    assert ("all-gather", (4, 64, 1)) in shapes
    assert ("all-reduce", (4, 64)) in shapes


def test_peak_rule_equals_a_direct_run_at_four_superblocks(runs):
    """``measure_cell``'s peak from 1-3 superblocks against the peak of
    a run at 4, for a training, a prefill (RWKV scans) and a decode
    cell; the prefill's line through 1 and 2 superblocks (the rule
    before) lies above it."""
    got = _printed(runs, "peaks")
    assert set(got) == {"granite-8b:train", "rwkv6-7b:prefill",
                        "granite-8b:decode"}
    for cell, (est, line_1_2, direct) in got.items():
        assert est == pytest.approx(direct, rel=0.01), cell
    est, line_1_2, direct = got["rwkv6-7b:prefill"]
    assert line_1_2 > 1.03 * direct


def test_forced_sharding_mismatch_exits_nonzero(runs):
    rc, so, se = runs["mismatch"]
    assert rc == 1, (so[-2000:], se[-2000:])
    assert "[FAIL]" in so and "divides by 4" in so


def test_perf_cell_restores_the_toggle(runs):
    g = _golden(runs)
    assert g["opt_restored"]
    perf = g["perf"]
    assert perf["opts_off"] == ["fsdp_use_hint"]
    for k in ("compute_s", "memory_s", "collective_s", "mem_gib_per_dev"):
        assert perf[k] > 0, k


def test_aqp_dry_run_on_eight_fake_ranks(runs):
    recs = _golden(runs)["aqp"]
    assert set(recs) == {"aqp_query", "aqp_refine"}
    for rec in recs.values():
        assert set(rec) == KEYS and rec["status"] == "ok"
        assert rec["devices"] == 8
        assert rec["hlo_analysis"]["collective_by_type"]["all-reduce"] > 0
