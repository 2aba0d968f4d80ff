"""Serving under a mesh on 8 gloo ranks: one ``torch.multiprocessing``
spawn of a ``(data=2, model=4)`` ``DeviceMesh`` runs every case of
``tests/torch_serve_cases.py`` once (module fixture, ~25-35 s), and
these tests read rank 0's record.

For granite-8b (4 heads, 2 KV heads: the KV cache is sharded on its
head dim, ``serve_state_specs``), starcoder2-3b (6 heads: gathered
attention), rwkv6-7b and jamba-1.5-large-398b (the recurrent states)
and whisper-small (the cross K/V), float32 smoke: prefill of 8 tokens
and 3 decode steps on DTensor parameters and state give every logit and
every state leaf within 1e-4 of its largest |value| of the port's plain
path, and every leaf keeps the placements of ``serve_state_specs``. For
granite they also match the reference's ``prefill_step`` /
``decode_step`` with its state placed by its own ``serve_state_specs``
on 8 fake XLA devices (a subprocess run beside the spawn, ``Auto``
axes), and a decode past ``max_len`` raises on the mesh.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import torch_serve_cases as cases
import torch_shard_cases as shard
from repro_torch.models.model import params_from_numpy
from repro_torch.models.serving import (decode_step, init_serve_state,
                                        prefill_step, serve_state_to_numpy)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REF_SERVE = """
    import jax, numpy as np
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding
    from repro import configs
    from repro.models import serving as RS
    from repro.models.layers import activation_mesh_scope
    from repro.models.sharding import (batch_specs, param_specs,
                                       serve_state_specs)

    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    cfg = configs.get_smoke("granite-8b")
    cfg = cfg.__class__(**{**cfg.__dict__, "dtype": "float32"})
    tree = {}
    for k, v in np.load(f"{DIR}/params.npz").items():
        node = tree
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = jnp.asarray(v)

    def put(t, specs):
        return jax.tree.map(
            lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), t, specs)
    params = put(tree, param_specs(cfg, mesh))
    st = RS.init_serve_state(cfg, B, MAX_LEN, jnp.float32)
    st = put(st, serve_state_specs(cfg, mesh, st))
    tok_sh = NamedSharding(mesh, batch_specs(cfg, mesh, B)["tokens"])
    toks = np.load(f"{DIR}/toks.npy")

    def pf(p, t, s):
        with activation_mesh_scope(mesh):
            return RS.prefill_step(cfg, p, t, s)

    def dc(p, t, s):
        with activation_mesh_scope(mesh):
            return RS.decode_step(cfg, p, t, s)
    out = {}
    with mesh:
        lg, st = jax.jit(pf)(params, jax.device_put(
            jnp.asarray(toks[:, :PREFILL], jnp.int32), tok_sh), st)
        out["logits:0"] = np.asarray(lg)
        for i in range(PREFILL, PREFILL + DECODE):
            lg, st = jax.jit(dc)(params, jax.device_put(
                jnp.asarray(toks[:, i:i + 1], jnp.int32), tok_sh), st)
            out[f"logits:{i - PREFILL + 1}"] = np.asarray(lg)

    def flat(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}/{k}")
            else:
                yield f"{prefix}/{k}", np.asarray(v, np.float32)
    out.update(flat(st, "state"))
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
    granite run (``ref:`` keys)."""
    import torch.multiprocessing as mp
    d = tmp_path_factory.mktemp("sharded_serve")
    cfg = cases.smoke_cfg("granite-8b")
    np.savez(d / "params.npz", **dict(flat_tree(shard.model_np(cfg))))
    np.save(d / "toks.npy", cases.inputs_np(cfg)[0])
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"))
    code = f"DIR = {str(d)!r}\nB, PREFILL, DECODE, MAX_LEN = " \
        f"{(cases.B, cases.PREFILL, cases.DECODE, cases.MAX_LEN)!r}\n" + \
        textwrap.dedent(REF_SERVE)
    ref = subprocess.Popen([sys.executable, "-c", code], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        mp.spawn(cases.rank_main, args=(8, str(d / "store"),
                                        str(d / "rank0.npz")),
                 nprocs=8, join=True)
        _, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, err[-4000:]
    rec = dict(np.load(d / "rank0.npz"))
    rec.update({f"ref:{k}": v for k, v in np.load(d / "ref.npz").items()})
    return rec


def plain(arch):
    """The port's plain path on the same inputs: the logits of each step
    and the last state, flattened."""
    cfg = cases.smoke_cfg(arch)
    model = params_from_numpy(cfg, shard.model_np(cfg), "cpu")
    state = init_serve_state(cfg, cases.B, cases.MAX_LEN, torch.float32,
                             device="cpu")
    toks, extras = cases.inputs_np(cfg)
    logits, state = cases.run(
        cfg, model, state, toks, extras,
        lambda m, t, s, e: prefill_step(cfg, m, t, s, e),
        lambda m, t, s: decode_step(cfg, m, t, s))
    return ([lg.numpy() for lg in logits],
            cases.flat_state(serve_state_to_numpy(state)))


def leaf_err(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


@pytest.mark.parametrize("arch", cases.ARCHS)
def test_sharded_serving_equals_plain(record, arch):
    logits, state = plain(arch)
    for i, want in enumerate(logits):
        assert leaf_err(record[f"{arch}:logits:{i}"], want) <= 1e-4, i
    for k, want in state.items():
        assert record[f"{arch}:{k}"].shape == want.shape, k
        assert leaf_err(record[f"{arch}:{k}"], want) <= 1e-4, k


@pytest.mark.parametrize("arch", cases.ARCHS)
def test_sharded_state_keeps_serve_state_specs(record, arch):
    assert bool(record[f"{arch}:placed"])


def test_sharded_granite_equals_reference_sharded(record):
    keys = [k for k in record if k.startswith("ref:")]
    assert len(keys) > cases.DECODE + 1
    for k in keys:
        got = record[f"granite-8b:{k[4:]}"]
        want = record[k]
        if k.endswith("/pos"):
            assert int(got) == int(want) == cases.PREFILL + cases.DECODE
            continue
        assert got.shape == want.shape, k
        assert leaf_err(got, want) <= 1e-4, k


def test_decode_past_max_len_raises_on_the_mesh(record):
    assert bool(record["granite:overflow_raised"])
