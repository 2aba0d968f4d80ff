"""The reference's ``OPT`` toggles on the port (``models/layers.py``):
each leaves the loss and every gradient leaf within 1e-5 (relative, of
the leaf's largest |g|) of the toggle's other setting, and takes effect
where the reference's does.

- ``remat_dots``: remat that saves the products' outputs (selective
  checkpointing) against full remat.
- ``mamba_recompute``: the scans' 16-step chunks under
  ``torch.utils.checkpoint`` — Mamba (jamba) at ``s >= 64``, RWKV at
  ``s % 16 == 0`` and ``s >= 64`` — against one scan.
- ``attn_repeat_k``: K/V repeated to all heads under a mesh whose
  ``model`` axis divides the heads and not the KV heads (granite smoke:
  4 heads, 2 KV heads, on the in-process ``(2,4)`` mesh).

``fsdp_use_hint`` is held on 8 ranks (``test_torch_sharded_train.py``).
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core.mesh import NamedMesh
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import rwkv6 as R
from repro_torch.models.model import init_params, loss_fn


def loss_and_grads(cfg, seq, mesh=None):
    model = init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, seq)))
             for k in ("tokens", "labels")}
    scope = L.activation_mesh_scope(mesh) if mesh is not None \
        else contextlib.nullcontext()
    with scope:
        loss, _ = loss_fn(cfg, model, batch)
        grads = torch.autograd.grad(loss, list(model.parameters()))
    return float(loss), grads


def assert_close(a, b):
    assert abs(a[0] - b[0]) <= 1e-5 * abs(b[0])
    for g, w in zip(a[1], b[1]):
        assert float((g - w).abs().max()) <= 1e-5 * max(
            float(w.abs().max()), 1e-30)


@contextlib.contextmanager
def toggled(key, value):
    old = L.OPT[key]
    L.OPT[key] = value
    try:
        yield
    finally:
        L.OPT[key] = old


def smoke32(arch, **kw):
    return dataclasses.replace(configs.get_smoke(arch), dtype="float32",
                               **kw)


def test_remat_dots():
    cfg = smoke32("granite-8b", remat=True)
    with toggled("remat_dots", False):
        off = loss_and_grads(cfg, 16)
    with toggled("remat_dots", True):
        on = loss_and_grads(cfg, 16)
    assert_close(on, off)


@pytest.mark.parametrize("arch,seq,chunked", [
    ("jamba-1.5-large-398b", 64, True), ("jamba-1.5-large-398b", 48, False),
    ("rwkv6-7b", 64, True), ("rwkv6-7b", 72, False)])
def test_mamba_recompute(arch, seq, chunked, monkeypatch):
    cfg = smoke32(arch)
    mod = M if arch.startswith("jamba") else R
    calls = []
    real = mod._steps
    monkeypatch.setattr(mod, "_steps", lambda *a: calls.append(
        a[0].shape[1]) or real(*a))
    with toggled("mamba_recompute", False):
        off = loss_and_grads(cfg, seq)
    assert set(calls) == {seq}
    calls.clear()
    with toggled("mamba_recompute", True):
        on = loss_and_grads(cfg, seq)
    assert set(calls) == ({16} if chunked else {seq})
    assert_close(on, off)


def test_attn_repeat_k(monkeypatch):
    cfg = smoke32("granite-8b")
    mesh = NamedMesh((2, 4), ("data", "model"), "cpu")
    with toggled("attn_repeat_k", False):
        off = loss_and_grads(cfg, 16, mesh)
    scores = []
    real = L._scores
    monkeypatch.setattr(L, "_scores", lambda *a: scores.append(1)
                        or real(*a))
    with toggled("attn_repeat_k", True):
        on = loss_and_grads(cfg, 16, mesh)
    assert not scores          # the repeated-K path ran
    assert_close(on, off)
