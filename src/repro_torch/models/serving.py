"""Serving: prefill and single-token decode over persistent caches/states
(port of ``repro/models/serving.py``).

State layout mirrors the parameter layout: ``head`` layer states by
index, then one state dict per superblock in the list ``blocks`` (the
reference stacks them on a leading ``n_super`` axis), and for whisper
the cross K/V per superblock in ``cross``. ``pos`` is a Python int.

On a ``DeviceMesh`` (``init_serve_state(..., mesh=)``) every leaf is a
DTensor placed by ``sharding.serve_state_specs``, and ``serve_forward``
runs on DTensor parameters under ``layers.activation_mesh_scope``: each
shard writes its own block of its KV cache in place
(``layers._write_cache``), and every other leaf of the new state (the
Mamba window and SSM state, the RWKV shifts and matrix state, whisper's
cross K/V) is a new tensor, redistributed to its old leaf's placements.
No leaf is written by a slice assignment on a DTensor.

Per-mixer state:
  attn  → KV cache (B, Hkv, T, hd), written IN PLACE at ``pos``;
  mamba → conv window (B, dc−1, di) + SSM state (B, di, ds): O(1) in T;
  rwkv  → token-shift vector + per-head matrix state: O(1) in T.

``serve_state_to_numpy`` / ``serve_state_from_numpy`` convert to and
from the reference's layout (stacked superblocks, ``pos`` an int32).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from . import layers as L
from . import mamba as M
from . import rwkv6 as R
from .model import (Model, ModelConfig, _run_sublayer, _super_kinds,
                    _leaves, cross_kv, embed, encode, logits_of,
                    to_torch)


def _init_sub_state(cfg: ModelConfig, mix, ffn, batch, max_len, dtype,
                    device):
    if mix == "attn":
        return L.init_cache(batch, cfg.attn_dims, max_len, dtype, device)
    if mix == "mamba":
        return M.init_mamba_state(batch, cfg.mamba_dims, dtype, device)
    return R.init_rwkv_state(batch, cfg.d_model, cfg.rwkv_dims, dtype,
                             device)


def init_serve_state(cfg: ModelConfig, batch: int, max_len: int,
                     dtype=torch.bfloat16, *, device="cuda", mesh=None) \
        -> Dict[str, Any]:
    """The zero state of ``batch`` sequences of up to ``max_len`` tokens;
    with a ``DeviceMesh`` ``mesh``, its leaves distributed by
    ``serve_state_specs`` (``device`` must be the mesh's)."""
    state = _init_state(cfg, batch, max_len, dtype, L.model_device(device))
    if mesh is None:
        return state
    from .sharding import distribute_serve_state
    return distribute_serve_state(mesh, state, cfg)


def _init_state(cfg: ModelConfig, batch, max_len, dtype, dev):
    state: Dict[str, Any] = {"pos": 0}
    if cfg.n_head_layers:
        state["head"] = {
            str(i): _init_sub_state(cfg, *cfg.layer_kinds(i), batch,
                                    max_len, dtype, dev)
            for i in range(cfg.n_head_layers)}
    kinds = _super_kinds(cfg)
    state["blocks"] = [
        {f"s{j}": _init_sub_state(cfg, *kinds[j], batch, max_len, dtype, dev)
         for j in range(len(kinds))}
        for _ in range(cfg.n_super)]
    if cfg.family == "encdec":
        shape = (batch, cfg.n_kv_heads, cfg.encoder_seq, cfg.hd)
        state["cross"] = [
            {f"s{j}": {"k": torch.zeros(shape, dtype=dtype, device=dev),
                       "v": torch.zeros(shape, dtype=dtype, device=dev)}
             for j in range(cfg.super_period)}
            for _ in range(cfg.n_super)]
    return state


def _block_step(cfg: ModelConfig, bp, x, sub_state, *, positions, pos,
                cross=None):
    """Run one superblock over its sublayers, threading per-sub state."""
    new_state = {}
    for j in range(len(bp)):
        sp, ss = bp[f"s{j}"], sub_state[f"s{j}"]
        attn = sp.mix == "attn"
        ekv = None
        if cross is not None:
            ekv = (cross[f"s{j}"]["k"], cross[f"s{j}"]["v"])
        x, ns, _ = _run_sublayer(cfg, sp, x, positions=positions,
                                 cache=ss if attn else None, cache_pos=pos,
                                 state=None if attn else ss, enc_kv=ekv,
                                 causal=True)
        new_state[f"s{j}"] = ns
    return x, new_state


@torch.no_grad()
def serve_forward(cfg: ModelConfig, model: Model, tokens, state,
                  extras: Dict[str, Any] | None = None):
    """Shared prefill/decode body. tokens: (B, S_new) at position
    state["pos"]. The KV caches of ``state`` are written in place.

    Returns (logits_last (B, V) float32, new_state).
    """
    extras = extras or {}
    pos = int(state["pos"])
    patches = extras.get("patches") if cfg.family == "vlm" else None
    x = embed(cfg, model, tokens, patches)
    s = x.shape[1]
    positions = torch.arange(pos, pos + s, device=x.device)
    new_state: Dict[str, Any] = {"pos": pos + s}

    cross = None
    if cfg.family == "encdec":
        if "frames" in extras:  # prefill: run encoder, fill cross K/V
            enc_out = encode(cfg, model, extras["frames"])
            cdtype = state["cross"][0]["s0"]["k"].dtype
            cross = []
            for bp in model.blocks:
                one = {}
                for j in range(cfg.super_period):
                    k, v = cross_kv(cfg, bp[f"s{j}"].cross, enc_out, cdtype)
                    one[f"s{j}"] = {"k": k, "v": v}
                cross.append(one)
        else:
            cross = state["cross"]
        new_state["cross"] = cross
        x = x + model.dec_pos_embed[positions]

    if cfg.n_head_layers:
        new_state["head"] = {}
        for i in range(cfg.n_head_layers):
            key = str(i)
            x, ns = _block_step(cfg, {"s0": model.head[key]}, x,
                                {"s0": state["head"][key]},
                                positions=positions, pos=pos)
            new_state["head"][key] = ns["s0"]

    new_state["blocks"] = []
    for i, bp in enumerate(model.blocks):
        x, ns = _block_step(cfg, bp, x, state["blocks"][i],
                            positions=positions, pos=pos,
                            cross=None if cross is None else cross[i])
        new_state["blocks"].append(ns)

    logits = logits_of(cfg, model, x[:, -1:])[:, 0]
    return logits, _placed_like(new_state, state)


def _placed_like(new, old):
    """``new``'s DTensor leaves redistributed to the placements of
    ``old``'s (the identity on plain states)."""
    if isinstance(new, dict):
        return {k: _placed_like(v, old[k]) if k in old else v
                for k, v in new.items()}
    if isinstance(new, list):
        return [_placed_like(n, o) for n, o in zip(new, old)]
    if L.is_dtensor(old) and L.is_dtensor(new) and \
            tuple(new.placements) != tuple(old.placements):
        return new.redistribute(old.device_mesh, old.placements)
    return new


def prefill_step(cfg: ModelConfig, model, tokens, state, extras=None):
    return serve_forward(cfg, model, tokens, state, extras)


def decode_step(cfg: ModelConfig, model, tokens, state, extras=None):
    """One new token per sequence. tokens: (B, 1)."""
    return serve_forward(cfg, model, tokens, state, extras)


# ------------------------------------------------------------------ #
# the reference's layout
# ------------------------------------------------------------------ #
def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _unstack(tree, n):
    return [_map(lambda a, i=i: a[i], tree) for i in range(n)]


def _host(t: torch.Tensor) -> np.ndarray:
    """A copy on the host (a CPU cache is written in place later); a
    DTensor leaf gathered whole first (a collective)."""
    t = t.detach()
    if L.is_dtensor(t):
        t = t.full_tensor()
    t = t.to("cpu", copy=True)
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def serve_state_to_numpy(state) -> Dict[str, Any]:
    """The reference's layout: superblocks stacked, ``pos`` an int32
    array; bfloat16 leaves come back as float32."""
    out: Dict[str, Any] = {"pos": np.asarray(state["pos"], np.int32)}
    if "head" in state:
        out["head"] = _map(_host, state["head"])
    out["blocks"] = _stack([_map(_host, b) for b in state["blocks"]])
    if "cross" in state:
        out["cross"] = _stack([_map(_host, c) for c in state["cross"]])
    return out


def serve_state_from_numpy(tree, device="cuda", mesh=None) \
        -> Dict[str, Any]:
    """A reference state (leaves as numpy, superblocks stacked) as the
    port's; with a ``DeviceMesh`` ``mesh``, distributed by
    ``serve_state_specs``."""
    dev = L.model_device(device)

    def put(a):
        return to_torch(a).to(dev, copy=True)

    state: Dict[str, Any] = {"pos": int(np.asarray(tree["pos"]))}
    if "head" in tree:
        state["head"] = _map(put, tree["head"])
    blocks = _map(put, tree["blocks"])
    n = next(_leaves(blocks)).shape[0]
    state["blocks"] = _unstack(blocks, n)
    if "cross" in tree:
        state["cross"] = _unstack(_map(put, tree["cross"]), n)
    if mesh is None:
        return state
    from .sharding import distribute_serve_state
    return distribute_serve_state(mesh, state)

