"""Elastic scaling: restore state onto a different mesh (port of
``repro/runtime/elastic.py``).

Checkpoints hold logical (global) arrays — see ``repro_torch.checkpoint``
— so scaling from, say, a (data=16, model=16) mesh to (data=8, model=16)
after losing hosts is: build the new mesh, recompute the specs (the
rules in ``models.sharding`` are mesh-size-aware), and place each
restored leaf by its new spec. Nothing in the checkpoint refers to
device ids or counts.

The checkpoint is in the reference's layout (superblocks stacked,
``runtime.train_loop.train_state_tree``); a stacked leaf is placed with
its parameters' spec behind a replicated leading axis, and
:func:`load_for_mesh` hands back each parameter and moment under the
port's own names (``blocks.<i>.…``) as a slice of it.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..checkpoint import load_checkpoint
from ..models.model import ModelConfig, abstract_params, unstack_named
from ..models.sharding import NamedSharding, P, param_specs


def _over_specs(fn, specs, *trees):
    """``fn(spec, *leaves)`` at each spec of a nested-dict ``specs`` tree
    (a spec is a tuple, so the walk stops at dicts' values)."""
    if isinstance(specs, dict):
        return {k: _over_specs(fn, v, *(t[k] for t in trees))
                for k, v in specs.items()}
    return fn(specs, *trees)


def reshard_tree(tree, mesh, specs):
    """Each leaf of ``tree`` (nested dicts) placed on ``mesh`` by the
    spec at the same place in ``specs``."""
    return _over_specs(lambda s, leaf: NamedSharding(mesh, s).place(
        torch.as_tensor(leaf)), specs, tree)


def _stacked_specs(names, pspecs):
    """The reference-layout spec tree of ``{name: spec}``: stacked leaves
    get a replicated leading axis."""
    from ..models.model import stack_named
    return stack_named(
        ((n, P(None, *pspecs[n]) if n.split(".")[0] in ("blocks", "encoder")
          else pspecs[n]) for n in names), stack=lambda specs: specs[0])


def load_for_mesh(ckpt_dir: str, template, cfg: ModelConfig, mesh,
                  step=None):
    """Restore a ``(params, opt_state)`` checkpoint (the reference's
    layout; ``template`` of the same structure, e.g.
    ``train_state_tree(model, opt_state, "meta")``) onto ``mesh`` (any
    size): each leaf is placed as it is read. Returns ``(params,
    opt_state, step, meta)``: ``params`` and ``opt_state["m"]``/``["v"]``
    map the port's parameter names to tensors on the mesh (DTensors on
    a ``DeviceMesh``), ``opt_state["step"]`` is replicated."""
    names = [n for n, _ in abstract_params(cfg).named_parameters()]
    stacked = _stacked_specs(names, param_specs(cfg, mesh))

    def sharded(specs):
        return _over_specs(lambda s: NamedSharding(mesh, s), specs)
    shardings = (sharded(stacked),
                 {"m": sharded(stacked), "v": sharded(stacked),
                  "step": NamedSharding(mesh, P())})
    (params, opt), step, meta = load_checkpoint(
        ckpt_dir, template, step=step, shardings=shardings)
    out: Dict[str, Any] = {"step": opt["step"]}
    for k in ("m", "v"):
        out[k] = unstack_named(opt[k], names)
    return unstack_named(params, names), out, step, meta
