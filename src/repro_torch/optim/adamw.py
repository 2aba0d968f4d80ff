"""AdamW with cosine schedule, global-norm clipping and per-parameter
state (port of ``repro/optim/adamw.py``).

The state mirrors the model's parameters: ``{"m": {name: tensor}, "v":
{name: tensor}, "step": int32 tensor}``, keyed by
``Model.named_parameters()`` names and held on the parameters' device.
``state_dtype="bfloat16"`` halves the moments' memory (the reference's
choice for its ≥ 50 B-parameter configurations); the parameters keep
their own dtype.

:func:`opt_update` does the reference's arithmetic in its order (the
update is not ``torch.optim.AdamW``'s, whose decoupled decay rounds in
another order): the pre-clip global norm in float32, the clip scale,
bias corrections from the float32 step, and ``p32 − lr·(m̂/(√v̂ + eps) +
wd·p32)`` cast back to the parameter's dtype, in place.

On DTensor parameters (a ``DeviceMesh``, ``models.sharding``) the
moments take each parameter's placements; the global norm is a DTensor
reduction, and the elementwise update runs on each leaf's local shard,
its gradient first reduced to the parameter's placements.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

from ..models.layers import is_dtensor
from ..models.model import host_numpy, stack_named, to_torch, unstack_named

STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"   # float32 | bfloat16


def lr_at_step(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor, on its device),
    float32: linear warm-up, then cosine decay to ``min_lr_frac·lr``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps) /
                    max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac * cfg.lr + (1 - cfg.min_lr_frac) * cfg.lr * \
        0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def init_opt_state(model: nn.Module, cfg: OptConfig) -> Dict[str, Any]:
    dt = STATE_DTYPES[cfg.state_dtype]
    named = list(model.named_parameters())
    # zeros_like: a DTensor parameter's moments take its placements
    return {"m": {n: torch.zeros_like(p, dtype=dt) for n, p in named},
            "v": {n: torch.zeros_like(p, dtype=dt) for n, p in named},
            "step": torch.zeros((), dtype=torch.int32,
                                device=_device(model))}


def global_norm(tensors) -> torch.Tensor:
    """The float32 norm of all ``tensors`` (a replicated 0-d tensor on
    DTensor leaves: each leaf's partial sums are all-reduced)."""
    sq = [torch.sum(torch.square(t.float())) for t in tensors]
    sq = [s.full_tensor() if is_dtensor(s) else s for s in sq]
    return torch.sqrt(sum(sq))


def _local(t, like=None):
    """A DTensor's local shard (redistributed to ``like``'s placements
    first); a plain tensor as it is."""
    if not is_dtensor(t):
        return t
    if like is not None and tuple(t.placements) != tuple(like.placements):
        t = t.redistribute(like.device_mesh, like.placements)
    return t.to_local()


@torch.no_grad()
def opt_update(model: nn.Module, grads: Dict[str, torch.Tensor],
               opt_state: Dict[str, Any], cfg: OptConfig
               ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: updates ``model``'s parameters and the moments in
    place. ``grads`` maps each parameter's name to its gradient.
    Returns ``(opt_state, {"lr", "grad_norm"})``, the norm taken before
    the clip."""
    step = opt_state["step"] + 1
    lr = lr_at_step(cfg, step)
    gnorm = global_norm(grads.values())
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.grad_clip > 0 else 1.0

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)
    for name, p in model.named_parameters():
        m, v = _local(opt_state["m"][name]), _local(opt_state["v"][name])
        g = _local(grads[name], p).to(torch.float32) * scale
        p = _local(p)
        m_new = b1 * m.to(torch.float32) + (1 - b1) * g
        v_new = b2 * v.to(torch.float32) + (1 - b2) * torch.square(g)
        mhat = m_new / bc1
        vhat = v_new / bc2
        p32 = p.to(torch.float32)
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + \
            cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
        m.copy_(m_new)
        v.copy_(v_new)
    opt_state["step"] = step
    return opt_state, {"lr": lr, "grad_norm": gnorm}


def opt_state_to_numpy(opt_state: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's optimizer state tree (moments laid out as
    ``params_to_numpy`` lays out the parameters, bfloat16 as float32;
    ``step`` an int32 scalar)."""
    return {"m": stack_named(((n, host_numpy(t))
                              for n, t in opt_state["m"].items()), np.stack),
            "v": stack_named(((n, host_numpy(t))
                              for n, t in opt_state["v"].items()), np.stack),
            "step": np.asarray(host_numpy(opt_state["step"]), np.int32)}


def opt_state_from_numpy(model: nn.Module, tree, cfg: OptConfig
                         ) -> Dict[str, Any]:
    """The optimizer state of ``model`` holding the reference's tree,
    moments in ``cfg.state_dtype`` on the model's device."""
    dt, dev = STATE_DTYPES[cfg.state_dtype], _device(model)
    names = [n for n, _ in model.named_parameters()]
    return {k: {n: to_torch(a).to(dev, dt)
                for n, a in unstack_named(tree[k], names).items()}
            for k in ("m", "v")} | {
        "step": torch.tensor(int(np.asarray(tree["step"])),
                             dtype=torch.int32, device=dev)}
