"""Training runtime: microbatched train step + fault-tolerant loop (port
of ``repro/runtime/train_loop.py``).

``make_train_step`` builds the step:

- **gradients** by ``torch.autograd.grad`` of ``loss_fn`` over the
  parameters, each in its parameter's dtype (``jax.value_and_grad``'s);
- **grad accumulation**: with ``microbatches = m`` the batch is split on
  its leading axis and each part's ``g / m`` (in ``g``'s dtype, then cast
  to ``accum_dtype``) is added into a zeroed accumulator, the reference's
  order; autograd never adds into bfloat16 ``.grad`` buffers;
- **remat** is per model (``ModelConfig.remat`` checkpoints each
  superblock, ``models/model.py``);
- the AdamW update of ``optim.opt_update``, in place.

``train_loop`` runs the steps: checkpoint/restart (it resumes at the step
of the latest atomic checkpoint), deterministic per-step data
(``batch_fn(step)``: a restarted worker replays the same batch), a step
watchdog, async checkpoints every ``ckpt_every`` steps and a final
blocking one. It trains a copy of the caller's model, on that model's
device.

On a ``DeviceMesh`` (parameters DTensors placed by
``models.sharding``, the batch sharded over the data axes),
``make_train_step``'s ``grad_shardings`` pins each gradient, and the
accumulator, to its parameter's placements (ZeRO): a ``Partial``
gradient is reduced to them, a reduce-scatter. ``mb_shardings`` gives
the placements of each batch leaf's ``(microbatches, B/m, ...)``
split, which keeps each microbatch sharded over the data axes. Both do
nothing to plain tensors. The optimizer runs on the DTensor leaves, and
its moments take the parameters' placements.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..checkpoint import CheckpointManager, latest_step, load_checkpoint
from ..models.layers import is_dtensor
from ..models.model import ModelConfig, loss_fn, stack_named, unstack_named
from ..optim import OptConfig, init_opt_state, opt_update
from .watchdog import StepWatchdog


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    microbatches: int = 1
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep: int = 3
    log_every: int = 10


def make_train_step(model_cfg: ModelConfig, opt_cfg: OptConfig,
                    microbatches: int = 1,
                    grad_shardings: Optional[Dict[str, Any]] = None,
                    mb_shardings: Optional[Dict[str, Any]] = None,
                    accum_dtype: torch.dtype = torch.float32) -> Callable:
    """Returns ``train_step(model, opt_state, batch) → (model, opt_state,
    metrics)``, which updates ``model`` and ``opt_state`` in place.

    batch leaves are (B, ...) tensors on the model's device; with
    ``microbatches`` m, B must divide by m and the step runs m
    accumulation passes of B/m. metrics: ``loss``, ``ce``, ``aux``,
    ``lr``, ``grad_norm`` (0-d tensors).

    grad_shardings: optional ``{parameter name: placements}`` on the
    parameters' ``DeviceMesh`` (``sharding.param_placements``) — pins
    each gradient and the accumulator to the parameter's layout (ZeRO).

    mb_shardings: optional ``{batch key: placements}`` for the
    ``(microbatches, B/m, ...)`` split of each batch leaf (the batch
    placements with a replicated microbatch axis in front): the split
    is taken from the gathered batch and re-pinned, so each microbatch
    stays sharded over the data axes."""

    def pin(name, g):
        if grad_shardings is None or not is_dtensor(g):
            return g
        return g.redistribute(g.device_mesh, grad_shardings[name])

    def split(k, v):
        m = microbatches
        if mb_shardings is None or not is_dtensor(v):
            return v.reshape(m, v.shape[0] // m, *v.shape[1:])
        from torch.distributed.tensor import Replicate
        mesh = v.device_mesh
        v = v.redistribute(mesh, [Replicate()] * mesh.ndim)
        return v.reshape(m, v.shape[0] // m, *v.shape[1:]).redistribute(
            mesh, mb_shardings[k])

    def single(model, names, params, batch):
        loss, met = loss_fn(model_cfg, model, batch)
        grads = torch.autograd.grad(loss, params)
        return loss.detach(), {k: v.detach() for k, v in met.items()}, \
            [pin(n, g) for n, g in zip(names, grads)]

    def train_step(model, opt_state, batch):
        names, params = zip(*model.named_parameters())
        if microbatches == 1:
            loss, met, grads = single(model, names, params, batch)
        else:
            m = microbatches
            mbatch = {k: split(k, v) for k, v in batch.items()}
            grads = [pin(n, torch.zeros_like(p, dtype=accum_dtype))
                     for n, p in zip(names, params)]
            loss = torch.zeros((), dtype=torch.float32,
                               device=params[0].device)
            for i in range(m):
                l, _, g = single(model, names, params,
                                 {k: v[i] for k, v in mbatch.items()})
                for acc, gi in zip(grads, g):
                    acc += (gi / m).to(accum_dtype)
                loss = loss + l / m
                del g                    # before the next backward
            met = {"ce": loss, "aux": torch.zeros_like(loss)}
        opt_state, om = opt_update(model, dict(zip(names, grads)), opt_state,
                                   opt_cfg)
        return model, opt_state, {"loss": loss, **met, **om}

    return train_step


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _on(batch, dev: torch.device):
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.asarray(v))).to(dev)
            for k, v in batch.items()}


def train_state_tree(model, opt_state, device="cpu"):
    """``(params, opt_state)`` in the reference's checkpoint layout
    (superblocks stacked, dtypes kept), copied to ``device`` (``"meta"``:
    shapes only)."""
    def tree(items):
        return stack_named((n, t.detach().to(device, copy=True))
                           for n, t in items)
    return (tree(model.named_parameters()),
            {"m": tree(opt_state["m"].items()),
             "v": tree(opt_state["v"].items()),
             "step": opt_state["step"].detach().to(device, copy=True)})


@torch.no_grad()
def restore_train_state(model, opt_state, tree):
    """Write a :func:`train_state_tree` back into ``model`` and
    ``opt_state`` in place."""
    params, opt = tree
    names = [n for n, _ in model.named_parameters()]
    leaves = unstack_named(params, names)
    for n, p in model.named_parameters():
        p.copy_(leaves[n])
    for k in ("m", "v"):
        for n, leaf in unstack_named(opt[k], names).items():
            opt_state[k][n].copy_(leaf)
    opt_state["step"].copy_(opt["step"])


def train_loop(model_cfg: ModelConfig, opt_cfg: OptConfig,
               loop_cfg: TrainLoopConfig, model, batch_fn: Callable,
               *, train_step: Optional[Callable] = None,
               hooks: Optional[Dict[str, Callable]] = None):
    """Run (or resume) training of a copy of ``model`` on its device.
    ``batch_fn(step) -> batch`` (tensors or numpy arrays) must be
    deterministic in ``step`` (fault-tolerant replay).

    Returns (model, opt_state, {"history", "stragglers"})."""
    hooks = hooks or {}
    step_fn = train_step or make_train_step(model_cfg, opt_cfg,
                                            loop_cfg.microbatches)
    # the step updates in place: train a copy, so the caller's parameters
    # survive (and a restarted loop can start from them again)
    model = copy.deepcopy(model)
    dev = _device(model)
    opt_state = init_opt_state(model, opt_cfg)

    start = 0
    mgr = None
    if loop_cfg.ckpt_dir:
        mgr = CheckpointManager(loop_cfg.ckpt_dir, keep=loop_cfg.keep)
        if latest_step(loop_cfg.ckpt_dir) is not None:
            tree, start, _meta = load_checkpoint(
                loop_cfg.ckpt_dir, train_state_tree(model, opt_state,
                                                    "meta"))
            restore_train_state(model, opt_state, tree)
            start = int(start)

    def save(step, block=False):
        mgr.save(step, train_state_tree(model, opt_state),
                 meta={"model": model_cfg.name}, block=block)

    watchdog = StepWatchdog()
    history = []
    for step in range(start, loop_cfg.steps):
        batch = _on(batch_fn(step), dev)
        _sync(dev)
        t0 = time.perf_counter()
        model, opt_state, metrics = step_fn(model, opt_state, batch)
        _sync(dev)
        dt = time.perf_counter() - t0
        watchdog.record(step, dt)
        if step % loop_cfg.log_every == 0 or step == loop_cfg.steps - 1:
            row: Dict[str, Any] = {"step": step, "time_s": dt,
                                   **{k: float(v)
                                      for k, v in metrics.items()}}
            history.append(row)
            if "on_log" in hooks:
                hooks["on_log"](row)
        if mgr and loop_cfg.ckpt_every and \
                (step + 1) % loop_cfg.ckpt_every == 0:
            save(step + 1)
    if mgr:
        save(loop_cfg.steps, block=True)
    return model, opt_state, {"history": history,
                              "stragglers": watchdog.stragglers}
