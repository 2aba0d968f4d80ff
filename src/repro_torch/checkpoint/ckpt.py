"""Fault-tolerant checkpointing: atomic, async, keep-k (port of
``repro/checkpoint/ckpt.py``, on its on-disk format).

Layout per step::

    <dir>/step_00000420/
        manifest.json      {"step": N, "meta": {...},
                            "leaves": {key: {dtype, shape}}}
        arrays.npz         {key: raw little-endian bytes as uint8}

A tree is nested dicts, lists and tuples with tensors (or numpy arrays
and scalars) at the leaves; a leaf's key is its path joined by ``/``
(dict keys, sequence indices), as the reference joins it. So a
``(params, opt_state)`` tree in the reference's layout (repeated
superblocks stacked, ``models.model.stack_named``) has the reference's
keys (``0/blocks/s0/attn/wq``, ``1/m/…``, ``1/step``), and a checkpoint
written by either package loads in the other.

bfloat16, which numpy lacks, is written as the tensor's int16 view with
the dtype string ``"bfloat16"`` and read back as such: no leaf passes
through float32.

Durability: the step directory is written as ``*.tmp`` and renamed only
after both files are fsync'd, so a reader never sees a partial
checkpoint, and the next save removes a crashed writer's ``*.tmp``.
:class:`CheckpointManager` copies the tree to the host before its
background thread starts (training updates the parameters in place
while the thread writes), and keeps the last ``keep`` checkpoints.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

_SEP = "/"


def _items(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (str(i),))
    else:
        yield _SEP.join(prefix), tree


def _map(fn, tree, prefix=()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, prefix + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return fn(_SEP.join(prefix), tree)


def _to_host(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


def _raw(leaf):
    """(bytes as uint8, dtype string, shape) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            a, dtype = t.view(torch.int16).numpy(), "bfloat16"
        else:
            a = t.numpy()
            dtype = str(a.dtype)
    else:
        a = np.ascontiguousarray(leaf)
        dtype = str(a.dtype)
    return np.frombuffer(a.tobytes(), np.uint8), dtype, list(a.shape)


def _leaf(raw: np.ndarray, dtype: str, shape, device) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(np.frombuffer(raw.tobytes(), np.int16).copy()
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.frombuffer(raw.tobytes(), dtype).copy())
    return t.reshape(shape).to(device)


def _step_dir(base: str, step: int) -> str:
    return os.path.join(base, f"step_{step:08d}")


def _fsynced(path: str, write):
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def save_checkpoint(base: str, step: int, tree, meta: Optional[dict] = None):
    """Atomic synchronous save of ``tree`` as step ``step``."""
    os.makedirs(base, exist_ok=True)
    for d in os.listdir(base):            # a crashed writer's litter
        if d.endswith(".tmp"):
            shutil.rmtree(os.path.join(base, d), ignore_errors=True)
    arrays, leaves = {}, {}
    for key, leaf in _items(tree):
        arrays[key], dtype, shape = _raw(leaf)
        leaves[key] = {"dtype": dtype, "shape": shape}
    manifest = {"step": step, "meta": meta or {}, "leaves": leaves}
    final = _step_dir(base, step)
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    _fsynced(os.path.join(tmp, "arrays.npz"),
             lambda f: np.savez(f, **arrays))
    _fsynced(os.path.join(tmp, "manifest.json"),
             lambda f: f.write(json.dumps(manifest).encode()))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(base: str) -> Optional[int]:
    if not os.path.isdir(base):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(base)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(base, d, "manifest.json"))]
    return max(steps) if steps else None


def load_checkpoint(base: str, template, step: Optional[int] = None, *,
                    device="cpu"):
    """Restore a checkpoint onto ``template``'s structure (its leaves need
    only a ``shape``; ``meta`` tensors will do): each leaf a tensor of
    the manifest's dtype on ``device``. Returns (tree, step, meta)."""
    step = latest_step(base) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {base}")
    d = _step_dir(base, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = manifest["leaves"]
    with np.load(os.path.join(d, "arrays.npz")) as raw:
        def pick(key, like):
            info = leaves[key]
            if tuple(info["shape"]) != tuple(like.shape):
                raise ValueError(f"{key}: checkpoint shape {info['shape']} "
                                 f"!= {tuple(like.shape)}")
            return _leaf(raw[key], info["dtype"], info["shape"], device)
        tree = _map(pick, template)
    return tree, step, manifest["meta"]


class CheckpointManager:
    """Async keep-k checkpointer: one save in flight at a time."""

    def __init__(self, base: str, keep: int = 3):
        self.base = base
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_saved: Optional[int] = None

    def save(self, step: int, tree, meta=None, block: bool = False):
        """Save ``tree`` as ``step`` on a background thread; the tree is
        copied to the host first, so later in-place updates of its
        tensors do not reach the checkpoint."""
        self.wait()
        host_tree = _map(lambda _k, leaf: _to_host(leaf), tree)

        def work():
            try:
                save_checkpoint(self.base, step, host_tree, meta)
                self._gc()
                self.last_saved = step
            except BaseException as e:        # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if block:
            self.wait()

    def wait(self):
        """Join the save in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(s for s in (
            int(d.split("_")[1]) for d in os.listdir(self.base)
            if d.startswith("step_") and not d.endswith(".tmp")))
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(_step_dir(self.base, s), ignore_errors=True)
