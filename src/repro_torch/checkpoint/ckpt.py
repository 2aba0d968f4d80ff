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
through float32. A DTensor leaf (a sharded model on a ``DeviceMesh``)
is written whole, gathered first: checkpoints hold logical arrays, and
``load_checkpoint(shardings=...)`` places them on any mesh.

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
import struct
import threading
import warnings
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterable, Optional, Tuple

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


def _logical(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole (logical) value — an all-gather, so every rank
    of its mesh calls it — or the tensor itself."""
    from ..models.layers import is_dtensor
    return t.full_tensor() if is_dtensor(t) else t


def _to_host(leaf):
    if isinstance(leaf, torch.Tensor):
        return _logical(leaf.detach()).to("cpu", copy=True)
    return np.array(leaf, copy=True)


def _raw(leaf):
    """(bytes as uint8, dtype string, shape) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = _logical(leaf.detach()).to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            a, dtype = t.view(torch.int16).numpy(), "bfloat16"
        else:
            a = t.numpy()
            dtype = str(a.dtype)
    else:
        a = np.ascontiguousarray(leaf)
        dtype = str(a.dtype)
    # a view of the leaf's bytes (C order, as ``tobytes`` gives them)
    return a.reshape(-1).view(np.uint8), dtype, list(a.shape)


def _leaf(raw: np.ndarray, dtype: str, shape, device) -> torch.Tensor:
    """The leaf of a freshly read uint8 array: a view of it, copied once
    (to the device, or on the host when the read buffer is read-only)."""
    dev = torch.device(device)
    if dev.type == "cpu" and not raw.flags.writeable:
        raw = raw.copy()
    with warnings.catch_warnings():     # a read-only buffer, copied next
        warnings.simplefilter("ignore", UserWarning)
        if dtype == "bfloat16":
            t = torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(raw.view(np.dtype(dtype)))
    return t.reshape(shape).to(dev)


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
    leaves = {}

    def raw_items():
        for key, leaf in _items(tree):
            a, dtype, shape = _raw(leaf)
            leaves[key] = {"dtype": dtype, "shape": shape}
            yield key, a
    final = _step_dir(base, step)
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    _fsynced(os.path.join(tmp, "arrays.npz"),
             lambda f: _write_npz(f, raw_items()))
    manifest = {"step": step, "meta": meta or {}, "leaves": leaves}
    _fsynced(os.path.join(tmp, "manifest.json"),
             lambda f: f.write(json.dumps(manifest).encode()))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def _write_npz(f, items: Iterable[Tuple[str, np.ndarray]]):
    """``np.savez``'s file (a stored zip of ``<key>.npy`` members), one
    member at a time as ``items`` yields them (1-D contiguous uint8
    arrays: a version 1.0 header, as ``write_array`` gives them, then
    the array's memory in one write)."""
    fmt = np.lib.format
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, a in items:
            with zf.open(key + ".npy", "w", force_zip64=True) as m:
                fmt.write_array_header_1_0(m, fmt.header_data_from_array_1_0(a))
                m.write(memoryview(a))


class _NpzReader:
    """The arrays of an ``.npz`` file by key: a stored member's bytes
    are read from their offset in one call, and its CRC-32 is checked on
    worker threads (:meth:`verify` waits for them and raises on a
    mismatch); a compressed member goes through ``zipfile``."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        self._zip = zipfile.ZipFile(self._f)
        self._pool = ThreadPoolExecutor(4)
        self._checks = []

    def __getitem__(self, key: str) -> np.ndarray:
        info = self._zip.getinfo(key + ".npy")
        if info.compress_type != zipfile.ZIP_STORED:
            with self._zip.open(info) as m:
                return np.lib.format.read_array(m, allow_pickle=False)
        f = self._f
        f.seek(info.header_offset)
        name_len, extra_len = struct.unpack("<HH", f.read(30)[26:30])
        start = info.header_offset + 30 + name_len + extra_len
        f.seek(start)
        version = np.lib.format.read_magic(f)
        shape, fortran, dtype = (
            np.lib.format.read_array_header_1_0 if version == (1, 0)
            else np.lib.format.read_array_header_2_0)(f)
        head_len = f.tell() - start
        f.seek(start)
        head = f.read(head_len)
        a = np.fromfile(f, dtype=dtype, count=int(np.prod(shape)))
        a = a.reshape(shape, order="F" if fortran else "C")
        self._checks.append((key, info.CRC, self._pool.submit(
            lambda: zlib.crc32(a.reshape(-1, order="A").view(np.uint8),
                               zlib.crc32(head)))))
        return a

    def verify(self):
        for key, want, got in self._checks:
            if got.result() != want:
                raise ValueError(f"{key}: CRC-32 mismatch in the checkpoint")

    def close(self):
        self._pool.shutdown()
        self._zip.close()
        self._f.close()


def latest_step(base: str) -> Optional[int]:
    if not os.path.isdir(base):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(base)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(base, d, "manifest.json"))]
    return max(steps) if steps else None


def load_checkpoint(base: str, template, step: Optional[int] = None, *,
                    device="cpu", shardings=None):
    """Restore a checkpoint onto ``template``'s structure (its leaves need
    only a ``shape``; ``meta`` tensors will do): each leaf a tensor of
    the manifest's dtype on ``device``. Returns (tree, step, meta).

    shardings: optional tree of the same structure whose leaves are
    ``models.sharding.NamedSharding`` (or None): each restored leaf is
    placed by its sharding as soon as it is read — elastic restore onto
    another mesh than the one that saved, since a checkpoint holds
    logical (global) arrays."""
    step = latest_step(base) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {base}")
    d = _step_dir(base, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = manifest["leaves"]
    raw = _NpzReader(os.path.join(d, "arrays.npz"))
    try:
        def pick(key, like):
            info = leaves[key]
            if tuple(info["shape"]) != tuple(like.shape):
                raise ValueError(f"{key}: checkpoint shape {info['shape']} "
                                 f"!= {tuple(like.shape)}")
            return _leaf(raw[key], info["dtype"], info["shape"], device)
        if shardings is None:
            tree = _map(pick, template)
        else:
            flat = dict(_items(shardings))

            def pick_placed(key, like):
                leaf = pick(key, like)
                sh = flat.get(key)
                return leaf if sh is None else sh.place(leaf)
            tree = _map(pick_placed, template)
        raw.verify()
    finally:
        raw.close()
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
