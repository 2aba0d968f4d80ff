"""Simulated in-situ raw data file with byte-level I/O accounting.

Port of :mod:`repro.data.rawfile`. The paper's cost model is "objects
read from the raw file": every access to non-axis attribute values goes
through :meth:`RawDataset.read_values`, which accounts rows, bytes and
calls exactly as the reference does.

Placement:

- ``device="cuda"`` (the default) or ``device="cpu"``: the columns are
  float32 tensors on that device — the object store resident in device
  memory, where a "read" is a gather on the device.
- ``device=None``: the reference's host modes, kept for parity —
  ``array`` (numpy gather), ``csv`` (fixed-width text records parsed on
  every read) and ``mmap`` (``np.memmap`` on disk).

``read_values`` takes the row ids in the form the caller's control plane
holds them: a numpy array returns a numpy array (the ``"np"`` backend,
host data only), a tensor returns a tensor on the dataset's device.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch


def resolve_device(device) -> Optional[torch.device]:
    """``None`` stays host numpy; anything else becomes a torch device.
    Asking for CUDA without a usable card raises — the port never falls
    back to the CPU unless the caller asks for it."""
    if device is None:
        return None
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev


def as_host(a) -> np.ndarray:
    """A numpy view of host data; a CUDA tensor raises (the ``"np"``
    backend never copies device data back silently)."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise TypeError(f"the 'np' backend needs host data, got a "
                            f"tensor on {a.device}")
        return a.numpy()
    return a


@dataclasses.dataclass
class IOStats:
    rows_read: int = 0
    bytes_read: int = 0
    read_calls: int = 0
    init_rows: int = 0
    # chunks skipped wholesale on their axis bounding box or value zone
    # map (chunked storage): the query touched none of their rows
    pruned_calls: int = 0

    def snapshot(self) -> "IOStats":
        return dataclasses.replace(self)

    def delta(self, before: "IOStats") -> "IOStats":
        return IOStats(**{
            f.name: getattr(self, f.name) - getattr(before, f.name)
            for f in dataclasses.fields(self)})

    def merge(self, other: "IOStats") -> "IOStats":
        """Field-wise sum (chunked datasets aggregate per-chunk stats)."""
        return IOStats(**{
            f.name: getattr(self, f.name) + getattr(other, f.name)
            for f in dataclasses.fields(self)})


class RawDataset:
    """A raw data file: 2 axis attributes + M non-axis numeric attributes.

    ``x``/``y`` are exposed directly (the index ingests them once at
    initialization, accounted in ``stats.init_rows``); all non-axis
    value access is accounted per row.
    """

    ITEM_BYTES = 4       # float32 column storage (array/mmap/device)
    CSV_WIDTH = 14       # fixed-width text record (csv mode)

    def __init__(self, x, y, columns: Dict[str, np.ndarray],
                 mmap_dir: Optional[str] = None,
                 storage: str = "array", device="cuda"):
        self.n = len(x)
        assert all(len(v) == self.n for v in columns.values())
        self.device = resolve_device(device)
        if self.device is not None and (storage != "array"
                                        or mmap_dir is not None):
            raise ValueError("csv/mmap storage are host modes: pass "
                             "device=None with them")
        self.stats = IOStats()
        self._closed = False
        self._mmap_dir = mmap_dir
        self.storage = "mmap" if mmap_dir is not None else storage
        self._cols = {}
        self._text = {}
        if self.device is not None:
            self.x = _to_device(x, self.device)
            self.y = _to_device(y, self.device)
            for k, v in columns.items():
                self._cols[k] = _to_device(v, self.device)
        else:
            self.x = np.asarray(x, np.float32)
            self.y = np.asarray(y, np.float32)
        # axis bbox computed once — domain() sits on the per-query
        # classify path
        if self.n:
            self._domain = (float(self.x.min()), float(self.y.min()),
                            float(self.x.max()), float(self.y.max()))
        else:
            self._domain = (0.0, 0.0, 0.0, 0.0)
        if self.device is not None:
            return
        if self.storage == "mmap":
            os.makedirs(mmap_dir, exist_ok=True)
            for k, v in columns.items():
                path = os.path.join(mmap_dir, f"{k}.f32")
                np.asarray(v, np.float32).tofile(path)
                self._cols[k] = np.memmap(path, dtype=np.float32, mode="r")
        elif self.storage == "csv":
            w = self.CSV_WIDTH
            for k, v in columns.items():
                vf = np.asarray(v, np.float32)
                # the "raw file": fixed-width text records, parsed on read
                self._text[k] = np.char.ljust(
                    np.char.mod("%.6g", vf).astype(f"S{w}"), w).view(
                        f"S{w}")
                # ground truth (oracle only) = what the file contains
                self._cols[k] = self._text[k].astype(np.float32)
        else:
            for k, v in columns.items():
                self._cols[k] = np.asarray(v, np.float32)

    @property
    def attributes(self) -> Sequence[str]:
        return tuple(self._cols.keys())

    def domain(self):
        """(x0, y0, x1, y1) bounding box of the axis attributes."""
        return self._domain

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        """Release column storage (chunk retirement). Accounted reads
        after close raise. On a device the axis planes go too, so a
        retired chunk holds no device memory once its forest is dropped
        (``n`` and ``domain()`` stay)."""
        self._closed = True
        self._cols = {}
        self._text = {}
        if self.device is not None:
            self.x = self.y = None
        if self.storage == "mmap" and self._mmap_dir is not None:
            import shutil
            shutil.rmtree(self._mmap_dir, ignore_errors=True)

    def account_init_pass(self):
        """The index-initialization scan over the file (axis attrs)."""
        if self._closed:
            raise RuntimeError("init pass on a retired chunk")
        self.stats.init_rows += self.n

    def read_values(self, attr: str, rows):
        """Read attribute values for specific rows — THE accounted I/O.

        Numpy ``rows`` return numpy values (host data only); tensor
        ``rows`` return a gather on the dataset's device. The accounting
        is the same either way.
        """
        if self._closed:
            raise RuntimeError("read_values on a retired chunk")
        self.stats.rows_read += int(len(rows))
        self.stats.read_calls += 1
        if self.storage == "csv":
            self.stats.bytes_read += int(len(rows)) * self.CSV_WIDTH
            return self._text[attr][rows].astype(np.float32)
        self.stats.bytes_read += int(len(rows)) * self.ITEM_BYTES
        col = self._cols[attr]
        if isinstance(rows, torch.Tensor):
            if self.device is None:
                raise TypeError("tensor rows need a dataset built with "
                                "device=")
            return col[rows]
        return np.asarray(as_host(col)[rows], np.float32)

    def read_all_unaccounted(self, attr: str):
        """Test/oracle access — bypasses accounting (ground truth only).
        A tensor on the dataset's device, or numpy for host modes."""
        col = self._cols[attr]
        if isinstance(col, torch.Tensor):
            return col
        return np.asarray(col[:], np.float32)


def _to_device(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32).contiguous()
    return torch.from_numpy(
        np.ascontiguousarray(a, np.float32)).to(device)
