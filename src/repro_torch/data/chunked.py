"""Range-partitioned, streaming raw data: an ordered set of chunks.

Port of :mod:`repro.data.chunked`. A file broken into ordered chunks —
each an independent :class:`~repro_torch.data.rawfile.RawDataset` with
its own :class:`~repro_torch.data.rawfile.IOStats` — so that:

- the index layer (``ChunkIndexSet``) builds a chunk-local tile forest
  lazily, on the first query whose window overlaps the chunk's axis
  bounding box;
- chunks whose bounding box is disjoint from the query window, or whose
  value zone map cannot hold a min/max answer, are pruned with ZERO read
  calls (accounted in ``IOStats.pruned_calls``);
- ``ingest`` appends new data mid-session and ``retire`` drops the
  oldest chunks for rolling retention, bounding memory by the working
  set instead of the file size.

Placement follows ``device=`` (default ``"cuda"``), passed to every
chunk's ``RawDataset``: on a device each chunk's columns are resident
there, and retiring a chunk releases them. ``csv`` and ``mmap`` are host
modes and take ``device=None``.

Chunk ids are assigned monotonically and never reused, so a retired
chunk's id stays dead — the index layer uses ``chunk_id`` as the high
bits of its global tile ids.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .rawfile import IOStats, RawDataset, resolve_device

STORAGES = ("array", "csv", "mmap")


@dataclasses.dataclass
class Chunk:
    """One live partition: an independent RawDataset, its axis bbox and
    its per-attribute value-range zone map."""
    chunk_id: int
    data: RawDataset
    bbox: Tuple[float, float, float, float]  # (x0, y0, x1, y1)
    # write-time zone map: attr -> (min, max) over the WHOLE chunk,
    # computed once at ingest; lets the index layer prune chunks whose
    # value range cannot affect a min/max aggregate at zero read cost
    val_range: Dict[str, Tuple[float, float]] = \
        dataclasses.field(default_factory=dict)

    @property
    def n(self) -> int:
        return self.data.n

    @property
    def stats(self) -> IOStats:
        return self.data.stats


def _zone_map(ds: RawDataset) -> Dict[str, Tuple[float, float]]:
    """Per-attribute ``(min, max)`` as Python floats, equal to
    ``float(np.min(v))`` / ``float(np.max(v))`` on the float32 column, a
    NaN included. Device columns: one ``aminmax`` pass each and ONE copy
    of all of them to the host."""
    attrs = list(ds.attributes)
    cols = [ds.read_all_unaccounted(a) for a in attrs]
    if cols and isinstance(cols[0], torch.Tensor):
        mm = torch.stack([torch.stack(torch.aminmax(c)) for c in cols])
        mm = mm.cpu().numpy()
        return {a: (float(mm[i, 0]), float(mm[i, 1]))
                for i, a in enumerate(attrs)}
    return {a: (float(np.min(v)), float(np.max(v)))
            for a, v in zip(attrs, cols)}


class ChunkedDataset:
    """An append-only ordered sequence of chunks with rolling retention.

    Presents the read surface of ``RawDataset`` (``n``, ``x``, ``y``,
    ``attributes``, ``domain()``, ``read_all_unaccounted``, ``stats``,
    ``device``) aggregated over the *live* chunks, for the oracles.
    Accounted reads never go through the aggregate surface — the index
    layer reads each chunk's own ``RawDataset``. On a device ``x``,
    ``y`` and ``read_all_unaccounted`` are a ``torch.cat`` of the live
    chunks' planes.

    ``ingest(..., storage=...)`` may give one chunk another storage mode
    than the dataset default; ``storage="mmap"`` then needs a directory,
    from the per-call ``mmap_dir=`` or else the constructor's, and
    raises ``ValueError`` without one.
    """

    def __init__(self, storage: str = "array",
                 mmap_dir: Optional[str] = None, device="cuda"):
        if storage not in STORAGES:
            raise ValueError(f"unknown storage mode {storage!r}")
        if storage == "mmap" and mmap_dir is None:
            raise ValueError("storage='mmap' requires mmap_dir")
        self.device = resolve_device(device)
        if self.device is not None and storage != "array":
            raise ValueError("csv/mmap storage are host modes: pass "
                             "device=None with them")
        self.storage = storage
        self._mmap_dir = mmap_dir
        self._chunks: Dict[int, Chunk] = {}   # live, insertion-ordered
        self._next_id = 0
        # retired chunks' final counters, so aggregate stats (and any
        # outstanding snapshot/delta pairs) stay monotone across retire
        self._retired_stats = IOStats()

    # -- lifecycle ---------------------------------------------------

    def ingest(self, x, y, columns: Dict[str, np.ndarray], *,
               storage: Optional[str] = None,
               mmap_dir: Optional[str] = None) -> int:
        """Append a new chunk on the dataset's device; returns its id.

        ``storage`` overrides the dataset default for THIS chunk only;
        ``storage="mmap"`` resolves its directory from the per-call
        ``mmap_dir`` first, then the constructor's — a clear
        ``ValueError`` if neither is set.
        """
        if len(x) == 0:
            raise ValueError("cannot ingest an empty chunk")
        storage = self.storage if storage is None else storage
        if storage not in STORAGES:
            raise ValueError(f"unknown storage mode {storage!r}")
        chunk_dir = None
        if storage == "mmap":
            base = mmap_dir if mmap_dir is not None else self._mmap_dir
            if base is None:
                raise ValueError(
                    "storage='mmap' needs a directory: pass mmap_dir= to "
                    "ingest() or construct the ChunkedDataset with one")
            chunk_dir = os.path.join(base, f"chunk_{self._next_id:05d}")
        ds = RawDataset(x, y, columns, mmap_dir=chunk_dir, storage=storage,
                        device=self.device)
        return self.ingest_dataset(ds)

    def ingest_dataset(self, ds: RawDataset) -> int:
        """Append a pre-built RawDataset as a chunk (no copy); returns its
        id. Records the chunk's value-range zone map — an ingest-time
        scan, unaccounted like the axis bbox."""
        if ds.n == 0:
            raise ValueError("cannot ingest an empty chunk")
        cid = self._next_id
        self._next_id += 1
        self._chunks[cid] = Chunk(cid, ds, ds.domain(), _zone_map(ds))
        return cid

    def retire(self, chunk_id: int) -> None:
        """Drop a chunk (rolling retention). Its final I/O counters are
        folded into the aggregate so deltas never go negative; its
        columns are released and any later read of it raises."""
        chunk = self._chunks.pop(chunk_id)   # KeyError if not live
        self._retired_stats = self._retired_stats.merge(chunk.stats)
        chunk.data.close()

    # -- live-chunk access -------------------------------------------

    def chunks(self) -> List[Chunk]:
        """Live chunks in ingest order."""
        return list(self._chunks.values())

    def chunk(self, chunk_id: int) -> Chunk:
        return self._chunks[chunk_id]

    def is_live(self, chunk_id: int) -> bool:
        return chunk_id in self._chunks

    @property
    def live_ids(self) -> Sequence[int]:
        return tuple(self._chunks.keys())

    @property
    def n_chunks(self) -> int:
        return len(self._chunks)

    # -- RawDataset-compatible aggregate surface ---------------------

    @property
    def n(self) -> int:
        return sum(c.n for c in self._chunks.values())

    @property
    def x(self):
        return self._concat([c.data.x for c in self._chunks.values()])

    @property
    def y(self):
        return self._concat([c.data.y for c in self._chunks.values()])

    def _concat(self, parts):
        if self.device is not None:
            if not parts:
                return torch.empty(0, dtype=torch.float32,
                                   device=self.device)
            return parts[0] if len(parts) == 1 else torch.cat(parts)
        if not parts:
            return np.empty(0, np.float32)
        return np.concatenate(parts)

    @property
    def attributes(self) -> Sequence[str]:
        for c in self._chunks.values():
            return c.data.attributes
        return ()

    def domain(self):
        """(x0, y0, x1, y1) over the live chunks' bounding boxes."""
        boxes = [c.bbox for c in self._chunks.values()]
        if not boxes:
            return (0.0, 0.0, 0.0, 0.0)
        return (min(b[0] for b in boxes), min(b[1] for b in boxes),
                max(b[2] for b in boxes), max(b[3] for b in boxes))

    def read_all_unaccounted(self, attr: str):
        """Oracle access over live chunks — ground truth only."""
        return self._concat([c.data.read_all_unaccounted(attr)
                             for c in self._chunks.values()])

    @property
    def stats(self) -> IOStats:
        """Aggregate I/O counters: live chunks + retired history. A fresh
        value each access; ``.snapshot()`` / ``.delta()`` as with
        ``RawDataset.stats``."""
        out = self._retired_stats
        for c in self._chunks.values():
            out = out.merge(c.stats)
        return out

    # -- convenience -------------------------------------------------

    @classmethod
    def from_dataset(cls, ds: RawDataset) -> "ChunkedDataset":
        """Wrap an existing RawDataset as a single-chunk dataset, without
        copying its planes (the degenerate case: reproduces the legacy
        engine)."""
        out = cls(storage=ds.storage if ds.storage != "mmap" else "array",
                  device=ds.device)
        out.ingest_dataset(ds)
        return out
