"""Synthetic dataset generator matching the paper's evaluation setup.

Port of :mod:`repro.data.synthetic`: clustered 2-D points plus uniform
background and ten heterogeneous numeric columns, the shape of the
VALINOR/VETI synthetic file the paper evaluates on (10 columns, 11 GB,
about 10⁸ rows). The arrays come from the SAME numpy ``default_rng``
streams as the reference, so a seed gives the reference's arrays bit for
bit; they are then moved to the requested device.
:func:`make_streaming_chunks` gives the streaming workload's
range-partitioned chunks (B8) as numpy arrays.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .rawfile import RawDataset


def make_synthetic_dataset(n: int = 2_000_000, n_columns: int = 10,
                           n_clusters: int = 24, cluster_frac: float = 0.7,
                           domain: float = 1000.0, seed: int = 7,
                           mmap_dir: Optional[str] = None,
                           storage: str = "array",
                           device="cuda") -> RawDataset:
    """Clustered 2-D points + ``n_columns`` non-axis numeric attributes
    (normal, lognormal, uniform, bimodal by column index mod 4).
    ``device`` as in :class:`RawDataset` (``None`` keeps host numpy)."""
    rng = np.random.default_rng(seed)
    n_clustered = int(n * cluster_frac)
    n_uniform = n - n_clustered

    centers = rng.uniform(0.05 * domain, 0.95 * domain, size=(n_clusters, 2))
    scales = rng.uniform(0.01 * domain, 0.05 * domain, size=n_clusters)
    assign = rng.integers(0, n_clusters, size=n_clustered)
    pts = centers[assign] + rng.normal(
        0, 1, size=(n_clustered, 2)) * scales[assign, None]
    uni = rng.uniform(0, domain, size=(n_uniform, 2))
    xy = np.concatenate([pts, uni], axis=0)
    del pts, uni
    np.clip(xy, 0, domain, out=xy)
    order = rng.permutation(n)  # file order is not spatial order (raw CSV)
    xy = xy[order]
    del order

    cols = {}
    for j in range(n_columns):
        kind = j % 4
        if kind == 0:
            v = rng.normal(50.0 + 10 * j, 15.0, size=n)
        elif kind == 1:
            v = rng.lognormal(mean=2.0, sigma=0.6, size=n)
        elif kind == 2:
            v = rng.uniform(-100.0, 100.0, size=n)
        else:
            sel = rng.random(n) < 0.5
            v = np.where(sel, rng.normal(-40, 8, size=n),
                         rng.normal(40, 8, size=n))
        cols[f"a{j}"] = v.astype(np.float32)

    return RawDataset(xy[:, 0].astype(np.float32),
                      xy[:, 1].astype(np.float32), cols,
                      mmap_dir=mmap_dir, storage=storage, device=device)


def make_streaming_chunks(n_chunks: int = 10,
                          rows_per_chunk: int = 200_000,
                          n_columns: int = 4, domain: float = 1000.0,
                          seed: int = 7):
    """Range-partitioned arrival chunks for the streaming workload (B8).

    Chunk ``i`` covers the x-slab ``[i*W, (i+1)*W)`` with
    ``W = domain / n_chunks`` — x plays the role of arrival time, so a
    "time-windowed" query is an x-range over the most recent chunks and
    older chunks prune on their axis bounding box. Within a chunk, y is
    clustered (two Gaussian bands + uniform background) and the value
    columns reuse the heterogeneous distributions of
    :func:`make_synthetic_dataset`.

    Returns a list of ``(x, y, columns)`` numpy tuples ready for
    ``ChunkedDataset.ingest`` — the reference's arrays, bit for bit (the
    same ``default_rng`` stream); ``ingest`` moves them to the dataset's
    device.
    """
    rng = np.random.default_rng(seed)
    width = domain / n_chunks
    chunks = []
    for i in range(n_chunks):
        n = rows_per_chunk
        x = rng.uniform(i * width, (i + 1) * width, size=n)
        # avoid touching the next slab's lower edge (half-open ranges)
        x = np.minimum(x, np.nextafter((i + 1) * width, 0.0))
        band = rng.random(n)
        c0, c1 = rng.uniform(0.15 * domain, 0.85 * domain, size=2)
        y = np.where(
            band < 0.4, rng.normal(c0, 0.04 * domain, size=n),
            np.where(band < 0.7, rng.normal(c1, 0.06 * domain, size=n),
                     rng.uniform(0, domain, size=n)))
        y = np.clip(y, 0, domain)
        cols = {}
        for j in range(n_columns):
            kind = j % 4
            if kind == 0:
                v = rng.normal(50.0 + 10 * j, 15.0, size=n)
            elif kind == 1:
                v = rng.lognormal(mean=2.0, sigma=0.6, size=n)
            elif kind == 2:
                v = rng.uniform(-100.0, 100.0, size=n)
            else:
                sel = rng.random(n) < 0.5
                v = np.where(sel, rng.normal(-40, 8, size=n),
                             rng.normal(40, 8, size=n))
            cols[f"a{j}"] = v.astype(np.float32)
        chunks.append((x.astype(np.float32), y.astype(np.float32), cols))
    return chunks


def _densest_cell(x, y, bins: int):
    """``argmax`` of ``np.histogram2d(x, y, bins)`` as (x cell, y cell).

    For tensors the counting runs on the device with numpy's own rule
    (``histogramdd``): f32 edges ``linspace(min, max, bins + 1)``, a
    right-sided ``searchsorted`` per axis, values equal to the last edge
    moved into the last cell — so the chosen cell is the reference's.
    """
    if not isinstance(x, torch.Tensor):
        h = np.histogram2d(x, y, bins=bins)[0]
        return np.unravel_index(np.argmax(h), h.shape)
    cells = []
    for a in (x, y):
        lo, hi = np.float32(a.min().item()), np.float32(a.max().item())
        if lo == hi:
            lo, hi = lo - 0.5, hi + 0.5
        edges = torch.from_numpy(np.linspace(lo, hi, bins + 1)).to(a.device)
        c = torch.searchsorted(edges, a, right=True)
        c = c - (a == edges[-1]).to(c.dtype)
        cells.append(c - 1)
    key = cells[0] * bins + cells[1]
    h = torch.bincount(key, minlength=bins * bins).cpu().numpy()
    return np.unravel_index(np.argmax(h.reshape(bins, bins)), (bins, bins))


def exploration_path(dataset: RawDataset, n_queries: int = 50,
                     target_objects: int = 100_000,
                     shift_frac=(0.10, 0.20), seed: int = 11):
    """The paper's query workload: a window holding ~``target_objects``
    objects, shifted 10–20% randomly per step (map-style exploration).
    Returns a list of (x0, y0, x1, y1) windows of Python floats — the
    reference's windows, bit for bit."""
    rng = np.random.default_rng(seed)
    x0d, y0d, x1d, y1d = dataset.domain()
    area = (x1d - x0d) * (y1d - y0d)
    frac = target_objects / dataset.n
    side = float(np.sqrt(area * frac))

    # Start inside a dense region: pick the densest coarse cell.
    ci, cj = _densest_cell(dataset.x, dataset.y, 24)
    xe, ye = np.linspace(x0d, x1d, 25), np.linspace(y0d, y1d, 25)
    cx = 0.5 * (xe[ci] + xe[ci + 1])
    cy = 0.5 * (ye[cj] + ye[cj + 1])

    windows = []
    for _ in range(n_queries):
        x0 = np.clip(cx - side / 2, x0d, x1d - side)
        y0 = np.clip(cy - side / 2, y0d, y1d - side)
        windows.append((float(x0), float(y0),
                        float(x0 + side), float(y0 + side)))
        mag = rng.uniform(*shift_frac) * side
        ang = rng.uniform(0, 2 * np.pi)
        cx = float(np.clip(cx + mag * np.cos(ang), x0d + side / 2,
                           x1d - side / 2))
        cy = float(np.clip(cy + mag * np.sin(ang), y0d + side / 2,
                           y1d - side / 2))
    return windows
