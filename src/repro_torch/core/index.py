"""VALINOR-style hierarchical tile index, capacity-bounded and flat.

Port of :mod:`repro.core.index` (``TileIndex``). The index organizes
objects into disjoint rectangular tiles over the two axis attributes and
keeps, per tile and per non-axis attribute, the aggregate metadata
``(count, sum, min, max)`` the confidence intervals are built from. It
is a fixed-capacity table of tiles plus one permutation of the object
set such that every tile owns a contiguous segment of it; a split
appends children, reorganizes the parent's segment and deactivates the
parent.

Where the state lives, by ``IndexConfig.backend``:

- ``"np"``: everything on the host in numpy — the reference's code,
  bit for bit (the dataset must hold host data).
- ``"torch"`` / ``"cuda"``: the object-side state — ``perm``, ``x_s``,
  ``y_s``, the columns — lives on the dataset's device. A round's gather
  indices are built there (``repeat_interleave``), the axis-only window
  masks run there as plain torch ops, the init sort and the split
  reorganization are stable device sorts, and the float64 control-plane
  reductions (init metadata, tile enrichment, per-child sums) run there
  in float64. The data-plane reductions are the kernels of
  :mod:`repro_torch.kernels.ops` ("torch": plain versions; "cuda": the
  CUDA kernels). The tile table, metadata and accumulators stay host
  numpy (capacity 65 536), as in the reference; each round moves only
  ``(S, 4)``-sized results (``(S, bx*by, 4)`` and the suffix widths for
  a heatmap round) to the host. So does the session bin-grid memory.

Metadata soundness rule: ``min/max`` for a tile are ALWAYS present and
sound (children's extremes are clamped into the parent's interval; the
root fallback is the global attribute min/max); ``sum`` is present only
when ``meta_valid``.

Refinement runs in two flavors with identical semantics: the sequential
reference path (:meth:`TileIndex.process`,
:meth:`TileIndex.process_heatmap`) and the batched pipeline
(:meth:`TileIndex.read_batch` / :meth:`TileIndex.read_batch_heatmap`,
then :meth:`TileIndex.apply_batch`). Heatmap splits cut along bin-aligned
edges (``IndexConfig.bin_aligned_splits``). :class:`EpochStage` defers a
serving tick's applies to one publication between ticks.
:class:`ChunkIndexSet` is the lazy per-chunk forest over a
:class:`~repro_torch.data.chunked.ChunkedDataset`: one ``TileIndex`` a
chunk, each with its own planes on the chunk's device.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.rawfile import RawDataset, as_host
from ..kernels import fused_select as fused_mod
from ..kernels import ops
from ..kernels import ref as ref_mod
from ..kernels.segment_agg import (EVERYWHERE, MAX_SEGMENTS, MAX_UNROLL,
                                   edge_cell_ids, segment_ids,
                                   window_bin_ids)
from . import geometry
from .geometry import FULL, PARTIAL


@dataclasses.dataclass
class IndexConfig:
    grid0: Tuple[int, int] = (16, 16)     # crude initial grid
    split_grid: Tuple[int, int] = (2, 2)  # paper's example splits 2×2
    capacity: int = 65536                 # max tiles (resource-aware bound)
    min_split_count: int = 256            # I/O-cost split factor (paper §2.2)
    max_level: int = 12
    batch_k: int = 8                      # tiles refined per batched round
    # heatmap refinement snaps split lines to the query's bin grid so
    # children nest inside single bins after ONE split (False ⇒ the even
    # 2×2-style subdivision everywhere)
    bin_aligned_splits: bool = True
    # bin-count-MATCHED split grids: a tile spanning s bins per axis gets
    # an s-child split (every inside bin line becomes a cut) up to this
    # per-axis cap; past the cap the split falls back to cap snapped cuts
    max_split_span: int = 4
    init_metadata_attrs: Sequence[str] = ()   # metadata computed at init pass
    backend: str = "cuda"                 # "np" | "torch" | "cuda"
    # an exact per-(tile, bin) registry keyed on (window, bins, attr): a
    # repeated heatmap folds previously-read tiles from the registry with
    # zero raw-file I/O; a split invalidates the parent's entry by
    # deactivating the tile. Never changes answers — only cost.
    session_bin_memory: bool = True
    # registries kept warm at once (LRU by last touch); 1 keeps a single
    # slot
    bin_memory_slots: int = 4

    def max_split_cells(self) -> int:
        """Upper bound on children per split — sizes the driver's heatmap
        rounds against ``MAX_UNROLL`` as in the reference."""
        gx, gy = self.split_grid
        if self.bin_aligned_splits:
            gx = max(gx, self.max_split_span)
            gy = max(gy, self.max_split_span)
        return gx * gy

    def __post_init__(self):
        gx, gy = self.split_grid
        if gx < 2 or gy < 2:
            raise ValueError(f"split_grid must be >= 2 per axis, got "
                             f"{self.split_grid}")
        if self.backend not in ops.BACKENDS:
            raise ValueError(f"backend must be one of {ops.BACKENDS}, got "
                             f"{self.backend!r}")
        if self.max_split_span < max(2, gx, gy):
            # the per-axis child cap must cover the base grid, or the
            # bin-matched edge builder could not honor its "<= cap+1
            # edges" contract (its fallbacks place g0 children)
            raise ValueError(
                f"max_split_span={self.max_split_span} must be >= "
                f"max(split_grid)={max(gx, gy)} (and >= 2)")
        if self.max_split_cells() > MAX_UNROLL:
            raise ValueError(
                f"max split grid {self.max_split_cells()} cells "
                f"(split_grid={self.split_grid}, max_split_span="
                f"{self.max_split_span}) exceeds the round-sizing limit "
                f"MAX_UNROLL={MAX_UNROLL}")


@dataclasses.dataclass
class AdaptStats:
    tiles_split: int = 0
    tiles_enriched: int = 0
    objects_reorganized: int = 0
    kernel_calls: int = 0      # data-plane kernel invocations (ops.*)
    batch_rounds: int = 0      # gathered-read refinement rounds
    speculative_rows: int = 0  # rows read in a round but never folded

    def snapshot(self):
        return dataclasses.replace(self)

    def delta(self, before):
        return AdaptStats(**{
            f.name: getattr(self, f.name) - getattr(before, f.name)
            for f in dataclasses.fields(self)})


def _host(a) -> np.ndarray:
    """A kernel result on the host (device results are (S, ·)-sized)."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _adjacent(a: torch.Tensor, b: torch.Tensor) -> bool:
    """``b`` lies right behind ``a`` in one buffer, both contiguous (the
    select kernels' table and suffix widths)."""
    return (a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()
            and a.is_contiguous() and b.is_contiguous()
            and b.storage_offset() == a.storage_offset() + a.numel())


def _host_pair(a: torch.Tensor, b: torch.Tensor):
    """Two device results on the host, in one device→host copy when they
    are :func:`_adjacent`."""
    if _adjacent(a, b):
        both = _host(torch.as_strided(a, (a.numel() + b.numel(),), (1,)))
        return (both[:a.numel()].reshape(a.shape),
                both[a.numel():].reshape(b.shape))
    return _host(a), _host(b)


def _segment_stats(vals: torch.Tensor, bounds: np.ndarray,
                   backend: str) -> np.ndarray:
    """Whole-segment float64 (count, sum, min, max) of ``vals`` over the
    segments ``bounds`` delimits: ``ops.segment_window_agg`` on
    ``backend`` ("torch": the plain version; "cuda": the kernel) under a
    ±inf window, one call per run of at most ``MAX_SEGMENTS`` segments
    (the kernel's boundary table), the rows concatenated on the device
    and copied to the host once.

    The ±inf window is recognised by every backend as the reference's
    mirror recognises it: nothing is compared (the kernel reads ``vals``
    alone), so every object counts, ±inf and NaN values included, and a
    NaN value makes its tile's sum, min and max NaN, as in the mirror."""
    rows = [ops.segment_window_agg(vals, vals, vals,
                                   bounds[a:a + MAX_SEGMENTS + 1],
                                   EVERYWHERE, backend=backend)
            for a in range(0, len(bounds) - 1, MAX_SEGMENTS)]
    return _host(rows[0] if len(rows) == 1 else torch.cat(rows))


def _check_split_counts(agg: np.ndarray, counts: np.ndarray) -> None:
    """The split kernel must bin every object where the reorganization
    puts it (the float64 ownership rule); a mismatch would desynchronize
    child metadata from child segments."""
    if not np.array_equal(agg[..., 0], counts):
        raise RuntimeError("split kernel cell counts disagree with the "
                           "host ownership rule")


class TileIndex:
    def __init__(self, dataset: RawDataset,
                 config: Optional[IndexConfig] = None):
        self._setup(dataset, config)
        config = self.cfg
        n = dataset.n

        # --- initialization pass (the "crude" index) ---
        gx, gy = config.grid0
        domain = dataset.domain()
        self.domain = domain
        if self._np:
            x, y = as_host(dataset.x), as_host(dataset.y)
            cell_ids = geometry.bin_cell_ids(x, y, domain, gx, gy)
            perm = np.argsort(cell_ids, kind="stable")
            self.perm = perm.astype(np.int64)      # file row id per slot
            self.x_s = x[perm]                     # axis values, perm order
            self.y_s = y[perm]
            counts = np.bincount(cell_ids, minlength=gx * gy)
        else:
            cell_ids = geometry.bin_cell_ids_f32(dataset.x, dataset.y,
                                                 domain, gx, gy)
            self.perm = torch.sort(cell_ids, stable=True).indices
            self.x_s = dataset.x[self.perm]
            self.y_s = dataset.y[self.perm]
            counts = _host(torch.bincount(cell_ids, minlength=gx * gy))
            del cell_ids
        assert counts.sum() == n
        offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
        boxes = geometry.subtile_bboxes(domain, gx, gy)
        t = gx * gy
        self.bbox[:t] = boxes
        self.offset[:t] = offsets
        self.count[:t] = counts
        self.active[:t] = True
        self.level[:t] = 0
        self.n_tiles = t
        dataset.account_init_pass()

        for attr in config.init_metadata_attrs:
            self.ensure_attr(attr)
            # init-pass metadata: one sequential file scan (accounted)
            vals = dataset.read_values(attr, self.perm)
            self._fill_meta_from_segments(attr, np.arange(t), vals)

    def _setup(self, dataset: RawDataset, config: Optional[IndexConfig]):
        """Tile table and metadata, empty; checks that the backend can
        reach the dataset's data (shared with ``state.index_from_numpy``)."""
        # config default must be constructed per instance — a dataclass
        # default instance would be shared (and mutable) across engines
        config = IndexConfig() if config is None else config
        dev = dataset.device
        if config.backend == "np" and dev is not None and dev.type != "cpu":
            raise TypeError("the 'np' backend needs host data; the dataset "
                            f"lives on {dev}")
        if config.backend == "torch" and dev is None:
            raise TypeError("the 'torch' backend needs a dataset built "
                            "with device=")
        if config.backend == "cuda" and (dev is None or dev.type != "cuda"):
            raise TypeError("the 'cuda' backend needs a dataset on a CUDA "
                            "device")
        self.ds = dataset
        self.cfg = config
        self.adapt_stats = AdaptStats()
        self._backend = config.backend
        self._np = config.backend == "np"
        cap = config.capacity

        # --- tile table (SoA) ---
        self.bbox = np.zeros((cap, 4), np.float64)
        self.offset = np.zeros(cap, np.int64)
        self.count = np.zeros(cap, np.int64)
        self.active = np.zeros(cap, bool)
        self.level = np.zeros(cap, np.int32)
        self.parent = np.full(cap, -1, np.int64)
        self.n_tiles = 0

        # --- per-attribute metadata ---
        # min/max always sound; sum valid only when meta_valid.
        self.meta_sum: Dict[str, np.ndarray] = {}
        self.meta_min: Dict[str, np.ndarray] = {}
        self.meta_max: Dict[str, np.ndarray] = {}
        self.meta_valid: Dict[str, np.ndarray] = {}
        self.global_minmax: Dict[str, Tuple[float, float]] = {}

        # session bin-grid memory (see IndexConfig.session_bin_memory):
        # an LRU of per-viewport registries {tile_id: (cnt_b, sum_b,
        # min_b, max_b)} (host numpy), keyed on (window, bins, attr);
        # _hm_key is the most recently touched viewport
        self._hm_key = None
        self._hm_regs: "OrderedDict[tuple, Dict[int, tuple]]" = \
            OrderedDict()

    # ------------------------------------------------------------------ #
    # attribute registration
    # ------------------------------------------------------------------ #
    def ensure_attr(self, attr: str):
        if attr in self.meta_sum:
            return
        cap = self.cfg.capacity
        if attr not in self.global_minmax:
            col = self.ds.read_all_unaccounted(attr)
            self.global_minmax[attr] = (float(col.min()), float(col.max()))
        g_lo, g_hi = self.global_minmax[attr]
        self.meta_sum[attr] = np.zeros(cap, np.float64)
        self.meta_min[attr] = np.full(cap, g_lo, np.float64)
        self.meta_max[attr] = np.full(cap, g_hi, np.float64)
        self.meta_valid[attr] = np.zeros(cap, bool)

    def _fill_meta_from_segments(self, attr, tile_ids, vals_perm_order):
        """Compute metadata for tiles from values given in perm order."""
        if not self._np:
            idx, bounds = self._gather_segments(tile_ids)
            st = _segment_stats(vals_perm_order[idx], bounds, self._backend)
            nz = self.count[tile_ids] > 0
            self.meta_sum[attr][tile_ids] = np.where(nz, st[:, 1], 0.0)
            self.meta_min[attr][tile_ids[nz]] = st[nz, 2]
            self.meta_max[attr][tile_ids[nz]] = st[nz, 3]
            self.meta_valid[attr][tile_ids] = True
            return
        for t in tile_ids:
            o, c = self.offset[t], self.count[t]
            if c == 0:
                self.meta_sum[attr][t] = 0.0
                self.meta_valid[attr][t] = True
                continue
            seg = vals_perm_order[o:o + c]
            self.meta_sum[attr][t] = float(seg.sum(dtype=np.float64))
            self.meta_min[attr][t] = float(seg.min())
            self.meta_max[attr][t] = float(seg.max())
            self.meta_valid[attr][t] = True

    # ------------------------------------------------------------------ #
    # part iteration / global-id resolution (chunked-forest seam)
    # ------------------------------------------------------------------ #
    def parts(self, window, attr=None, agg=None):
        """Yield ``(gid_base, TileIndex)`` per live part overlapping the
        window: a single TileIndex is its own only part, base 0."""
        yield 0, self

    def resolve(self, gid: int):
        """Map a global tile id to ``(TileIndex, local_tile_id)``."""
        return self, int(gid)

    # ------------------------------------------------------------------ #
    # query-side geometry + axis-only counting (no file access)
    # ------------------------------------------------------------------ #
    def classify(self, window):
        ids = np.flatnonzero(self.active[:self.n_tiles])
        cls = geometry.classify_tiles(self.bbox[ids], window)
        return ids[cls == FULL], ids[cls == PARTIAL]

    def _gather_segments(self, tile_ids: np.ndarray):
        """Gather indices + boundaries of the tiles' concatenated segments.

        Returns ``(idx, boundaries)``: ``idx`` (int64, (L,); a tensor on
        the device under "torch"/"cuda") indexes the perm-order arrays so
        that ``x_s[idx]`` is the concatenation of the tiles' segments;
        ``boundaries`` (host, (S+1,)) delimits segment s.
        """
        o = self.offset[tile_ids]
        c = self.count[tile_ids]
        boundaries = np.concatenate([[0], np.cumsum(c)]).astype(np.int64)
        if self._np:
            idx = np.repeat(o - boundaries[:-1], c) + np.arange(
                boundaries[-1], dtype=np.int64)
            return idx, boundaries
        dev = self.perm.device
        n = int(boundaries[-1])
        idx = torch.repeat_interleave(
            torch.from_numpy(o - boundaries[:-1]).to(dev),
            torch.from_numpy(c).to(dev), output_size=n)
        return idx + torch.arange(n, device=dev), boundaries

    def count_in_window_batch(self, tile_ids, window) -> np.ndarray:
        """Vectorized ``count(t ∩ Q)`` for many tiles — zero file I/O."""
        tile_ids = np.asarray(tile_ids, np.int64)
        if tile_ids.size == 0:
            return np.zeros(0, np.int64)
        idx, bounds = self._gather_segments(tile_ids)
        if self._np:
            m = ops.window_mask_np(self.x_s[idx], self.y_s[idx], window)
            cs = np.concatenate([[0], np.cumsum(m)])
            return (cs[bounds[1:]] - cs[bounds[:-1]]).astype(np.int64)
        m = ops.window_mask(self.x_s[idx], self.y_s[idx], window)
        cs = torch.cat([m.new_zeros(1, dtype=torch.int64),
                        torch.cumsum(m, 0)])
        b = torch.from_numpy(bounds).to(cs.device)
        return _host(cs[b[1:]] - cs[b[:-1]]).astype(np.int64)

    def bin_counts_in_window_batch(self, tile_ids, window, bins):
        """Vectorized ``count(t ∩ Q ∩ bin_b)`` for many tiles — zero file
        I/O: the ``(T, bx*by)`` per-bin in-window counts the grouped
        accumulator builds its pending intervals from. The binning is the
        processed contributions' own (``ref.window_bin_ids_np`` on the
        host, its tensor form ``segment_agg.window_bin_ids`` — bit for
        bit the same — on the device), so pending and folded counts
        agree exactly."""
        bx, by = bins
        nbins = bx * by
        tile_ids = np.asarray(tile_ids, np.int64)
        if tile_ids.size == 0:
            return np.zeros((0, nbins), np.int64)
        idx, bounds = self._gather_segments(tile_ids)
        if self._np:
            m, cid = ref_mod.window_bin_ids_np(self.x_s[idx], self.y_s[idx],
                                               window, bx, by)
            sid = np.repeat(np.arange(len(tile_ids)), np.diff(bounds))
            key = sid[m] * nbins + cid[m]
            return np.bincount(key, minlength=len(tile_ids) * nbins).reshape(
                len(tile_ids), nbins).astype(np.int64)
        m, cid = window_bin_ids(self.x_s[idx], self.y_s[idx], window, bx, by)
        sid = segment_ids(bounds, cid.device)
        key = (sid * nbins + cid)[m]
        return _host(torch.bincount(
            key, minlength=len(tile_ids) * nbins)).reshape(
                len(tile_ids), nbins).astype(np.int64)

    # ------------------------------------------------------------------ #
    # processing (the accounted, expensive path)
    # ------------------------------------------------------------------ #
    def process(self, tile_id: int, window, attr: str, *, split: bool = True):
        """The paper's ``process(t)``: read t's objects from the file,
        compute the exact in-window contribution, split t into sub-tiles,
        reorganize its object segment, and store sub-tile metadata.

        Returns (cnt_q, sum_q, min_q, max_q) — exact contribution of t∩Q,
        or ``None`` when the dataset retired mid-query.
        """
        if self.ds.closed:
            return None
        self.ensure_attr(attr)
        o, c = int(self.offset[tile_id]), int(self.count[tile_id])
        if c == 0:
            return (0, 0.0, np.inf, -np.inf)
        rows = self.perm[o:o + c]
        vals = self.ds.read_values(attr, rows)        # ← accounted file I/O
        xs, ys = self.x_s[o:o + c], self.y_s[o:o + c]

        if self._np:
            m = ops.window_mask_np(xs, ys, window)
            cnt_q = int(m.sum())
            if cnt_q:
                sel = vals[m]
                contrib = (cnt_q, float(sel.sum(dtype=np.float64)),
                           float(sel.min()), float(sel.max()))
            else:
                contrib = (0, 0.0, np.inf, -np.inf)
        else:
            st = _host(ops.segment_window_agg(
                xs, ys, vals, np.array([0, c], np.int64), window,
                backend=self._backend))[0]
            contrib = ((int(st[0]), float(st[1]), float(st[2]),
                        float(st[3])) if st[0] else (0, 0.0, np.inf, -np.inf))

        self._enrich_and_split(tile_id, vals, attr, split)
        return contrib

    def _enrich_and_split(self, tile_id: int, vals, attr: str, split: bool,
                          edges=None):
        """Shared processing epilogue: tile-level metadata enrichment
        (now exact for this attr) + the split-or-enrich decision.
        ``edges`` optionally carries bin-aligned split lines
        (``(x_edges, y_edges)``, see :meth:`_split`)."""
        if self._np:
            self.meta_sum[attr][tile_id] = float(vals.sum(dtype=np.float64))
            self.meta_min[attr][tile_id] = float(vals.min())
            self.meta_max[attr][tile_id] = float(vals.max())
        else:
            st = _segment_stats(vals, np.array([0, len(vals)], np.int64),
                                self._backend)[0]
            self.meta_sum[attr][tile_id] = float(st[1])
            self.meta_min[attr][tile_id] = float(st[2])
            self.meta_max[attr][tile_id] = float(st[3])
        self.meta_valid[attr][tile_id] = True
        if split:
            self._split(tile_id, vals, attr, edges=edges)
        else:
            self.adapt_stats.tiles_enriched += 1

    def heatmap_cache(self, window, bins, attr: str):
        """The session bin-grid registry for ``(window, bins, attr)``,
        or ``None`` when disabled. Registries live in a small LRU keyed
        on the exact viewport (``IndexConfig.bin_memory_slots``). Entries
        map an ACTIVE tile id to its exact per-bin in-window contribution
        ``(cnt_b, sum_b, min_b, max_b)`` (host numpy); a split tile's
        entry goes stale harmlessly — deactivated tiles are never
        classification candidates again. The key holds the window as
        Python floats: a tensor or float32 window would miss."""
        if not self.cfg.session_bin_memory:
            return None
        key = (tuple(float(v) for v in window), tuple(bins), attr)
        reg = self._hm_regs.get(key)
        if reg is None:
            reg = {}
            self._hm_regs[key] = reg
        else:
            self._hm_regs.move_to_end(key)
        while len(self._hm_regs) > max(1, int(self.cfg.bin_memory_slots)):
            self._hm_regs.popitem(last=False)
        self._hm_key = key
        return reg

    def _hm_record(self, cache, tile_id: int, contrib) -> None:
        """Register a processed tile's per-bin contribution — only while
        it stayed active (enriched, not split); children of a split are
        fresh tiles with no entry."""
        if cache is not None and self.active[tile_id]:
            cache[int(tile_id)] = contrib

    def process_heatmap(self, tile_id: int, window, attr: str, bins, *,
                        split: bool = True):
        """Sequential heatmap reference: one raw-file read + the tile's
        exact per-bin in-window contribution, then enrich/split exactly
        like :meth:`process`.

        Returns ``(cnt_b, sum_b, min_b, max_b)`` — per-bin host arrays of
        length ``bx*by`` (bin id = by_row*bx + bx_col) — or ``None``
        when the dataset retired mid-query. Under "torch"/"cuda" the
        contribution is one ``segment_window_bin_agg`` over the tile's
        device segment (S = 1).
        """
        if self.ds.closed:
            return None
        bx, by = bins
        nbins = bx * by
        self.ensure_attr(attr)
        o, c = int(self.offset[tile_id]), int(self.count[tile_id])
        if c == 0:
            return (np.zeros(nbins, np.int64), np.zeros(nbins),
                    np.full(nbins, np.inf), np.full(nbins, -np.inf))
        rows = self.perm[o:o + c]
        vals = self.ds.read_values(attr, rows)        # ← accounted file I/O
        xs, ys = self.x_s[o:o + c], self.y_s[o:o + c]

        one = np.array([0, c], np.int64)
        if self._np:
            agg = ref_mod.segment_window_bin_agg_np(xs, ys, vals, one,
                                                    window, bx, by)[0]
        else:
            agg = _host(ops.segment_window_bin_agg(
                xs, ys, vals, one, window, bx=bx, by=by,
                backend=self._backend))[0]

        # bin-aligned split lines: snap this tile's split edges to the
        # query's bin grid so children nest inside single bins (the
        # batched path computes the identical edges in read_batch_heatmap)
        edges = self._heatmap_split_edges(
            np.array([tile_id], np.int64), window, bins)
        self._enrich_and_split(tile_id, vals, attr, split,
                               edges=None if edges is None else edges[0])
        contrib = (agg[:, 0].astype(np.int64), agg[:, 1].copy(),
                   agg[:, 2].copy(), agg[:, 3].copy())
        self._hm_record(self.heatmap_cache(window, bins, attr),
                        tile_id, contrib)
        return contrib

    def _heatmap_split_edges(self, tile_ids: np.ndarray, window, bins):
        """Per-tile bin-aligned split edges for heatmap refinement, or
        ``None`` under the uniform-split policy: a list of ``(x_edges,
        y_edges)`` float64 pairs aligned with ``tile_ids``, whose lengths
        vary per tile (bin-count-matched grids, capped by
        ``IndexConfig.max_split_span``). The one place both the
        sequential and batched paths derive their split lines from."""
        if not self.cfg.bin_aligned_splits:
            return None
        bx, by = bins
        return [geometry.bin_matched_split_edges(
                    self.bbox[t], window, bx, by,
                    base=self.cfg.split_grid, cap=self.cfg.max_split_span)
                for t in tile_ids]

    def can_split(self, tile_id: int, k: Optional[int] = None) -> bool:
        """``k`` — children the intended split appends (defaults to the
        even ``split_grid``; bin-count-matched splits pass their own)."""
        gx, gy = self.cfg.split_grid
        k = gx * gy if k is None else int(k)
        return (self.count[tile_id] >= self.cfg.min_split_count
                and self.level[tile_id] < self.cfg.max_level
                and self.n_tiles + k <= self.cfg.capacity)

    def _split(self, tile_id: int, vals, attr: str, edges=None):
        """Split + reorganize + per-child metadata (one binned pass).

        ``edges=(x_edges, y_edges)`` cuts along explicit (bin-aligned)
        split lines instead of the even gx×gy subdivision; ownership is
        then ``geometry.edge_cell_ids``'s float64 rule, child metadata
        comes from ``segment_bin_agg_edges``, and the split grid is the
        edges' own.
        """
        if edges is None:
            gx, gy = self.cfg.split_grid
        else:
            gx, gy = len(edges[0]) - 1, len(edges[1]) - 1
        if not self.can_split(tile_id, gx * gy):
            self.adapt_stats.tiles_enriched += 1
            return
        o, c = int(self.offset[tile_id]), int(self.count[tile_id])
        # NOTE: copies, not views — the segment reorganization below
        # writes into self.x_s/y_s in place and bin_agg must see the
        # pristine (coordinate, value)-aligned arrays
        xs = self.x_s[o:o + c].copy() if self._np else \
            self.x_s[o:o + c].clone()
        ys = self.y_s[o:o + c].copy() if self._np else \
            self.y_s[o:o + c].clone()
        bbox = self.bbox[tile_id]

        if self._np:
            cell = (geometry.bin_cell_ids(xs, ys, bbox, gx, gy)
                    if edges is None else
                    geometry.edge_cell_ids(xs, ys, edges[0], edges[1]))
            counts = np.bincount(cell, minlength=gx * gy)
        else:
            sid = torch.zeros(c, dtype=torch.int64, device=xs.device)
            cell = (geometry.segment_cell_ids(xs, ys, sid, bbox[None],
                                              gx, gy)
                    if edges is None else
                    edge_cell_ids(xs, ys, sid, edges[0][None],
                                  edges[1][None]))
            counts = _host(torch.bincount(cell, minlength=gx * gy))
        boxes = (geometry.subtile_bboxes(bbox, gx, gy) if edges is None
                 else geometry.bboxes_from_edges(edges[0], edges[1]))
        child_off = o + np.concatenate([[0], np.cumsum(counts)[:-1]])

        # child metadata for the processed attribute: one binned pass
        # (data plane — the bin_agg or segment_bin_agg_edges kernel)
        if edges is None:
            agg = _host(ops.bin_agg(xs, ys, vals, bbox, gx=gx, gy=gy,
                                    backend=self._backend))
        else:
            agg = _host(ops.segment_bin_agg_edges(
                xs, ys, vals, np.array([0, c], np.int64), edges[0][None],
                edges[1][None], backend=self._backend))[0]
        self.adapt_stats.kernel_calls += 1

        if self._np:
            order = np.argsort(cell, kind="stable")
        else:
            _check_split_counts(agg, counts)
            order = torch.sort(cell, stable=True).indices
        # local reorganization of the parent's segment
        self.perm[o:o + c] = self.perm[o:o + c][order]
        self.x_s[o:o + c] = xs[order]
        self.y_s[o:o + c] = ys[order]
        vals_sorted = vals[order]
        self.adapt_stats.objects_reorganized += c

        t0 = self.n_tiles
        k = gx * gy
        sl = slice(t0, t0 + k)
        self.bbox[sl] = boxes
        self.offset[sl] = child_off
        self.count[sl] = counts
        self.active[sl] = True
        self.level[sl] = self.level[tile_id] + 1
        self.parent[sl] = tile_id
        self.n_tiles += k
        self.active[tile_id] = False

        for a in self.meta_sum:
            if a == attr:
                nonzero = counts > 0
                # the parent's bounds are exact (just enriched) and sound;
                # clamp children into the parent's interval so metadata
                # soundness holds exactly
                pmn = self.meta_min[a][tile_id]
                pmx = self.meta_max[a][tile_id]
                self.meta_sum[a][sl] = agg[:, 1].astype(np.float64)
                self.meta_min[a][sl] = np.where(
                    nonzero, np.maximum(agg[:, 2], pmn), pmn)
                self.meta_max[a][sl] = np.where(
                    nonzero, np.minimum(agg[:, 3], pmx), pmx)
                self.meta_valid[a][sl] = True
                # exact f64 sums per child, in the control plane's order
                if self._np:
                    for j in range(k):
                        oj, cj = child_off[j], counts[j]
                        self.meta_sum[a][t0 + j] = float(
                            vals_sorted[oj - o:oj - o + cj].sum(
                                dtype=np.float64))
                else:
                    self.meta_sum[a][sl] = _segment_stats(
                        vals_sorted, np.concatenate([[0], np.cumsum(counts)]),
                        self._backend)[:, 1]
            else:
                # inherit sound min/max bounds; sum unknown for children
                self.meta_min[a][sl] = self.meta_min[a][tile_id]
                self.meta_max[a][sl] = self.meta_max[a][tile_id]
                self.meta_valid[a][sl] = False
        self.adapt_stats.tiles_split += 1

    # ------------------------------------------------------------------ #
    # batched processing (the amortized, crack-in-batch path)
    # ------------------------------------------------------------------ #
    def _dead_batch(self, tile_ids, attr: str):
        """Degraded phase-1 result when the dataset retired mid-query:
        every contribution is ``None`` and the payload is inert."""
        tile_ids = np.asarray(tile_ids, np.int64)
        payload = {"tile_ids": tile_ids,
                   "bounds": np.zeros(len(tile_ids) + 1, np.int64),
                   "attr": attr, "dead": True}
        return [None] * len(tile_ids), payload

    def _read_batch_gather(self, tile_ids, attr: str):
        """Shared phase-1 plumbing of a batched refinement round: ONE
        gathered ``read_values`` over the tiles' concatenated segments,
        plus the :meth:`apply_batch` payload describing them."""
        self.ensure_attr(attr)
        tile_ids = np.asarray(tile_ids, np.int64)
        idx, bounds = self._gather_segments(tile_ids)
        rows = self.perm[idx]
        vals = self.ds.read_values(attr, rows)     # ← ONE accounted read
        xs, ys = self.x_s[idx], self.y_s[idx]
        self.adapt_stats.batch_rounds += 1
        payload = {"tile_ids": tile_ids, "idx": idx, "bounds": bounds,
                   "xs": xs, "ys": ys, "vals": vals, "attr": attr}
        return tile_ids, idx, bounds, xs, ys, vals, payload

    def read_batch(self, tile_ids, window, attr: str):
        """Phase 1 of a batched refinement round: ONE gathered
        ``read_values`` over the tiles' concatenated segments and ONE
        packed ``segment_window_agg`` kernel give every tile's exact
        in-window contribution. No index state is mutated.

        Returns ``(contribs, payload)``: ``contribs`` is a list of
        ``(cnt_q, sum_q, min_q, max_q)`` aligned with ``tile_ids``;
        ``payload`` carries the gathered segments for :meth:`apply_batch`.
        Under "np" the contributions are bit for bit the sequential
        path's; under "torch"/"cuda" the sums are float64 in another
        order (counts and extrema exact).
        """
        if self.ds.closed:
            return self._dead_batch(tile_ids, attr)
        tile_ids, idx, bounds, xs, ys, vals, payload = \
            self._read_batch_gather(tile_ids, attr)
        # exact in-window contributions: one packed kernel over the batch
        contrib = _host(ops.segment_window_agg(
            xs, ys, vals, bounds, window, backend=self._backend))
        self.adapt_stats.kernel_calls += 1
        contribs = [
            (int(contrib[s, 0]), float(contrib[s, 1]),
             float(contrib[s, 2]), float(contrib[s, 3]))
            if contrib[s, 0] else (0, 0.0, np.inf, -np.inf)
            for s in range(len(tile_ids))]
        return contribs, payload

    def read_batch_heatmap(self, tile_ids, window, attr: str, bins):
        """Phase 1 of a batched HEATMAP refinement round.

        Like :meth:`read_batch`, but the single packed pass is the fused
        ``segment_window_bin_select``: every tile's exact per-bin
        in-window contribution from one gathered read, plus the
        selection-ready suffix widths of the tiles' sound value bounds
        (``payload["suffix_w"]``, fold order). ``contribs`` is a list of
        ``(cnt_b, sum_b, min_b, max_b)`` per-bin host arrays aligned with
        ``tile_ids``; ``payload`` is what :meth:`apply_batch` consumes.

        Under "np" the pass is the float64 host mirror, bit for bit the
        sequential path's. Under "torch"/"cuda" the gathered segments
        stay on the device and the pass is the plain version or the CUDA
        kernel: its sums are float64 (in another order), its counts and
        extrema bit for bit the mirror's — the kernel sums in float64,
        unlike the Pallas kernels the reference keeps off this path —
        and only the ``(S, bx*by, 4)`` table and ``suffix_w`` cross to
        the host.
        """
        if self.ds.closed:
            return self._dead_batch(tile_ids, attr)
        bx, by = bins
        tile_ids, idx, bounds, xs, ys, vals, payload = \
            self._read_batch_gather(tile_ids, attr)
        vmin_s = self.meta_min[attr][tile_ids]
        vmax_s = self.meta_max[attr][tile_ids]
        if self._np:
            agg, suffix_w = fused_mod.segment_window_bin_select_np(
                xs, ys, vals, bounds, window, bx, by, vmin_s, vmax_s)
        else:
            agg, suffix_w = _host_pair(*ops.segment_window_bin_select(
                xs, ys, vals, bounds, window, vmin_s, vmax_s, bx=bx, by=by,
                backend=self._backend))
        payload["suffix_w"] = suffix_w
        self.adapt_stats.kernel_calls += 1
        # bin-aligned split lines for every tile of the round (the same
        # edges process_heatmap computes) — apply_batch slices the folded
        # prefix, keeping the index evolution identical to sequential
        payload["split_edges"] = self._heatmap_split_edges(
            tile_ids, window, bins)
        contribs = [
            (agg[s, :, 0].astype(np.int64), agg[s, :, 1].copy(),
             agg[s, :, 2].copy(), agg[s, :, 3].copy())
            for s in range(len(tile_ids))]
        # session bin-grid memory: apply_batch registers the FOLDED
        # prefix (speculatively-read tiles stay unregistered, exactly as
        # under sequential processing); the payload carries the registry
        # KEY, so an apply after the registry was evicted drops the
        # registration instead of writing into another viewport's
        cache = self.heatmap_cache(window, bins, attr)
        payload["hm_key"] = self._hm_key if cache is not None else None
        payload["hm_contribs"] = contribs
        return contribs, payload

    def apply_batch(self, payload, n_used: int, split_flags):
        """Phase 2: enrich + split the round's first ``n_used`` tiles.

        Tiles past ``n_used`` (read speculatively but never folded) are
        left untouched, so the index evolves exactly as under sequential
        processing. ``split_flags[i]`` requests a split for tile i of the
        prefix (subject to the split rule, evaluated in order with
        in-round capacity growth). Maximal consecutive runs of tiles
        sharing one split grid (the even grid, or a bin-aligned round's
        per-tile edges) split in one packed pass each, children appended
        in fold order; heatmap rounds then register the folded,
        still-active tiles in the session bin-grid memory.
        """
        if n_used == 0 or payload.get("dead"):
            return
        attr = payload["attr"]
        tile_ids = payload["tile_ids"][:n_used]
        bounds = payload["bounds"][:n_used + 1]
        end = int(bounds[-1])
        idx = payload["idx"][:end]
        xs, ys = payload["xs"][:end], payload["ys"][:end]
        vals = payload["vals"][:end]
        counts = np.diff(bounds)

        # tile-level enrichment — control-plane metadata, float64 (on the
        # host under "np", on the device otherwise)
        if self._np:
            full = ref_mod.segment_window_agg_np(xs, ys, vals, bounds,
                                                 EVERYWHERE)
        else:
            full = _segment_stats(vals, bounds, self._backend)
        nz = counts > 0
        self.meta_sum[attr][tile_ids[nz]] = full[nz, 1]
        self.meta_min[attr][tile_ids[nz]] = full[nz, 2]
        self.meta_max[attr][tile_ids[nz]] = full[nz, 3]
        self.meta_valid[attr][tile_ids[nz]] = True

        # split decisions in order, accounting in-round capacity growth;
        # per-tile child counts vary under bin-count-matched split grids
        # (the edges carry each tile's own grid)
        gx, gy = self.cfg.split_grid
        edges_l = payload.get("split_edges")
        ks = [gx * gy if edges_l is None else
              (len(edges_l[i][0]) - 1) * (len(edges_l[i][1]) - 1)
              for i in range(len(tile_ids))]
        nt = self.n_tiles
        will_split = np.zeros(len(tile_ids), bool)
        for i, t in enumerate(tile_ids):
            if not (split_flags[i] and counts[i] > 0):
                continue
            if (self.count[t] >= self.cfg.min_split_count
                    and self.level[t] < self.cfg.max_level
                    and nt + ks[i] <= self.cfg.capacity):
                will_split[i] = True
                nt += ks[i]
        self.adapt_stats.tiles_enriched += int(nz.sum() - will_split.sum())

        # pack maximal CONSECUTIVE runs of same-grid tiles into one
        # _split_batch call each: per-tile grids stay batch-composition
        # invariant AND children get the same ids as under sequential
        # processing (run grouping preserves the fold order)
        def grid(i):
            return ks[i] if edges_l is None else (len(edges_l[i][0]),
                                                  len(edges_l[i][1]))

        pos = np.flatnonzero(will_split)
        r = 0
        while r < len(pos):
            s = r + 1
            while s < len(pos) and grid(pos[s]) == grid(pos[r]):
                s += 1
            run = pos[r:s]
            mask = np.zeros(len(tile_ids), bool)
            mask[run] = True
            e = None if edges_l is None else (
                np.stack([edges_l[i][0] for i in run]),
                np.stack([edges_l[i][1] for i in run]))
            # boolean indexing copies, and xs/ys are gathered copies to
            # begin with — _split_batch may reorganize x_s/y_s in place
            if self._np:
                keep = np.repeat(mask, counts)
            else:
                dev = vals.device
                keep = torch.repeat_interleave(
                    torch.from_numpy(mask).to(dev),
                    torch.from_numpy(counts).to(dev), output_size=end)
            self._split_batch(tile_ids[run], idx[keep], xs[keep], ys[keep],
                              vals[keep], attr, edges=e)
            r = s

        # heatmap rounds: register the folded, still-active tiles in the
        # session bin-grid memory (mirrors process_heatmap), resolved by
        # KEY — an evicted registry drops the registration
        key = payload.get("hm_key")
        reg = None if key is None else self._hm_regs.get(key)
        if reg is not None:
            contribs = payload["hm_contribs"]
            for i, t in enumerate(tile_ids):
                self._hm_record(reg, t, contribs[i])

    def _split_batch(self, parents, idx, xs, ys, vals, attr: str,
                     edges=None):
        """Vectorized multi-tile split: every parent's segment is binned
        against its own bbox — or its own bin-aligned split edges, when
        ``edges=(x_edges (S, gx+1), y_edges (S, gy+1))`` is given —
        reorganized in place, and ALL children are appended in one SoA
        update. ``idx/xs/ys/vals`` cover the parents' concatenated
        segments (pristine copies, concat order). The split grid is the
        edges' own when given (one shared (gx, gy) per call), else the
        even ``split_grid``."""
        if edges is None:
            gx, gy = self.cfg.split_grid
        else:
            gx, gy = edges[0].shape[1] - 1, edges[1].shape[1] - 1
        k = gx * gy
        s_n = len(parents)
        off = self.offset[parents]
        cnt = self.count[parents]
        bboxes = self.bbox[parents]
        bounds = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int64)

        # per-element cell ids under each parent's own ownership rule
        if self._np:
            sid = np.repeat(np.arange(s_n), cnt)
            if edges is None:
                cw = np.maximum((bboxes[:, 2] - bboxes[:, 0]) / gx, 1e-30)
                ch = np.maximum((bboxes[:, 3] - bboxes[:, 1]) / gy, 1e-30)
                cx = np.clip(np.floor((xs - bboxes[sid, 0]) / cw[sid]).astype(
                    np.int64), 0, gx - 1)
                cy = np.clip(np.floor((ys - bboxes[sid, 1]) / ch[sid]).astype(
                    np.int64), 0, gy - 1)
                key = sid * k + cy * gx + cx
            else:
                key = sid * k + geometry.edge_cell_ids_segmented(
                    xs, ys, edges[0], edges[1], sid)
            counts_sk = np.bincount(key, minlength=s_n * k).reshape(s_n, k)
        else:
            sid = segment_ids(bounds, xs.device)
            key = (geometry.segment_cell_ids(xs, ys, sid, bboxes, gx, gy)
                   if edges is None else
                   sid * k + edge_cell_ids(xs, ys, sid, edges[0],
                                           edges[1]))
            counts_sk = _host(torch.bincount(
                key, minlength=s_n * k)).reshape(s_n, k)
        child_off = off[:, None] + np.concatenate(
            [np.zeros((s_n, 1), np.int64),
             np.cumsum(counts_sk, axis=1)[:, :-1]], axis=1)

        # child metadata for the processed attribute: one packed kernel
        if edges is None:
            agg = _host(ops.segment_bin_agg(
                xs, ys, vals, bounds, bboxes, gx=gx, gy=gy,
                backend=self._backend))
        else:
            agg = _host(ops.segment_bin_agg_edges(
                xs, ys, vals, bounds, edges[0], edges[1],
                backend=self._backend))
        self.adapt_stats.kernel_calls += 1

        # one global stable sort reorganizes every parent's segment
        # (keys are segment-major, so the permutation never crosses
        # segment boundaries — identical to the per-tile counting sort)
        if self._np:
            order = np.argsort(key, kind="stable")
        else:
            _check_split_counts(agg, counts_sk)
            order = torch.sort(key, stable=True).indices
        self.perm[idx] = self.perm[idx][order]
        self.x_s[idx] = xs[order]
        self.y_s[idx] = ys[order]
        vals_sorted = vals[order]
        self.adapt_stats.objects_reorganized += int(cnt.sum())

        # one SoA append for all children of all parents
        t0 = self.n_tiles
        sl = slice(t0, t0 + s_n * k)
        self.bbox[sl] = np.concatenate(
            [geometry.subtile_bboxes(b, gx, gy) for b in bboxes]
            if edges is None else
            [geometry.bboxes_from_edges(edges[0][s], edges[1][s])
             for s in range(s_n)])
        self.offset[sl] = child_off.reshape(-1)
        self.count[sl] = counts_sk.reshape(-1)
        self.active[sl] = True
        self.level[sl] = np.repeat(self.level[parents] + 1, k)
        self.parent[sl] = np.repeat(parents, k)
        self.n_tiles += s_n * k
        self.active[parents] = False

        rel_off = child_off - off[:, None] + bounds[:-1, None]
        for a in self.meta_sum:
            if a == attr:
                nonzero = counts_sk > 0
                pmn = self.meta_min[a][parents][:, None]
                pmx = self.meta_max[a][parents][:, None]
                # clamp kernel extremes into the parents' sound
                # intervals (same rule as the sequential _split)
                self.meta_min[a][sl] = np.where(
                    nonzero, np.maximum(agg[:, :, 2], pmn), pmn).reshape(-1)
                self.meta_max[a][sl] = np.where(
                    nonzero, np.minimum(agg[:, :, 3], pmx), pmx).reshape(-1)
                self.meta_valid[a][sl] = True
                # exact f64 sums per child, in the control plane's order
                flat_cnt = counts_sk.reshape(-1)
                if self._np:
                    flat_rel = rel_off.reshape(-1)
                    sums = np.empty(s_n * k, np.float64)
                    for j in range(s_n * k):
                        sums[j] = vals_sorted[flat_rel[j]:flat_rel[j] +
                                              flat_cnt[j]].sum(
                                                  dtype=np.float64)
                else:
                    # children are contiguous in key order
                    sums = _segment_stats(vals_sorted, np.concatenate(
                        [[0], np.cumsum(flat_cnt)]), self._backend)[:, 1]
                self.meta_sum[a][sl] = sums
            else:
                # inherit sound min/max bounds; sum unknown for children
                self.meta_min[a][sl] = np.repeat(self.meta_min[a][parents], k)
                self.meta_max[a][sl] = np.repeat(self.meta_max[a][parents], k)
                self.meta_valid[a][sl] = False
        self.adapt_stats.tiles_split += s_n

    # ------------------------------------------------------------------ #
    # invariant checking (used by property tests and the chip smoke)
    # ------------------------------------------------------------------ #
    def check_invariants(self, attr: Optional[str] = None):
        ids = np.flatnonzero(self.active[:self.n_tiles])
        assert self.count[ids].sum() == self.ds.n, "object conservation"
        # Extent containment is approximate BY the ownership rule: init
        # cells are assigned in float32, so a boundary point can round
        # one cell up/down relative to the f64 bbox edges — an excursion
        # of up to ~1 f32 ulp at domain scale. Membership — and therefore
        # metadata — stays exact.
        scale = max(1.0, float(np.abs(np.asarray(self.domain)).max()))
        tol = max(1e-6, 2.0 * float(np.finfo(np.float32).eps) * scale)
        if not self._np:
            self._check_invariants_device(ids, attr, tol)
            return
        assert len(np.unique(np.sort(self.perm))) == self.ds.n, \
            "perm is a permutation"
        for t in ids:
            o, c = self.offset[t], self.count[t]
            if c == 0:
                continue
            x0, y0, x1, y1 = self.bbox[t]
            xs, ys = self.x_s[o:o + c], self.y_s[o:o + c]
            assert (xs >= x0 - tol).all() and (xs <= x1 + tol).all()
            assert (ys >= y0 - tol).all() and (ys <= y1 + tol).all()
        if attr is not None and attr in self.meta_sum:
            col = as_host(self.ds.read_all_unaccounted(attr))
            for t in ids:
                o, c = self.offset[t], self.count[t]
                seg = col[self.perm[o:o + c]]
                if c:
                    # exact: values are f32 end-to-end, min/max reductions
                    # do not round, and child bounds are clamped into the
                    # parent's sound interval at split time
                    assert seg.min() >= self.meta_min[attr][t]
                    assert seg.max() <= self.meta_max[attr][t]
                if self.meta_valid[attr][t] and c:
                    np.testing.assert_allclose(
                        seg.sum(dtype=np.float64), self.meta_sum[attr][t],
                        rtol=1e-6, atol=1e-4)

    def _check_invariants_device(self, ids, attr, tol):
        """The same invariants with one segmented reduction per check:
        the active tiles, in offset order, must tile the permutation (an
        empty tile shares its offset with the next segment and sorts
        before it)."""
        n = self.ds.n
        dev = self.perm.device
        assert torch.equal(torch.sort(self.perm).values,
                           torch.arange(n, device=dev)), \
            "perm is a permutation"
        ids = ids[np.lexsort((self.count[ids] > 0, self.offset[ids]))]
        cnt = self.count[ids]
        bounds = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int64)
        assert np.array_equal(self.offset[ids], bounds[:-1]), \
            "active segments tile the permutation"
        nz = cnt > 0
        bb = self.bbox[ids]
        for plane, lo, hi in ((self.x_s, bb[:, 0], bb[:, 2]),
                              (self.y_s, bb[:, 1], bb[:, 3])):
            st = _segment_stats(plane, bounds, self._backend)
            assert (st[nz, 2] >= lo[nz] - tol).all()
            assert (st[nz, 3] <= hi[nz] + tol).all()
        if attr is not None and attr in self.meta_sum:
            col = self.ds.read_all_unaccounted(attr)
            st = _segment_stats(col[self.perm], bounds, self._backend)
            assert (st[nz, 2] >= self.meta_min[attr][ids[nz]]).all()
            assert (st[nz, 3] <= self.meta_max[attr][ids[nz]]).all()
            v = nz & self.meta_valid[attr][ids]
            np.testing.assert_allclose(st[v, 1], self.meta_sum[attr][ids[v]],
                                       rtol=1e-6, atol=1e-4)

    @property
    def n_active(self) -> int:
        return int(self.active[:self.n_tiles].sum())


class EpochStage:
    """Staged (epoch-deferred) application of refinement rounds.

    The serving layer's isolation mechanism: during a tick every query
    reads against ONE frozen index epoch — rounds that would normally
    enrich/split tiles in place (:meth:`TileIndex.apply_batch`) are
    STAGED here instead, and :meth:`publish` applies them all at once
    between ticks. Because no read happens while publish runs, no
    reader can ever observe a half-applied split: an epoch is either
    entirely pre-publish or entirely post-publish.

    Publication is canonicalized two ways so the micro-batched and
    sequential-reference serving modes produce bit-for-bit identical
    index evolution:

    - entries publish in ``(owner, staging-seq)`` order — i.e. per
      query in arrival order, each query's rounds in round order —
      which is exactly the order the sequential reference stages them;
    - a tile is split by its FIRST claimant only: when two same-tick
      queries both request a split of tile t, the later request is
      masked to an enrichment (its exact metadata write is idempotent),
      so the split grid/edges applied are deterministic and the tile
      can never be split twice.

    Under "torch"/"cuda" a staged payload holds its round's gathered
    device segments until publication.
    """

    def __init__(self):
        self._entries = []       # (owner, seq, tile_index, payload,
        #                           n_used, split_flags)
        self._seq = 0
        self._owner = 0

    def set_owner(self, owner: int) -> None:
        """Tag subsequent staged rounds with the owning query's arrival
        index (the publication sort key)."""
        self._owner = int(owner)

    @property
    def n_staged(self) -> int:
        return len(self._entries)

    def stage_apply(self, index, payload, n_used: int, split_flags):
        """Driver seam: called where the driver would call
        ``index.apply_batch``. Composite (chunk-forest) payloads are
        decomposed into their per-chunk runs here, with the driver's
        global folded prefix routed per run exactly as
        :meth:`ChunkIndexSet.apply_batch` would."""
        runs = payload.get("runs")
        if runs is None:
            self._entries.append((self._owner, self._seq, index, payload,
                                  int(n_used), list(split_flags[:n_used])))
            self._seq += 1
            return
        for ti, p, s, e in runs:
            used = min(max(n_used - s, 0), e - s)
            self._entries.append((self._owner, self._seq, ti, p, used,
                                  list(split_flags[s:s + used])))
            self._seq += 1

    def publish(self) -> Dict[str, int]:
        """Apply every staged round atomically (no concurrent readers by
        construction — the tick has quiesced). Returns publication
        counters: rounds applied and split requests masked by the
        first-claimant rule."""
        entries = sorted(self._entries, key=lambda en: (en[0], en[1]))
        self._entries = []
        claimed = set()
        masked = 0
        applied = 0
        for _, _, ti, payload, used, flags in entries:
            if used == 0 or payload.get("dead"):
                continue
            eff = []
            for i, t in enumerate(payload["tile_ids"][:used]):
                want = bool(flags[i])
                key = (id(ti), int(t))
                if want and key in claimed:
                    want = False
                    masked += 1
                elif want:
                    claimed.add(key)
                eff.append(want)
            ti.apply_batch(payload, used, eff)
            applied += 1
        return {"rounds_published": applied, "splits_masked": masked}


def _chunk_overlaps(bbox, window) -> bool:
    """Closed-interval bbox/window overlap — the same edge semantics as
    :func:`geometry.classify_tiles` (a shared edge is NOT disjoint)."""
    x0, y0, x1, y1 = bbox
    qx0, qy0, qx1, qy1 = window
    return not (x1 < qx0 or x0 > qx1 or y1 < qy0 or y0 > qy1)


def composite_payload(tile_ids, runs, attr: str):
    """A chunk forest's round payload: its same-chunk runs ``(TileIndex,
    payload, s, e)``, in order, under GLOBAL segment bounds (the
    driver's speculative accounting reads them)."""
    g_bounds, base = [np.zeros(1, np.int64)], 0
    for _, p, _, _ in runs:
        g_bounds.append(base + p["bounds"][1:])
        base += int(p["bounds"][-1])
    return {"tile_ids": tile_ids, "bounds": np.concatenate(g_bounds),
            "runs": runs, "attr": attr}


class ChunkIndexSet:
    """A chunk-local tile forest over a ``ChunkedDataset``.

    Each live chunk gets its own :class:`TileIndex`, materialized LAZILY
    on the first query whose window overlaps the chunk's axis bounding
    box: until then the chunk costs zero I/O, not even the axis
    initialization pass. A chunk whose bbox is disjoint from the window
    is pruned wholesale (``IOStats.pruned_calls``), again with zero read
    calls. Retiring a chunk drops its forest at the next :meth:`prepare`,
    and with it the forest's device planes (``perm``, ``x_s``, ``y_s``).

    Global tile ids are ``gid = chunk_id * capacity + local_tile_id``
    (chunk ids are never reused, so gids are unique for the session).
    Chunk 0's gids equal its local ids, so a single chunk scores, folds
    and refines like a plain ``TileIndex``.

    The forest presents the driver surface of ``TileIndex`` (``cfg``,
    ``adapt_stats``, ``ensure_attr``, ``resolve``, ``read_batch`` /
    ``read_batch_heatmap`` / ``apply_batch``): a batched round's tile ids
    are grouped into consecutive same-chunk runs, one gathered read and
    one kernel pass per run, refolded under the driver's global prefix
    rule — the ``RefinementDriver`` itself is chunk-agnostic.

    ``check_invariants``, ``n_tiles`` and ``n_active`` cover the live
    chunks' forests only: a forest of a chunk retired since the last
    ``prepare`` is dead (its dataset's columns are gone).
    """

    def __init__(self, dataset, config: Optional[IndexConfig] = None):
        config = IndexConfig() if config is None else config
        self.ds = dataset
        self.cfg = config
        self.adapt_stats = AdaptStats()
        self._stride = config.capacity
        self._indexes: Dict[int, TileIndex] = {}

    # -- forest lifecycle --------------------------------------------

    def index_for(self, chunk) -> TileIndex:
        """The chunk's TileIndex, built on first touch (accounted as the
        chunk's own init pass + init-metadata reads)."""
        ti = self._indexes.get(chunk.chunk_id)
        if ti is None:
            ti = TileIndex(chunk.data, self.cfg)
            # one shared adaptation ledger across the forest
            ti.adapt_stats = self.adapt_stats
            self._indexes[chunk.chunk_id] = ti
        return ti

    def built_ids(self) -> Tuple[int, ...]:
        """Chunk ids whose index has been materialized."""
        return tuple(self._indexes.keys())

    def prepare(self, window, attr: str) -> None:
        """Pre-query housekeeping: drop forests of retired chunks and
        lazily build indexes for live chunks overlapping the window. The
        engine calls this BEFORE its per-query I/O snapshot, so build
        cost is accounted like legacy index construction — at build
        time, not inside a query's delta."""
        live = set(self.ds.live_ids)
        for cid in list(self._indexes):
            if cid not in live:
                del self._indexes[cid]
        for chunk in self.ds.chunks():
            if _chunk_overlaps(chunk.bbox, window):
                self.index_for(chunk).ensure_attr(attr)

    # -- driver / query surface --------------------------------------

    def parts(self, window, attr=None, agg=None):
        """Yield ``(gid_base, TileIndex)`` per live, non-pruned chunk in
        ingest order; pruned chunks are accounted (``pruned_calls``) and
        cost nothing else. Two pruning stages, both zero file I/O: the
        axis bbox, then — for ``agg in ("min", "max")`` with a known
        ``attr`` — the value zone map (:meth:`_value_pruned`)."""
        cand = []
        for chunk in self.ds.chunks():
            if _chunk_overlaps(chunk.bbox, window):
                cand.append(chunk)
            else:
                chunk.stats.pruned_calls += 1
        drop = self._value_pruned(cand, window, attr, agg)
        for chunk in cand:
            if chunk.chunk_id in drop:
                chunk.stats.pruned_calls += 1
            else:
                yield chunk.chunk_id * self._stride, self.index_for(chunk)

    def _occupied(self, chunk, window) -> bool:
        """Does the chunk have at least one row inside the window?
        Answered from the chunk index's resident axis planes — zero file
        I/O (``prepare`` has built overlapping indexes). Reached only by
        min/max queries over two or more candidate chunks."""
        ti = self.index_for(chunk)
        full, partial = ti.classify(window)
        if full.size and int(ti.count[full].sum()) > 0:
            return True
        if partial.size == 0:
            return False
        return int(ti.count_in_window_batch(partial, window).sum()) > 0

    def _value_pruned(self, cand, window, attr, agg):
        """Chunk ids value-pruned by the ingest-time zone maps.

        Only ``min``/``max`` admit sound whole-chunk value pruning. Rule
        for ``min``: any chunk with a row in the window bounds the
        answer above by its zone-map high, so ``U = min(hi_c over
        occupied chunks)`` and a chunk with ``lo_c > U`` (strict) cannot
        contain the window minimum. Symmetric for ``max``."""
        if agg not in ("min", "max") or attr is None or len(cand) < 2:
            return set()
        ranges = [c.val_range.get(attr) for c in cand]
        if any(r is None for r in ranges):
            return set()          # zone map unavailable: prune nothing
        occ = [c for c in cand if self._occupied(c, window)]
        if not occ:
            return set()
        if agg == "min":
            u = min(c.val_range[attr][1] for c in occ)
            return {c.chunk_id for c in cand if c.val_range[attr][0] > u}
        u = max(c.val_range[attr][0] for c in occ)
        return {c.chunk_id for c in cand if c.val_range[attr][1] < u}

    def resolve(self, gid: int):
        """Map a global tile id to ``(TileIndex, local_tile_id)``."""
        cid, local = divmod(int(gid), self._stride)
        return self._indexes[cid], local

    def ensure_attr(self, attr: str) -> None:
        for ti in self._indexes.values():
            ti.ensure_attr(attr)

    def _chunk_runs(self, tile_ids: np.ndarray):
        """Split a round's gid list into maximal consecutive same-chunk
        runs ``(s, e)`` (preserving the driver's score order)."""
        if len(tile_ids) == 0:
            return []
        cids = tile_ids // self._stride
        cut = np.flatnonzero(cids[1:] != cids[:-1]) + 1
        starts = np.concatenate([[0], cut, [len(tile_ids)]])
        return [(int(starts[i]), int(starts[i + 1]))
                for i in range(len(starts) - 1)]

    def _read_batch_runs(self, tile_ids, window, attr: str, bins=None):
        """One gathered read and one kernel pass per same-chunk run; a
        composite payload with GLOBAL segment bounds for the driver's
        speculative accounting. A driver round is ONE round however many
        chunks it straddles — each per-chunk read bumps the shared
        ``batch_rounds``, so the overcount is corrected here, counting
        only the runs that read: a retired chunk's run reads nothing and
        bumps nothing, and a round of such runs alone is no round, as
        under one ``TileIndex`` (the reference subtracts a round for
        every run past the first, dead or not, ROADMAP C.9).
        ``read_calls`` keeps counting per gathered read."""
        tile_ids = np.asarray(tile_ids, np.int64)
        runs = []
        contribs = []
        for s, e in self._chunk_runs(tile_ids):
            ti, _ = self.resolve(tile_ids[s])
            local = tile_ids[s:e] % self._stride
            if bins is None:
                c, p = ti.read_batch(local, window, attr)
            else:
                c, p = ti.read_batch_heatmap(local, window, attr, bins)
            contribs.extend(c)
            runs.append((ti, p, s, e))
        read = sum(not p.get("dead") for _, p, _, _ in runs)
        self.adapt_stats.batch_rounds -= read - min(read, 1)
        return contribs, composite_payload(tile_ids, runs, attr)

    def read_batch(self, tile_ids, window, attr: str):
        return self._read_batch_runs(tile_ids, window, attr)

    def read_batch_heatmap(self, tile_ids, window, attr: str, bins):
        return self._read_batch_runs(tile_ids, window, attr, bins)

    def apply_batch(self, payload, n_used: int, split_flags) -> None:
        """Route the driver's global folded prefix to each run's own
        ``TileIndex.apply_batch``: a run entirely past the fold point
        gets ``n_used=0`` (its speculative reads leave the chunk's index
        untouched)."""
        for ti, p, s, e in payload["runs"]:
            used = min(max(n_used - s, 0), e - s)
            ti.apply_batch(p, used, list(split_flags[s:s + used]))

    # -- invariants / aggregates over LIVE forests -------------------

    def live_forests(self):
        """``(chunk_id, TileIndex)`` of the built forests whose chunk is
        live and readable, in build order."""
        return [(cid, ti) for cid, ti in self._indexes.items()
                if self.ds.is_live(cid) and not ti.ds.closed]

    def check_invariants(self, attr: Optional[str] = None) -> None:
        for _, ti in self.live_forests():
            ti.check_invariants(attr)

    @property
    def n_tiles(self) -> int:
        return sum(ti.n_tiles for _, ti in self.live_forests())

    @property
    def n_active(self) -> int:
        return sum(ti.n_active for _, ti in self.live_forests())
