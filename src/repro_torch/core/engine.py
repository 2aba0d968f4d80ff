"""AQPEngine — the public API of the paper's contribution (port).

>>> from repro_torch.core import AQPEngine, IndexConfig
>>> from repro_torch.data import make_synthetic_dataset
>>> ds = make_synthetic_dataset(n=100_000)          # on the card
>>> eng = AQPEngine(ds, IndexConfig(init_metadata_attrs=("a0",)))
>>> r = eng.query((100, 100, 300, 300), "mean", "a0", phi=0.05)

>>> h = eng.heatmap((100, 100, 300, 300), "mean", "a0", bins=(8, 8),
...                 phi=0.05)

The engine owns one adaptive tile index per dataset — a ``TileIndex``
over a ``RawDataset``, or a lazy per-chunk ``ChunkIndexSet`` over a
``ChunkedDataset`` — and evaluates window
aggregate and heatmap (2-D group-by) queries under a per-query accuracy
constraint φ (φ=0 ⇒ exact), recording a per-query trace (time, objects
read, tiles processed) and the session's viewport trajectory. Both query
types refine through one ``RefinementDriver``; :meth:`AQPEngine.serve`
shares the engine's index with a concurrent multi-session server.
Predictive prefetch and the learned-salience policy come with a later
slice of the port (``ROADMAP.md`` queue A, item 8); their entry points
raise until then.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

from ..data.chunked import ChunkedDataset
from ..data.rawfile import RawDataset
from . import query as query_mod
from .bounds import AccuracyPolicy, HeatmapResult, QueryResult
from .index import ChunkIndexSet, IndexConfig, TileIndex
from .predict import TrajectoryStep


@dataclasses.dataclass
class EngineTrace:
    """Per-query instrumentation (scalar and heatmap results alike) plus
    the session's viewport trajectory (one
    :class:`~repro_torch.core.predict.TrajectoryStep` per query) and its
    prefetch reports (none until prefetch is ported)."""

    results: List[Union[QueryResult, HeatmapResult]] = dataclasses.field(
        default_factory=list)
    trajectory: List[TrajectoryStep] = dataclasses.field(
        default_factory=list)
    prefetches: List[dict] = dataclasses.field(default_factory=list)

    def totals(self):
        """Session totals, plus a per-query-type (scalar vs heatmap)
        breakdown so mixed sessions can attribute I/O."""
        out = {
            "queries": len(self.results),
            "total_time_s": sum(r.eval_time_s for r in self.results),
            "total_objects_read": sum(r.objects_read for r in self.results),
            "total_tiles_processed": sum(r.tiles_processed
                                         for r in self.results),
            "total_read_calls": sum(r.read_calls for r in self.results),
            "total_batch_rounds": sum(r.batch_rounds
                                      for r in self.results),
            "total_speculative_rows": sum(r.speculative_rows
                                          for r in self.results),
            "total_pruned_chunks": sum(r.pruned_chunks
                                       for r in self.results),
        }
        for kind, rs in (
                ("scalar", [r for r in self.results
                            if isinstance(r, QueryResult)]),
                ("heatmap", [r for r in self.results
                             if isinstance(r, HeatmapResult)])):
            out[f"{kind}_queries"] = len(rs)
            out[f"{kind}_objects_read"] = sum(r.objects_read for r in rs)
            out[f"{kind}_read_calls"] = sum(r.read_calls for r in rs)
            out[f"{kind}_time_s"] = sum(r.eval_time_s for r in rs)
            out[f"{kind}_speculative_rows"] = sum(r.speculative_rows
                                                  for r in rs)
        out["prefetches"] = len(self.prefetches)
        out["prefetch_rows"] = sum(p["rows_read"] for p in self.prefetches)
        return out


class AQPEngine:
    def __init__(self, dataset: Union[RawDataset, ChunkedDataset],
                 config: Optional[IndexConfig] = None,
                 alpha: float = 1.0):
        self.dataset = dataset
        if isinstance(dataset, ChunkedDataset):
            # chunk-local forest: per-chunk TileIndexes are built lazily
            # on the first overlapping query, so construction touches no
            # data; a single chunk reproduces the legacy engine
            config = IndexConfig() if config is None else config
            self.index = ChunkIndexSet(dataset, config)
        else:
            self.index = TileIndex(dataset, config)
        self.alpha = alpha
        self.trace = EngineTrace()

    def query(self, window: Tuple[float, float, float, float], agg: str,
              attr: str, phi: float = 0.0,
              alpha: Optional[float] = None,
              batch_k: Optional[int] = None,
              sequential: bool = False,
              dwell_s: float = 1.0) -> QueryResult:
        """Evaluate one window-aggregate query.

        phi: relative accuracy constraint (0 ⇒ exact answering).
        batch_k: tiles refined per batched round (one gathered read + one
          packed kernel pass per round); defaults to ``IndexConfig.batch_k``.
        sequential: the per-tile reference refinement path.
        dwell_s: how long the user dwelled on this viewport (recorded on
          the trajectory).
        """
        r = query_mod.evaluate(self.index, window, agg, attr, phi=phi,
                               alpha=self.alpha if alpha is None else alpha,
                               batch_k=batch_k, sequential=sequential)
        self.trace.results.append(r)
        self.trace.trajectory.append(TrajectoryStep(
            tuple(float(v) for v in window), None, float(dwell_s)))
        return r

    def heatmap(self, window: Tuple[float, float, float, float], agg: str,
                attr: str, bins: Tuple[int, int] = (8, 8),
                phi: float = 0.0, alpha: Optional[float] = None,
                policy: Optional[AccuracyPolicy] = None,
                batch_k: Optional[int] = None,
                sequential: bool = False,
                dwell_s: float = 1.0) -> HeatmapResult:
        """Evaluate one φ-constrained heatmap (group-by) query.

        bins: (bx, by) grid laid over the window; bin id = by_row*bx +
          bx_col (``HeatmapResult.grid()`` reshapes to (by, bx)).
        phi: per-bin relative accuracy constraint — refinement stops once
          EVERY occupied bin's relative bound is ≤ φ (0 ⇒ exact).
        policy: optional :class:`~repro_torch.core.bounds.AccuracyPolicy`
          allocating the constraint per bin (φ_b from user weights ×
          salience, plus an absolute-error floor ε_abs). A policy with
          ``salience="learned"`` raises: its resolver, the viewport
          predictor, is not ported yet.
        batch_k / sequential / dwell_s: as in :meth:`query`.
        """
        if (policy is not None and isinstance(policy.salience, str)
                and policy.salience == "learned"):
            raise NotImplementedError(
                "salience='learned' needs the viewport predictor, which is "
                "not ported yet (ROADMAP.md queue A, item 8)")
        r = query_mod.evaluate_heatmap(
            self.index, window, agg, attr, bins=bins, phi=phi,
            alpha=self.alpha if alpha is None else alpha, policy=policy,
            batch_k=batch_k, sequential=sequential)
        self.trace.results.append(r)
        self.trace.trajectory.append(TrajectoryStep(
            tuple(float(v) for v in window), (int(bins[0]), int(bins[1])),
            float(dwell_s)))
        return r

    def prefetch(self, *args, **kwargs):
        raise NotImplementedError(
            "predictive prefetch is not ported yet (ROADMAP.md queue A, "
            "item 8)")

    def serve(self, *, mode: str = "batched",
              crack_budget: Optional[int] = None,
              prefetch_rows: Optional[int] = None):
        """Lift this engine into a concurrent multi-session server.

        Returns a :class:`~repro_torch.core.serving.ServingEngine`
        wrapping THIS engine's index: sessions opened on it share the
        one adaptive index, same-tick queries are micro-batched into
        fused gathered reads and packed multi-window kernel passes, and
        index mutation is isolated behind epoch publication. Each session
        carries its own :class:`EngineTrace`; queries served through
        ``serve()`` are recorded there, not on ``self.trace``.

        mode: "batched" (micro-batched ticks) or "sequential" (per-query
          reference path — same answers and same published index).
        crack_budget: max queries per tick allowed to stage index
          mutations, granted round-robin across sessions (None ⇒
          unlimited).
        prefetch_rows: predictive pre-cracking; anything but ``None``
          raises until the viewport predictor is ported.
        """
        from .serving import ServingEngine
        return ServingEngine(self, mode=mode, crack_budget=crack_budget,
                             prefetch_rows=prefetch_rows)

    def oracle(self, window, agg: str, attr: str) -> float:
        return query_mod.evaluate_oracle(self.index, window, agg, attr)

    def heatmap_oracle(self, window, agg: str, attr: str,
                       bins: Tuple[int, int] = (8, 8)):
        return query_mod.evaluate_heatmap_oracle(self.index, window, agg,
                                                 attr, bins)

    @property
    def io_stats(self):
        return self.dataset.stats

    @property
    def adapt_stats(self):
        return self.index.adapt_stats
