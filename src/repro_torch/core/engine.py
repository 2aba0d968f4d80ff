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
The trajectory feeds a :class:`~repro_torch.core.predict.
ViewportPredictor` on the dataset's device: :meth:`AQPEngine.prefetch`
pre-cracks the predicted next viewport under a hard row budget, and a
policy with ``salience="learned"`` is resolved from the session's dwell
histogram before evaluation.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

from ..data.chunked import ChunkedDataset
from ..data.rawfile import RawDataset
from . import query as query_mod
from .bounds import AccuracyPolicy, HeatmapResult, QueryResult
from .index import ChunkIndexSet, IndexConfig, TileIndex
from .predict import (TrajectoryStep, ViewportPredictor, prefetch_crack,
                      resolve_learned_salience)


@dataclasses.dataclass
class EngineTrace:
    """Per-query instrumentation (scalar and heatmap results alike) plus
    the session's viewport trajectory (one
    :class:`~repro_torch.core.predict.TrajectoryStep` per query) and its
    prefetch reports."""

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
        # session trajectory → next-viewport prediction (prefetch()) and
        # learned salience (policy salience="learned"); the model trains
        # where the data lives (the host for host-mode datasets)
        self.predictor = ViewportPredictor(device=dataset.device or "cpu")
        self._last_attr: Optional[str] = None
        self._last_bins: Tuple[int, int] = (8, 8)

    def _observe(self, window, bins, attr: str, dwell_s: float) -> None:
        """Record one served viewport on the trajectory (trace + the
        predictor's online model/hit-rate update)."""
        self.trace.trajectory.append(TrajectoryStep(
            tuple(float(v) for v in window),
            None if bins is None else (int(bins[0]), int(bins[1])),
            float(dwell_s)))
        self.predictor.observe(window, bins=bins, dwell_s=dwell_s)
        self._last_attr = attr
        if bins is not None:
            self._last_bins = (int(bins[0]), int(bins[1]))

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
        dwell_s: how long the user dwelled on this viewport — weights the
          learned-salience histogram (default 1 ⇒ uniform dwell).
        """
        r = query_mod.evaluate(self.index, window, agg, attr, phi=phi,
                               alpha=self.alpha if alpha is None else alpha,
                               batch_k=batch_k, sequential=sequential)
        self.trace.results.append(r)
        self._observe(window, None, attr, dwell_s)
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
          salience, plus an absolute-error floor ε_abs).
          ``salience="learned"`` is resolved here into the session's
          dwell histogram over PAST viewports (see
          :mod:`repro_torch.core.predict`).
        batch_k / sequential / dwell_s: as in :meth:`query`.
        """
        policy = resolve_learned_salience(policy, self.predictor, window,
                                          bins)
        r = query_mod.evaluate_heatmap(
            self.index, window, agg, attr, bins=bins, phi=phi,
            alpha=self.alpha if alpha is None else alpha, policy=policy,
            batch_k=batch_k, sequential=sequential)
        self.trace.results.append(r)
        self._observe(window, bins, attr, dwell_s)
        return r

    def prefetch(self, budget_rows: int, attr: Optional[str] = None,
                 bins: Optional[Tuple[int, int]] = None,
                 alpha: Optional[float] = None) -> dict:
        """Crack the PREDICTED next viewport under a hard row budget.

        Uses the session trajectory's next-viewport prediction (linear
        extrapolation vs online model, by rolling hit-rate) and
        pre-cracks it through the heatmap refinement machinery — at most
        ``budget_rows`` rows are read, the per-part session bin-grid
        memory is warmed for the predicted viewport, and answers of any
        later query are unchanged (splits/enrichments are
        answer-neutral; zero speculative rows). ``attr``/``bins``
        default to the last queried ones. Returns a report dict (also
        appended to ``trace.prefetches``); ``predicted=None`` means the
        trajectory is too short to extrapolate and nothing was read.
        """
        attr = self._last_attr if attr is None else attr
        bins = self._last_bins if bins is None else bins
        pred = self.predictor.predict()
        if pred is None or attr is None:
            rec = {"predicted": None, "source": None, "rows_read": 0,
                   "read_calls": 0, "tiles_cracked": 0}
        else:
            rec = prefetch_crack(
                self.index, pred, attr, bins, budget_rows,
                alpha=self.alpha if alpha is None else alpha)
            rec["predicted"] = rec.pop("window")
            rec["source"] = self.predictor.source
        self.trace.prefetches.append(rec)
        return rec

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
        prefetch_rows: per-session row budget for predictive
          pre-cracking between ticks (None ⇒ off) — leftover
          crack-budget slots are spent cracking each session's PREDICTED
          next viewport, staged through the same epoch publication.
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
