"""AQPEngine — the public API of the paper's contribution (port).

>>> from repro_torch.core import AQPEngine, IndexConfig
>>> from repro_torch.data import make_synthetic_dataset
>>> ds = make_synthetic_dataset(n=100_000)          # on the card
>>> eng = AQPEngine(ds, IndexConfig(init_metadata_attrs=("a0",)))
>>> r = eng.query((100, 100, 300, 300), "mean", "a0", phi=0.05)

The engine owns one adaptive tile index per dataset and evaluates window
aggregate queries under a per-query accuracy constraint φ (φ=0 ⇒ exact),
recording a per-query trace (time, objects read, tiles processed) and
the session's viewport trajectory. Heatmaps, predictive prefetch and the
concurrent server come with later slices of the port (``ROADMAP.md``
queue A); their entry points raise until then.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from ..data.rawfile import RawDataset
from . import query as query_mod
from .bounds import QueryResult
from .index import IndexConfig, TileIndex
from .predict import TrajectoryStep


@dataclasses.dataclass
class EngineTrace:
    """Per-query instrumentation plus the session's viewport trajectory
    (one :class:`~repro_torch.core.predict.TrajectoryStep` per query)."""

    results: List[QueryResult] = dataclasses.field(default_factory=list)
    trajectory: List[TrajectoryStep] = dataclasses.field(
        default_factory=list)

    def totals(self):
        """Session totals."""
        return {
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


class AQPEngine:
    def __init__(self, dataset: RawDataset,
                 config: Optional[IndexConfig] = None,
                 alpha: float = 1.0):
        if not isinstance(dataset, RawDataset):
            raise NotImplementedError(
                "chunked storage is not ported yet (ROADMAP.md queue A, "
                "item 6)")
        self.dataset = dataset
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

    def heatmap(self, *args, **kwargs):
        raise NotImplementedError(
            "heatmap queries are not ported yet (ROADMAP.md queue A, "
            "item 5)")

    def prefetch(self, *args, **kwargs):
        raise NotImplementedError(
            "predictive prefetch is not ported yet (ROADMAP.md queue A, "
            "item 8)")

    def serve(self, *args, **kwargs):
        raise NotImplementedError(
            "the concurrent server is not ported yet (ROADMAP.md queue A, "
            "item 7)")

    def oracle(self, window, agg: str, attr: str) -> float:
        return query_mod.evaluate_oracle(self.index, window, agg, attr)

    @property
    def io_stats(self):
        return self.dataset.stats

    @property
    def adapt_stats(self):
        return self.index.adapt_stats
