from .engine import AQPEngine, EngineTrace
from .index import (IndexConfig, TileIndex, AdaptStats, EpochStage,
                    ChunkIndexSet)
from .bounds import (AccuracyPolicy, GroupedAccumulator, HeatmapResult,
                     PendingTile, QueryAccumulator, QueryResult)
from .predict import (TrajectoryStep, ViewportPredictor, prefetch_crack,
                      resolve_learned_salience)
from .serving import NullStage, ServingEngine, Session, Ticket
from .state import (forest_from_numpy, forest_to_numpy, index_from_numpy,
                    index_to_numpy, predictor_from_numpy,
                    predictor_to_numpy)

__all__ = ["AQPEngine", "EngineTrace", "IndexConfig", "TileIndex",
           "ChunkIndexSet",
           "AdaptStats", "EpochStage", "ServingEngine", "Session", "Ticket",
           "NullStage", "QueryResult", "QueryAccumulator", "PendingTile",
           "AccuracyPolicy", "GroupedAccumulator", "HeatmapResult",
           "ViewportPredictor", "TrajectoryStep", "prefetch_crack",
           "resolve_learned_salience",
           "index_from_numpy", "index_to_numpy", "forest_from_numpy",
           "forest_to_numpy", "predictor_from_numpy", "predictor_to_numpy"]
