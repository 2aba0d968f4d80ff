from .engine import AQPEngine, EngineTrace
from .index import (IndexConfig, TileIndex, AdaptStats, EpochStage,
                    ChunkIndexSet)
from .bounds import (AccuracyPolicy, GroupedAccumulator, HeatmapResult,
                     PendingTile, QueryAccumulator, QueryResult)
from .serving import NullStage, ServingEngine, Session, Ticket
from .state import (forest_from_numpy, forest_to_numpy, index_from_numpy,
                    index_to_numpy)

__all__ = ["AQPEngine", "EngineTrace", "IndexConfig", "TileIndex",
           "ChunkIndexSet",
           "AdaptStats", "EpochStage", "ServingEngine", "Session", "Ticket",
           "NullStage", "QueryResult", "QueryAccumulator", "PendingTile",
           "AccuracyPolicy", "GroupedAccumulator", "HeatmapResult",
           "index_from_numpy", "index_to_numpy", "forest_from_numpy",
           "forest_to_numpy"]
