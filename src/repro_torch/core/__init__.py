from .engine import AQPEngine, EngineTrace
from .index import IndexConfig, TileIndex, AdaptStats
from .bounds import QueryResult, QueryAccumulator, PendingTile
from .state import index_from_numpy, index_to_numpy

__all__ = ["AQPEngine", "EngineTrace", "IndexConfig", "TileIndex",
           "AdaptStats", "QueryResult", "QueryAccumulator", "PendingTile",
           "index_from_numpy", "index_to_numpy"]
