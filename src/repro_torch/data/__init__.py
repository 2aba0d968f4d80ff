from .rawfile import RawDataset, IOStats
from .chunked import Chunk, ChunkedDataset
from .synthetic import (make_synthetic_dataset, make_streaming_chunks,
                        exploration_path)

__all__ = ["RawDataset", "IOStats", "Chunk", "ChunkedDataset",
           "make_synthetic_dataset", "make_streaming_chunks",
           "exploration_path"]
