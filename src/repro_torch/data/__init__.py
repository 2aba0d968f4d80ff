from .rawfile import RawDataset, IOStats
from .synthetic import make_synthetic_dataset, exploration_path

__all__ = ["RawDataset", "IOStats", "make_synthetic_dataset",
           "exploration_path"]
