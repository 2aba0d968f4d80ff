from .train_loop import TrainLoopConfig, make_train_step, train_loop
from .watchdog import StepWatchdog

__all__ = ["TrainLoopConfig", "make_train_step", "train_loop",
           "StepWatchdog"]
