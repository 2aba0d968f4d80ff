"""Step watchdog: straggler surfacing for the training loop (a copy of
``repro/runtime/watchdog.py``, which is pure Python).

At 1000+ nodes the common failure smell is not a crash but a slow step
(pre-empted host, thermally throttled chip, flaky NIC). The watchdog
keeps a rolling median of step wall times and flags steps exceeding
``threshold ×`` the median. Flagged steps are recorded (and surfaced via
``on_straggler``) so the orchestrator can decide to drain/replace the
slow host; the deterministic ``batch_fn(step)`` contract in
``train_loop`` makes the replacement worker replay the exact batch.
"""
from __future__ import annotations

import statistics
from typing import Callable, List, Optional, Tuple


class StepWatchdog:
    def __init__(self, threshold: float = 3.0, window: int = 50,
                 warmup: int = 3,
                 on_straggler: Optional[Callable] = None):
        self.threshold = threshold
        self.window = window
        self.warmup = warmup
        self.on_straggler = on_straggler
        self.times: List[float] = []
        self.stragglers: List[Tuple[int, float, float]] = []

    def record(self, step: int, dt: float):
        history = self.times[-self.window:]
        self.times.append(dt)
        if len(history) < self.warmup:
            return False
        med = statistics.median(history)
        if dt > self.threshold * med:
            self.stragglers.append((step, dt, med))
            if self.on_straggler:
                self.on_straggler(step, dt, med)
            return True
        return False
