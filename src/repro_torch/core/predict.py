"""The session trajectory record (part of :mod:`repro.core.predict`).

The viewport predictor and predictive pre-cracking come with a later
slice of the port (``ROADMAP.md`` queue A, item 8); the engine already
records one :class:`TrajectoryStep` per query so that slice finds the
session's history in place.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

Window = Tuple[float, float, float, float]


@dataclasses.dataclass
class TrajectoryStep:
    """One observed viewport: the query window, its bin grid (``None``
    for scalar queries) and how long the user dwelled on it."""
    window: Window
    bins: Optional[Tuple[int, int]]
    dwell_s: float
