"""Next-viewport prediction + budgeted predictive pre-cracking (port of
:mod:`repro.core.predict`).

The engine so far is purely reactive: every pan/zoom step pays its read
cost AT query time, even when the user's trajectory is trivially
extrapolable (the paper's exploration sessions are mostly smooth pans).
This module closes that gap in three pieces:

- :class:`ViewportPredictor` — records a session's pan/zoom trajectory
  (windows + bins + dwell times) and predicts the NEXT viewport. Two
  candidate predictors run side by side: a constant-velocity linear
  extrapolation (``2·w_last − w_prev`` — exact on linear pans) and a
  few-parameter MLP over the recent normalized window deltas, trained
  online with plain SGD through ``torch.autograd`` (no optimiser
  package) on the dataset's device. Each :meth:`~ViewportPredictor
  .observe` scores both candidates' previous predictions against the
  window that actually arrived (IoU ≥ ``hit_iou``), and
  :meth:`~ViewportPredictor.predict` picks by rolling hit-rate — ties
  go to the linear baseline, so smooth pans keep the exact
  extrapolation and the model only takes over when it demonstrably
  outperforms it.

- :func:`prefetch_crack` — cracks a (predicted) window under a HARD row
  budget, reusing the heatmap query machinery end to end: classify →
  score → gathered ``read_batch_heatmap`` → ``apply_batch`` (or
  ``EpochStage.stage_apply`` in serving). Building the accumulator
  rotates the per-part session bin-grid registry to the predicted
  viewport and every applied round registers its per-bin contributions,
  so a query that lands on the predicted window answers from bin-grid
  memory. Everything read is folded — prefetching never adds
  speculative rows — and prefetching only splits/enriches tiles, which
  is answer-neutral by construction.

- **Learned salience** — :meth:`ViewportPredictor.salience_map` turns
  the trajectory's per-bin dwell histogram (dwell-weighted fractional
  overlap of each past viewport with the query's bin grid) into an
  :class:`~repro_torch.core.bounds.AccuracyPolicy` salience map in
  ``(floor, 1]``. :func:`resolve_learned_salience` materializes
  ``salience="learned"`` into that map at submit time, so the policy's
  ``phi_budgets`` machinery is reused untouched.

The host code (geometry, features, hit-rates, the salience histogram)
is the reference's float64 numpy, bit for bit. The MLP is float32 on
the predictor's device, initialised from the reference's seeded host
draws; its outputs agree with the reference's to float32 rounding.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels.segment_agg import MAX_SEGMENTS, MAX_UNROLL
from . import query as query_mod
from .bounds import EPS, AccuracyPolicy
from .refine import HeatmapQueryAdapter

Window = Tuple[float, float, float, float]


@dataclasses.dataclass
class TrajectoryStep:
    """One observed viewport: the query window, its bin grid (``None``
    for scalar queries) and how long the user dwelled on it."""
    window: Window
    bins: Optional[Tuple[int, int]]
    dwell_s: float


# ----------------------------------------------------------------- #
# the tiny in-repo model: a few-parameter MLP over recent window
# deltas, trained online with plain SGD (torch.autograd, no optimiser)
# ----------------------------------------------------------------- #

_HIDDEN = 8
PARAMS = ("w1", "b1", "w2", "b2")


def _mlp_init(history: int, device) -> Dict[str, torch.Tensor]:
    """The reference's deterministic init (seeded host RNG, float32),
    placed on ``device`` as leaves that take gradients."""
    rng = np.random.default_rng(7)
    d_in = 4 * history
    host = {
        "w1": rng.normal(0.0, 0.1, (d_in, _HIDDEN)).astype(np.float32),
        "b1": np.zeros(_HIDDEN, np.float32),
        "w2": rng.normal(0.0, 0.1, (_HIDDEN, 4)).astype(np.float32),
        "b2": np.zeros(4, np.float32),
    }
    return _params_on(host, device)


def _params_on(host: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(np.asarray(host[k], np.float32),
                            device=device).requires_grad_()
            for k in PARAMS}


def _mlp_apply(params, x):
    h = torch.tanh(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def _sgd_step(params, x, y, lr: float) -> None:
    """One SGD step on the MSE over the 4 outputs, in place."""
    loss = torch.mean((_mlp_apply(params, x) - y) ** 2)
    grads = torch.autograd.grad(loss, [params[k] for k in PARAMS])
    with torch.no_grad():
        for k, g in zip(PARAMS, grads):
            params[k].sub_(lr * g)


class ViewportPredictor:
    """Per-session next-viewport predictor (see the module docstring).

    history: number of recent window deltas the MLP conditions on.
    hit_iou: IoU threshold for a prediction to count as a hit.
    roll: rolling hit-rate horizon (observations per candidate).
    lr / train_steps: online-SGD step size and steps per observation.
    device: where the MLP's parameters live and train (the engines pass
      their dataset's device). :meth:`observe` synchronises with it once,
      copying the model's 4 outputs to the host to score its hit.
    """

    def __init__(self, history: int = 3, hit_iou: float = 0.5,
                 roll: int = 16, lr: float = 0.1, train_steps: int = 4,
                 device="cuda"):
        self.history = int(history)
        self.hit_iou = float(hit_iou)
        self.lr = float(lr)
        self.train_steps = int(train_steps)
        self.device = torch.device(device)
        self.trajectory: List[TrajectoryStep] = []
        self._params = _mlp_init(self.history, self.device)
        self._hits = {"linear": deque(maxlen=int(roll)),
                      "model": deque(maxlen=int(roll))}
        # which candidate produced the last predict() ("linear"/"model")
        self.source: Optional[str] = None
        self.n_trained = 0

    # ---------------- geometry helpers ---------------------------- #

    @staticmethod
    def _iou(a: Window, b: Window) -> float:
        ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
        iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
        inter = ix * iy
        area_a = max(0.0, a[2] - a[0]) * max(0.0, a[3] - a[1])
        area_b = max(0.0, b[2] - b[0]) * max(0.0, b[3] - b[1])
        union = area_a + area_b - inter
        return inter / union if union > 0 else 0.0

    @staticmethod
    def _scale(w: np.ndarray) -> np.ndarray:
        """Per-coordinate normalization: the window's own span, so the
        model sees size-relative motion and transfers across zooms."""
        sx = max(float(w[2] - w[0]), EPS)
        sy = max(float(w[3] - w[1]), EPS)
        return np.array([sx, sy, sx, sy])

    # ---------------- the two candidates --------------------------- #

    def _linear_pred(self) -> Optional[Window]:
        """Constant-velocity extrapolation ``2·w_last − w_prev`` —
        EXACT on linear pans (each coordinate is an affine step)."""
        if len(self.trajectory) < 2:
            return None
        a = np.asarray(self.trajectory[-2].window, np.float64)
        b = np.asarray(self.trajectory[-1].window, np.float64)
        return tuple((2.0 * b - a).tolist())

    def _features(self) -> Optional[np.ndarray]:
        """The last ``history`` window deltas, normalized by the newest
        window's span; ``None`` until the trajectory is long enough."""
        ws = [np.asarray(s.window, np.float64) for s in self.trajectory]
        if len(ws) < self.history + 1:
            return None
        deltas = [ws[i + 1] - ws[i] for i in range(len(ws) - 1)]
        scale = self._scale(ws[-1])
        return np.concatenate(
            [d / scale for d in deltas[-self.history:]]).astype(np.float32)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        # pageable host memory is staged at once, so the copy neither
        # waits for the device nor outlives ``a``
        return torch.from_numpy(a).to(self.device, non_blocking=True)

    def _model_pred(self) -> Optional[Window]:
        x = self._features()
        if x is None:
            return None
        with torch.no_grad():
            out = _mlp_apply(self._params, self._to_device(x))
        d = out.cpu().numpy().astype(np.float64)
        last = np.asarray(self.trajectory[-1].window, np.float64)
        p = last + d * self._scale(last)
        x0, x1 = sorted((float(p[0]), float(p[2])))
        y0, y1 = sorted((float(p[1]), float(p[3])))
        return (x0, y0, x1, y1)

    # ---------------- observe / predict ---------------------------- #

    def observe(self, window, bins: Optional[Tuple[int, int]] = None,
                dwell_s: float = 1.0) -> None:
        """Record one served viewport. Scores both candidates' standing
        predictions against the window that actually arrived, appends
        the step, and takes ``train_steps`` SGD steps on the newest
        (delta history → next delta) pair."""
        window = tuple(float(v) for v in window)
        lp, mp = self._linear_pred(), self._model_pred()
        if lp is not None:
            self._hits["linear"].append(self._iou(lp, window)
                                        >= self.hit_iou)
        if mp is not None:
            self._hits["model"].append(self._iou(mp, window)
                                       >= self.hit_iou)
        x = self._features()     # input = deltas BEFORE this arrival
        self.trajectory.append(TrajectoryStep(
            window, None if bins is None else (int(bins[0]), int(bins[1])),
            float(dwell_s)))
        if x is not None:
            prev = np.asarray(self.trajectory[-2].window, np.float64)
            y = ((np.asarray(window, np.float64) - prev)
                 / self._scale(prev)).astype(np.float32)
            xs, ys = self._to_device(x), self._to_device(y)
            for _ in range(self.train_steps):
                _sgd_step(self._params, xs, ys, self.lr)
            self.n_trained += 1

    def hit_rate(self, source: str) -> float:
        h = self._hits[source]
        return (sum(h) / len(h)) if h else 0.0

    def predict(self) -> Optional[Window]:
        """The next-viewport prediction (``None`` until 2 observations);
        sets :attr:`source` to the candidate that produced it. The model
        must STRICTLY beat the linear baseline's rolling hit-rate —
        ties keep the exact extrapolation."""
        lp = self._linear_pred()
        if lp is None:
            self.source = None
            return None
        mp = self._model_pred()
        if mp is not None and self.hit_rate("model") > self.hit_rate("linear"):
            self.source = "model"
            return mp
        self.source = "linear"
        return lp

    # ---------------- learned salience ----------------------------- #

    def salience_map(self, window, bins: Tuple[int, int],
                     floor: float = 0.25) -> np.ndarray:
        """Per-bin dwell histogram → salience map in ``(floor, 1]``.

        Each trajectory step contributes its dwell time, spread over
        the query window's bins by fractional area overlap; the
        histogram is normalized so the most-dwelled bin gets salience 1
        and never-visited bins get the floor (all ones when the
        trajectory never overlapped the window — the uniform fallback).
        Flat ``(bx·by,)``, bin id = by_row·bx + bx_col.
        """
        bx, by = int(bins[0]), int(bins[1])
        x0, y0, x1, y1 = (float(v) for v in window)
        ex = np.linspace(x0, x1, bx + 1)
        ey = np.linspace(y0, y1, by + 1)
        h = np.zeros((by, bx))
        for step in self.trajectory:
            wx0, wy0, wx1, wy1 = step.window
            ox = np.clip(np.minimum(ex[1:], wx1) - np.maximum(ex[:-1], wx0),
                         0.0, None)
            oy = np.clip(np.minimum(ey[1:], wy1) - np.maximum(ey[:-1], wy0),
                         0.0, None)
            fx = ox / np.maximum(ex[1:] - ex[:-1], EPS)
            fy = oy / np.maximum(ey[1:] - ey[:-1], EPS)
            h += step.dwell_s * (fy[:, None] * fx[None, :])
        m = float(h.max())
        if m <= 0.0:
            return np.ones(bx * by)
        s = floor + (1.0 - floor) * (h / m)
        return s.reshape(-1)


def resolve_learned_salience(policy: Optional[AccuracyPolicy],
                             predictor: ViewportPredictor,
                             window, bins) -> Optional[AccuracyPolicy]:
    """Materialize ``salience="learned"`` into the predictor's per-bin
    dwell-histogram map for THIS query window; any other policy (or
    ``None``) passes through untouched."""
    if policy is None or not (isinstance(policy.salience, str)
                              and policy.salience == "learned"):
        return policy
    sal = predictor.salience_map(window, bins,
                                 floor=policy.salience_floor)
    return dataclasses.replace(policy, salience=sal)


# ----------------------------------------------------------------- #
# budgeted predictive pre-cracking
# ----------------------------------------------------------------- #

def prefetch_crack(index, window, attr: str, bins: Tuple[int, int],
                   budget_rows: int, *, alpha: float = 1.0,
                   stage=None, owner: Optional[int] = None) -> dict:
    """Crack ``window`` under a HARD row budget; returns a report dict.

    Reuses the heatmap query machinery end to end (classify → score →
    gathered ``read_batch_heatmap`` → apply), so the same tiles a real
    heatmap on this window would refine first are pre-cracked first,
    and the per-part session bin-grid registry is warmed for it. Tiles
    are taken greedily down the score order, skipping any that no
    longer fit the remaining budget — never more than ``budget_rows``
    rows are read — and everything read is folded, so prefetching adds
    ZERO speculative rows. With
    ``stage``/``owner`` set, refinement is staged (serving's epoch
    isolation) instead of applied in place.
    """
    bins = (int(bins[0]), int(bins[1]))
    prepare = getattr(index, "prepare", None)
    if prepare is not None:
        prepare(window, attr)
    io_before = index.ds.stats.snapshot()
    index.ensure_attr(attr)
    acc, _, _ = query_mod._build_grouped_accumulator(index, window, "mean",
                                                     attr, bins)
    report = {"window": tuple(float(v) for v in window), "attr": attr,
              "bins": bins, "budget_rows": int(budget_rows),
              "rows_read": 0, "read_calls": 0, "tiles_cracked": 0,
              "tiles_pending": len(acc.pending)}
    if not acc.pending or budget_rows <= 0:
        return report
    adapter = HeatmapQueryAdapter(index, window, attr, bins)
    order = adapter.score_order(acc, alpha)
    k = max(1, min(index.cfg.batch_k, MAX_SEGMENTS,
                   MAX_UNROLL // adapter.max_split_cells()))
    budget = int(budget_rows)
    pos = 0
    while pos < len(order) and budget > 0:
        batch = []
        while pos < len(order) and len(batch) < k:
            t = order[pos]
            pos += 1
            cost = int(acc.pending[t].cost)
            if cost > budget:
                continue    # skip — the budget only shrinks, so a
                            # once-unaffordable tile never fits later
            batch.append(t)
            budget -= cost
        if not batch:
            break           # nothing further down the order fits
        contribs, payload = adapter.read_batch(batch)
        for t, contrib in zip(batch, contribs):
            if contrib is None:      # chunk retired under our feet
                acc.drop_pending(t)
            else:
                acc.fold_exact(t, *contrib)
                report["tiles_cracked"] += 1
        flags = adapter.split_flags(batch)
        if stage is not None:
            if owner is not None:
                stage.set_owner(owner)
            stage.stage_apply(index, payload, len(batch), flags)
        else:
            index.apply_batch(payload, len(batch), flags)
    delta = index.ds.stats.delta(io_before)
    report["rows_read"] = int(delta.rows_read)
    report["read_calls"] = int(delta.read_calls)
    return report


__all__ = ["ViewportPredictor", "TrajectoryStep", "prefetch_crack",
           "resolve_learned_salience"]
