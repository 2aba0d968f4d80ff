"""Concurrent multi-session serving: epoch-isolated cracking over ONE
shared adaptive index.

Port of :mod:`repro.core.serving`, over one ``TileIndex`` or a chunk
forest (``ChunkIndexSet``). Exploration front ends multiplex many
sessions — users panning their own viewports — over one dataset.
:class:`ServingEngine` serves them in ticks:

- **Sessions** (:meth:`ServingEngine.open_session`) submit queries as
  :class:`Ticket`\\ s; nothing runs until :meth:`ServingEngine.tick`.
  Each session keeps its own :class:`~repro_torch.core.engine.
  EngineTrace`, results and viewport trajectory alike.
- **Epoch isolation**: during a tick every query reads ONE frozen index
  epoch. Refinement side effects are staged on an
  :class:`~repro_torch.core.index.EpochStage` and published atomically
  between ticks (first claimant splits a tile; a later same-tick request
  is masked to an enrichment).
- **Micro-batching** (``mode="batched"``): same-tick queries advance in
  lock-step rounds. Each round gathers the union of every active
  query's next score-ordered batch — one ``read_values`` call per
  (part, attribute): over a chunk forest a query's batch splits into
  same-chunk runs, and no gather crosses two chunks' planes — and
  answers all scalar queries with one packed
  ``segment_window_agg_multi`` pass and all same-resolution heatmaps
  with one ``segment_window_bin_select_multi`` pass (chunked at query
  spans to ``MAX_SEGMENTS`` segments on a device backend). Per-query
  fold loops, round sizing and stopping are the private
  :class:`~repro_torch.core.refine.RefinementDriver`'s, so a batched
  tick gives the same answers and the same published index evolution as
  ``mode="sequential"`` (each ticket its own driver against the same
  frozen epoch). ``objects_read``/``read_calls``/``batch_rounds`` are
  cost attribution and differ between modes by construction.
- **Skip under contention**: a query whose pending-interval bound
  already meets φ answers with zero reads and stages nothing; past
  ``crack_budget`` queries a tick (granted round-robin across sessions)
  a query reads and folds until φ is met but stages no mutation.
- **Predictive pre-cracking** (``prefetch_rows``): leftover crack-budget
  slots are spent between ticks cracking each session's predicted next
  viewport (:func:`~repro_torch.core.predict.prefetch_crack`), staged
  with owners past every ticket, so both tick modes publish alike.

Under ``"torch"``/``"cuda"`` a round's gathered segments stay on the
device: each family pass moves only its ``(S, 4)`` or ``(S, nb, 4)``
table (with the suffix widths) to the host, in one copy, and every
query's staged payload slices the one gather. Each segment compares
with its own ticket's window under that ticket's single-window rule
(the reference's batched scalar pass compares in float64 instead,
ROADMAP C.6).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..kernels import ops
from ..kernels.segment_agg import MAX_SEGMENTS, MAX_UNROLL
from . import query as query_mod
from .bounds import AccuracyPolicy, HeatmapResult, QueryResult
from .engine import AQPEngine, EngineTrace
from .index import (ChunkIndexSet, EpochStage, _adjacent, _chunk_overlaps,
                    _host, _host_pair, composite_payload)
from .predict import (TrajectoryStep, ViewportPredictor, prefetch_crack,
                      resolve_learned_salience)
from .refine import (HeatmapQueryAdapter, ScalarQueryAdapter, met,
                     round_residual)


class NullStage:
    """Stage sink for crack-skipped queries: accepts the driver's
    staged rounds and discards them — the query reads, folds, and
    answers within φ, but contributes nothing to the published epoch."""

    n_staged = 0

    def set_owner(self, owner: int) -> None:
        pass

    def stage_apply(self, index, payload, n_used, split_flags) -> None:
        pass

    def publish(self) -> Dict[str, int]:
        return {"rounds_published": 0, "splits_masked": 0}


_NULL_STAGE = NullStage()


@dataclasses.dataclass
class Ticket:
    """One submitted query; ``result`` is populated by the tick that
    serves it (``None`` until then)."""
    session: "Session"
    kind: str                    # "query" | "heatmap"
    window: Tuple[float, float, float, float]
    agg: str
    attr: str
    phi: float = 0.0
    alpha: float = 1.0
    bins: Optional[Tuple[int, int]] = None
    policy: Optional[AccuracyPolicy] = None
    batch_k: Optional[int] = None
    dwell_s: float = 1.0
    result: Optional[Union[QueryResult, HeatmapResult]] = None

    @property
    def done(self) -> bool:
        return self.result is not None


class Session:
    """A client handle on the shared engine: submits tickets and owns a
    private :class:`EngineTrace` and :class:`~repro_torch.core.predict.
    ViewportPredictor` (its trajectory recorded at submit time —
    deterministic and mode-independent). Closing drops its queued
    tickets."""

    def __init__(self, engine: "ServingEngine", sid: int,
                 name: Optional[str] = None):
        self.engine = engine
        self.sid = sid
        self.name = name or f"session-{sid}"
        self.trace = EngineTrace()
        self.predictor = ViewportPredictor(
            device=engine.engine.dataset.device or "cpu")
        self._last_attr: Optional[str] = None
        self._last_bins: Tuple[int, int] = (8, 8)
        self.closed = False

    def query(self, window, agg: str, attr: str, phi: float = 0.0,
              alpha: float = 1.0,
              batch_k: Optional[int] = None,
              dwell_s: float = 1.0) -> Ticket:
        return self.engine._submit(Ticket(
            session=self, kind="query", window=tuple(window), agg=agg,
            attr=attr, phi=float(phi), alpha=float(alpha),
            batch_k=batch_k, dwell_s=float(dwell_s)))

    def heatmap(self, window, agg: str, attr: str,
                bins: Tuple[int, int] = (8, 8), phi: float = 0.0,
                alpha: float = 1.0,
                policy: Optional[AccuracyPolicy] = None,
                batch_k: Optional[int] = None,
                dwell_s: float = 1.0) -> Ticket:
        assert np.isfinite(np.asarray(window, np.float64)).all(), \
            "heatmap windows must be finite rectangles"
        return self.engine._submit(Ticket(
            session=self, kind="heatmap", window=tuple(window), agg=agg,
            attr=attr, phi=float(phi), alpha=float(alpha),
            bins=(int(bins[0]), int(bins[1])), policy=policy,
            batch_k=batch_k, dwell_s=float(dwell_s)))

    def close(self) -> None:
        self.closed = True
        self.engine._drop_session(self)


class _QueryRun:
    """Per-ticket refinement state machine of a micro-batched tick.

    Replicates :meth:`RefinementDriver._run_batched` exactly — same
    round sizing, same per-item stopping rule, same speculative
    accounting, same staged prefix — but yields its round batches to
    the scheduler instead of reading itself, so the scheduler can fuse
    all active queries' reads and kernel passes."""

    def __init__(self, arrival: int, ticket: Ticket, index, stage,
                 may_crack: bool):
        self.i = arrival
        self.tk = ticket
        self.index = index
        self.stage = stage if may_crack else _NULL_STAGE
        self.processed = 0
        self.dropped = 0
        self.speculative = 0
        self.objects_read = 0
        self.read_calls = 0
        self.rounds = 0
        self.finish_time: Optional[float] = None

        # ---- phase 1: build (frozen-epoch classification) ----
        tk = ticket
        prepare = getattr(index, "prepare", None)
        if prepare is not None:
            prepare(tk.window, tk.attr)
        io_before = index.ds.stats.snapshot()
        index.ensure_attr(tk.attr)
        if tk.kind == "query":
            acc, full_set, n_full, n_partial = \
                query_mod._build_accumulator(index, tk.window, tk.agg,
                                             tk.attr)
            self.adapter = ScalarQueryAdapter(index, tk.window, tk.attr,
                                              full_set)
        else:
            acc, n_full, n_partial = query_mod._build_grouped_accumulator(
                index, tk.window, tk.agg, tk.attr, tk.bins)
            if tk.policy is not None and tk.phi > 0.0:
                acc.set_policy(tk.policy, tk.phi, tk.bins)
            self.adapter = HeatmapQueryAdapter(index, tk.window, tk.attr,
                                               tk.bins)
        self.pruned = index.ds.stats.delta(io_before).pruned_calls
        self.acc = acc
        self.phi = tk.phi
        self.n_full, self.n_partial = n_full, n_partial
        self.bound = acc.query_bound()
        # the metadata fast path: pending-interval bounds already meet
        # φ → answer with zero reads, zero staged mutation (SKIP)
        self.finished = (not acc.pending) or met(self.phi, self.bound)
        self.stop = False
        self.pos = 0
        if not self.finished:
            self.order = self.adapter.score_order(acc, tk.alpha)
            k = (index.cfg.batch_k if tk.batch_k is None
                 else int(tk.batch_k))
            self.k = max(1, min(k, MAX_SEGMENTS,
                                MAX_UNROLL // self.adapter.max_split_cells()))
            self.predictive = tk.phi > 0.0 and acc.agg in ("sum", "mean")
            self.size = 1 if tk.phi > 0.0 else self.k
        else:
            self.order = []

    def next_batch(self):
        """The driver's round-head logic; ``None`` once finished."""
        if self.finished:
            return None
        if (self.pos >= len(self.order) or self.stop
                or met(self.phi, self.bound)):
            self.finished = True
            return None
        if self.predictive:
            self.size = self.acc.min_folds_needed(self.order[self.pos:],
                                                  self.phi)
        batch = self.order[self.pos:self.pos + min(self.size, self.k)]
        self.pos += len(batch)
        if not self.predictive:
            self.size = min(self.size * 2, self.k)
        return batch

    def fold(self, batch, contribs, payload) -> None:
        """The driver's per-round fold + stage epilogue, verbatim —
        including its certainty fast paths (predictive sizing, and the
        fused pass's suffix-width ``round_certain`` witness), which fold
        a round wholesale exactly when the interim stopping checks
        provably cannot fire."""
        acc = self.acc
        n_used = 0
        wholesale = all(c is not None for c in contribs)
        if wholesale and not self.predictive and len(batch) > 1:
            row = round_residual(payload)
            wholesale = (row is not None
                         and acc.round_certain(row, self.phi))
        if wholesale:
            for t, contrib in zip(batch, contribs):
                acc.fold_exact(t, *contrib)
            n_used = len(batch)
            self.processed += len(batch)
            self.bound = acc.query_bound()
            contribs = ()                # consumed
        for t, contrib in zip(batch, contribs):
            if met(self.phi, self.bound):
                self.stop = True
                break
            if contrib is None:          # dataset retired mid-query
                acc.drop_pending(t)
                self.dropped += 1
                n_used += 1
                self.bound = acc.query_bound()
                continue
            acc.fold_exact(t, *contrib)
            n_used += 1
            self.processed += 1
            self.bound = acc.query_bound()
        bounds_ = payload["bounds"]
        spec = int(bounds_[len(batch)] - bounds_[n_used])
        self.index.adapt_stats.speculative_rows += spec
        self.speculative += spec
        self.objects_read += int(bounds_[-1])
        self.rounds += 1
        flags = self.adapter.split_flags(batch[:n_used])
        self.stage.set_owner(self.i)
        self.stage.stage_apply(self.index, payload, n_used, flags)

    def build_result(self, now: float, t0: float):
        tk = self.tk
        eval_s = (self.finish_time if self.finish_time is not None
                  else now) - t0
        common = dict(
            agg=tk.agg, attr=tk.attr, exact=not self.acc.pending,
            tiles_full=self.n_full, tiles_partial=self.n_partial,
            tiles_processed=self.processed,
            objects_read=self.objects_read, read_calls=self.read_calls,
            batch_rounds=self.rounds, speculative_rows=self.speculative,
            pruned_chunks=self.pruned,
            retired_during_query=self.dropped > 0, eval_time_s=eval_s)
        if tk.kind == "query":
            value, lo, hi, bound = self.acc.interval()
            return QueryResult(value=float(value), lo=float(lo),
                               hi=float(hi), bound=float(bound), **common)
        values, lo, hi, bin_bound, bound = self.acc.interval()
        policy_active = self.acc.phi_b is not None
        return HeatmapResult(
            bins=tk.bins, values=np.asarray(values, np.float64),
            lo=np.asarray(lo, np.float64), hi=np.asarray(hi, np.float64),
            bin_bound=np.asarray(bin_bound, np.float64),
            bound=float(bound),
            phi_b=self.acc.phi_b.copy() if policy_active else None,
            eps_abs=self.acc.eps_abs,
            bin_met=(self.acc.bin_satisfied(tk.phi)
                     if policy_active else None), **common)


class ServingEngine:
    """Tick-based scheduler serving N concurrent sessions against one
    shared adaptive index (see the module docstring).

    ``engine`` may be an existing :class:`AQPEngine` (its index is
    shared and keeps evolving) or a dataset, from which a private
    engine is built. ``mode`` picks the default tick execution:
    ``"batched"`` (micro-batched reads/kernels) or ``"sequential"``
    (the per-query reference). ``crack_budget`` caps how many queries
    per tick may stage index mutation (granted round-robin across
    sessions; ``None`` ⇒ unlimited) — the skip-under-contention knob.
    ``prefetch_rows`` (``None`` ⇒ off) is the per-session row budget
    for predictive pre-cracking: leftover crack-budget slots are spent
    between ticks cracking each session's predicted next viewport."""

    def __init__(self, engine, config=None, alpha: float = 1.0, *,
                 mode: str = "batched",
                 crack_budget: Optional[int] = None,
                 prefetch_rows: Optional[int] = None):
        if not isinstance(engine, AQPEngine):
            engine = AQPEngine(engine, config, alpha=alpha)
        self.engine = engine
        self.index = engine.index
        if mode not in ("batched", "sequential"):
            raise ValueError(f"unknown serving mode {mode!r}")
        self.mode = mode
        self.crack_budget = crack_budget
        self.prefetch_rows = prefetch_rows
        self.epoch = 0
        self.last_publish: Dict[str, int] = {"rounds_published": 0,
                                             "splits_masked": 0}
        self.last_grants: List[bool] = []
        self.last_prefetch: List[dict] = []
        self._sessions: Dict[int, Session] = {}
        self._next_sid = 0
        self._queue: List[Ticket] = []

    # ------------------------- sessions ------------------------------ #
    def open_session(self, name: Optional[str] = None) -> Session:
        s = Session(self, self._next_sid, name)
        self._sessions[s.sid] = s
        self._next_sid += 1
        return s

    def _drop_session(self, session: Session) -> None:
        self._sessions.pop(session.sid, None)
        self._queue = [t for t in self._queue if t.session is not session]

    def _submit(self, ticket: Ticket) -> Ticket:
        if ticket.session.closed:
            raise RuntimeError(f"{ticket.session.name} is closed")
        s = ticket.session
        # learned salience is materialized from the trajectory BEFORE
        # this viewport is observed (salience = where PAST queries
        # dwelled), at submit time so both tick modes — and any tick
        # batching — see the identical resolved policy
        if ticket.kind == "heatmap":
            ticket.policy = resolve_learned_salience(
                ticket.policy, s.predictor, ticket.window, ticket.bins)
        s.trace.trajectory.append(TrajectoryStep(
            ticket.window, ticket.bins, ticket.dwell_s))
        s.predictor.observe(ticket.window, bins=ticket.bins,
                            dwell_s=ticket.dwell_s)
        s._last_attr = ticket.attr
        if ticket.bins is not None:
            s._last_bins = ticket.bins
        self._queue.append(ticket)
        return ticket

    @property
    def n_queued(self) -> int:
        return len(self._queue)

    def _crack_grants(self, tickets) -> List[bool]:
        """Which tickets may stage index mutation this tick.

        ``crack_budget`` slots are granted round-robin across sessions:
        sessions in first-arrival order, each session's own tickets in
        arrival order — round r grants every session its (r+1)-th
        ticket before any session gets its (r+2)-th. A pure function of
        the ticket list, so both tick modes grant identically and the
        published evolution stays mode-independent."""
        n = len(tickets)
        if self.crack_budget is None:
            return [True] * n
        per: Dict[int, List[int]] = {}
        sess_order: List[int] = []
        for i, tk in enumerate(tickets):
            sid = tk.session.sid
            if sid not in per:
                per[sid] = []
                sess_order.append(sid)
            per[sid].append(i)
        grants = [False] * n
        left = int(self.crack_budget)
        r = 0
        while left > 0:
            any_row = False
            for sid in sess_order:
                q = per[sid]
                if r < len(q):
                    any_row = True
                    grants[q[r]] = True
                    left -= 1
                    if left <= 0:
                        break
            if not any_row:
                break
            r += 1
        return grants

    # ------------------------- ticks --------------------------------- #
    def tick(self, *, mode: Optional[str] = None):
        """Serve every queued ticket as one epoch: all queries read the
        frozen pre-tick index, staged refinement publishes atomically
        at the end. Returns the tickets' results in arrival order."""
        mode = mode or self.mode
        tickets, self._queue = self._queue, []
        if not tickets:
            return []
        stage = EpochStage()
        grants = self._crack_grants(tickets)
        self.last_grants = grants
        t0 = time.perf_counter()
        if mode == "sequential":
            self._tick_sequential(tickets, stage, grants)
        elif mode == "batched":
            self._tick_batched(tickets, stage, grants, t0)
        else:
            raise ValueError(f"unknown serving mode {mode!r}")
        self.last_prefetch = self._prefetch_predicted(tickets, stage,
                                                      grants)
        self.last_publish = stage.publish()
        self.epoch += 1
        for tk in tickets:
            tk.session.trace.results.append(tk.result)
        return [tk.result for tk in tickets]

    def _prefetch_predicted(self, tickets, stage, grants) -> List[dict]:
        """Spend leftover crack-budget slots cracking each active
        session's PREDICTED next viewport (per-session ``prefetch_rows``
        row budget), staged with owners ordered past every query so
        publication order — hence the published evolution — is
        mode-independent and served answers stay untouched. Every input
        (tickets, predictor states) is identical across modes, so this
        runs identically in both."""
        if self.prefetch_rows is None:
            return []
        leftover = (None if self.crack_budget is None
                    else int(self.crack_budget) - sum(grants))
        sessions, seen = [], set()
        for tk in tickets:
            if tk.session.sid not in seen:
                seen.add(tk.session.sid)
                sessions.append(tk.session)
        out: List[dict] = []
        owner = len(tickets)
        for s in sessions:
            if leftover is not None and leftover <= 0:
                break
            if s._last_attr is None:
                continue
            pred = s.predictor.predict()
            if pred is None:
                continue
            rec = prefetch_crack(
                self.index, pred, s._last_attr, s._last_bins,
                self.prefetch_rows, alpha=self.engine.alpha,
                stage=stage, owner=owner)
            owner += 1
            rec["predicted"] = rec.pop("window")
            rec["source"] = s.predictor.source
            rec["session"] = s.name
            s.trace.prefetches.append(rec)
            out.append(rec)
            if leftover is not None:
                leftover -= 1
        return out

    def _tick_sequential(self, tickets, stage, grants) -> None:
        """Reference execution: one private driver per ticket, arrival
        order, against the same frozen epoch (applies staged)."""
        for i, tk in enumerate(tickets):
            stage.set_owner(i)
            st = stage if grants[i] else _NULL_STAGE
            if tk.kind == "query":
                tk.result = query_mod.evaluate(
                    self.index, tk.window, tk.agg, tk.attr, phi=tk.phi,
                    alpha=tk.alpha, batch_k=tk.batch_k, stage=st)
            else:
                tk.result = query_mod.evaluate_heatmap(
                    self.index, tk.window, tk.agg, tk.attr, bins=tk.bins,
                    phi=tk.phi, alpha=tk.alpha, policy=tk.policy,
                    batch_k=tk.batch_k, stage=st)

    def _tick_batched(self, tickets, stage, grants, t0: float) -> None:
        """Micro-batched execution: lock-step rounds, fused reads."""
        runs = [_QueryRun(i, tk, self.index, stage, grants[i])
                for i, tk in enumerate(tickets)]
        now = time.perf_counter()
        for qr in runs:
            if qr.finished:
                qr.finish_time = now
        while True:
            entries = []
            for qr in runs:
                if qr.finished:
                    continue
                batch = qr.next_batch()
                if batch is None:
                    qr.finish_time = time.perf_counter()
                    continue
                entries.append((qr, np.asarray(batch, np.int64)))
            if not entries:
                break
            self._execute_round(entries)
            now = time.perf_counter()
            for qr, _ in entries:
                # stamp latency the moment the stopping rule fires
                if ((qr.stop or qr.pos >= len(qr.order)
                     or met(qr.phi, qr.bound))
                        and qr.finish_time is None):
                    qr.finish_time = now
        self._canonicalize_hm(tickets)
        now = time.perf_counter()
        for qr in runs:
            qr.tk.result = qr.build_result(now, t0)

    # -- micro-round execution ---------------------------------------- #
    def _entry_runs(self, batch):
        """Split one query's round batch into ``(TileIndex, local_ids, s,
        e)`` chunk runs (global prefix coordinates), mirroring
        :meth:`ChunkIndexSet._read_batch_runs` routing."""
        index = self.index
        if not isinstance(index, ChunkIndexSet):
            return [(index, batch, 0, len(batch))]
        out = []
        for s, e in index._chunk_runs(batch):
            ti, _ = index.resolve(int(batch[s]))
            out.append((ti, batch[s:e] % index._stride, s, e))
        return out

    def _execute_round(self, entries) -> None:
        """One micro-batched round: fuse every active query's batch
        into one gathered read per (part, attribute) and one packed
        multi-window kernel pass per family (+ per heatmap bin
        resolution), then fold/stage per query exactly as its private
        driver would."""
        # item: one (query, chunk-run) piece of the round
        items = []
        per_entry = []  # (qr, batch, [item indices in run order])
        for qr, batch in entries:
            idxs = []
            for ti, local, s, e in self._entry_runs(batch):
                items.append({"qr": qr, "ti": ti, "local": local,
                              "s": s, "e": e})
                idxs.append(len(items) - 1)
            per_entry.append((qr, batch, idxs))

        # group items by (part, attr); scalar items first, then heatmap
        # items grouped by bin resolution — per-family contiguity lets
        # one kernel pass cover each family
        groups: Dict[tuple, List[int]] = {}
        for j, it in enumerate(items):
            tk = it["qr"].tk
            it["fam"] = ((0,) if tk.kind == "query"
                         else (1, tk.bins[0], tk.bins[1]))
            groups.setdefault((id(it["ti"]), tk.attr), []).append(j)
        for js in groups.values():
            js.sort(key=lambda j: (items[j]["fam"], j))
            self._read_group([items[j] for j in js])

        # per query: reassemble contribs + payload across its runs (a
        # composite payload with GLOBAL bounds over a chunk forest) and
        # run the driver's fold/stage epilogue
        chunked = isinstance(self.index, ChunkIndexSet)
        for qr, batch, idxs in per_entry:
            contribs = []
            for j in idxs:
                contribs.extend(items[j]["contribs"])
            if not chunked:
                payload = items[idxs[0]]["payload"]
            else:
                payload = composite_payload(
                    batch, [(items[j]["ti"], items[j]["payload"],
                             items[j]["s"], items[j]["e"]) for j in idxs],
                    qr.tk.attr)
            qr.fold(batch, contribs, payload)

    def _read_group(self, group_items) -> None:
        """One gathered read + packed kernel passes for every item of a
        (part, attribute) group; writes ``contribs``/``payload`` per
        item."""
        ti = group_items[0]["ti"]
        attr = group_items[0]["qr"].tk.attr
        if ti.ds.closed:
            # the whole part retired: degrade every item (the driver
            # drops the tiles from its answer set)
            for it in group_items:
                it["contribs"], it["payload"] = ti._dead_batch(
                    it["local"], attr)
                it["qr"].read_calls += 1
            return
        all_local = np.concatenate([it["local"] for it in group_items])
        # ONE accounted read over every item's segments (on the device
        # under "torch"/"cuda")
        _, idx, bounds, xs, ys, vals, _ = ti._read_batch_gather(all_local,
                                                                attr)

        # per-item segment spans within the group gather
        seg0 = 0
        for it in group_items:
            it["seg"] = (seg0, seg0 + len(it["local"]))
            seg0 += len(it["local"])
            it["qr"].read_calls += 1

        # one packed multi-window pass per family; every segment carries
        # its ticket's window as given (the ops apply the ticket's own
        # compare rule)
        fams: Dict[tuple, List[dict]] = {}
        for it in group_items:
            fams.setdefault(it["fam"], []).append(it)
        for fam, its in fams.items():
            s0, s1 = its[0]["seg"][0], its[-1]["seg"][1]
            a, b = int(bounds[s0]), int(bounds[s1])
            f_bounds = bounds[s0:s1 + 1] - bounds[s0]
            windows = [it["qr"].tk.window for it in its
                       for _ in range(len(it["local"]))]
            if fam[0] == 0:
                agg = self._scalar_multi(ti, xs[a:b], ys[a:b], vals[a:b],
                                         f_bounds, windows)
                contribs = [
                    (int(agg[s, 0]), float(agg[s, 1]), float(agg[s, 2]),
                     float(agg[s, 3]))
                    if agg[s, 0] else (0, 0.0, np.inf, -np.inf)
                    for s in range(s1 - s0)]
                pos = 0
                for it in its:
                    it["contribs"] = contribs[pos:pos + len(it["local"])]
                    pos += len(it["local"])
            else:
                bx, by = fam[1], fam[2]
                # ONE fused multi-window select pass: the per-(segment,
                # bin) table AND every query's suffix widths, binned by
                # the contract params (ref.window_bin_params), so per-bin
                # counts and extrema stay bit-identical to the host rule
                qbounds = np.concatenate(
                    [[0], np.cumsum([len(it["local"]) for it in its])]
                ).astype(np.int64)
                vmin_s = np.concatenate(
                    [ti.meta_min[attr][it["local"]] for it in its])
                vmax_s = np.concatenate(
                    [ti.meta_max[attr][it["local"]] for it in its])
                agg, suffix_w = self._heatmap_multi(
                    ti, xs[a:b], ys[a:b], vals[a:b], f_bounds, windows,
                    vmin_s, vmax_s, qbounds, bx, by)
                contribs = [
                    (agg[s, :, 0].astype(np.int64), agg[s, :, 1].copy(),
                     agg[s, :, 2].copy(), agg[s, :, 3].copy())
                    for s in range(s1 - s0)]
                zrow = np.zeros((1, bx * by), suffix_w.dtype)
                for q, it in enumerate(its):
                    qa, qb_ = int(qbounds[q]), int(qbounds[q + 1])
                    it["contribs"] = contribs[qa:qb_]
                    # each item's span + its literal zero terminal row —
                    # the exact (L+1, nb) matrix read_batch_heatmap's
                    # payload carries (row L must be exactly 0: the φ=0
                    # selection may never see a subtraction residue)
                    it["suffix_w"] = np.concatenate(
                        [suffix_w[qa:qb_], zrow])

        # per-item payloads: slices of the group gather — identical
        # content to what TileIndex.read_batch(_heatmap) would build
        for it in group_items:
            s0, s1 = it["seg"]
            a, b = int(bounds[s0]), int(bounds[s1])
            payload = {"tile_ids": it["local"], "idx": idx[a:b],
                       "bounds": bounds[s0:s1 + 1] - bounds[s0],
                       "xs": xs[a:b], "ys": ys[a:b], "vals": vals[a:b],
                       "attr": attr}
            tk = it["qr"].tk
            if tk.kind == "heatmap":
                payload["suffix_w"] = it["suffix_w"]
                payload["split_edges"] = ti._heatmap_split_edges(
                    it["local"], tk.window, tk.bins)
                cache = ti.heatmap_cache(tk.window, tk.bins, attr)
                payload["hm_key"] = (ti._hm_key if cache is not None
                                     else None)
                payload["hm_contribs"] = it["contribs"]
            it["payload"] = payload

    def _heatmap_multi(self, ti, xs, ys, vals, bounds, windows, vmin_s,
                       vmax_s, qbounds, bx, by):
        """One ``segment_window_bin_select_multi`` pass; device backends
        are chunked to the reference's static segment limit at
        QUERY-SPAN boundaries (suffix widths are per-span quantities, so
        a span never straddles a chunk; every span is ≤ batch_k ≤
        MAX_SEGMENTS segments). A device pass moves its table and
        suffix widths to the host in one copy: the kernel's, adjacent
        views of one buffer, as they lie; any other joined on the
        device first."""
        n_seg = len(bounds) - 1
        if ti._backend == "np" or n_seg <= MAX_SEGMENTS:
            ti.adapt_stats.kernel_calls += 1
            agg, suffix_w = ops.segment_window_bin_select_multi(
                xs, ys, vals, bounds, windows, vmin_s, vmax_s, qbounds,
                bx=bx, by=by, backend=ti._backend)
            if ti._backend == "np":
                return np.asarray(agg), np.asarray(suffix_w)
            if _adjacent(agg, suffix_w):
                return _host_pair(agg, suffix_w)
            aggs, sufs = [agg], [suffix_w]
        else:
            qb = np.asarray(qbounds, np.int64)
            aggs, sufs = [], []
            s = 0
            while s < len(qb) - 1:
                e = s + 1
                while e < len(qb) - 1 and qb[e + 1] - qb[s] <= MAX_SEGMENTS:
                    e += 1
                a, b = int(qb[s]), int(qb[e])
                o0, o1 = int(bounds[a]), int(bounds[b])
                ti.adapt_stats.kernel_calls += 1
                agg, suf = ops.segment_window_bin_select_multi(
                    xs[o0:o1], ys[o0:o1], vals[o0:o1],
                    bounds[a:b + 1] - bounds[a], windows[a:b],
                    vmin_s[a:b], vmax_s[a:b], qb[s:e + 1] - qb[s],
                    bx=bx, by=by, backend=ti._backend)
                aggs.append(agg)
                sufs.append(suf)
                s = e
        nb = bx * by
        both = _host(torch.cat([torch.cat(aggs).reshape(n_seg, 4 * nb),
                                torch.cat(sufs)], 1))
        return both[:, :4 * nb].reshape(n_seg, nb, 4), both[:, 4 * nb:]

    def _scalar_multi(self, ti, xs, ys, vals, bounds, windows):
        """One ``segment_window_agg_multi`` pass; device backends are
        chunked to the reference's static segment limit (the host "np"
        mirror has none) and move the table to the host in one copy."""
        n_seg = len(bounds) - 1
        if ti._backend == "np" or n_seg <= MAX_SEGMENTS:
            ti.adapt_stats.kernel_calls += 1
            return _host(ops.segment_window_agg_multi(
                xs, ys, vals, bounds, windows, backend=ti._backend))
        outs = []
        for s in range(0, n_seg, MAX_SEGMENTS):
            e = min(s + MAX_SEGMENTS, n_seg)
            a, b = int(bounds[s]), int(bounds[e])
            ti.adapt_stats.kernel_calls += 1
            outs.append(ops.segment_window_agg_multi(
                xs[a:b], ys[a:b], vals[a:b], bounds[s:e + 1] - bounds[s],
                windows[s:e], backend=ti._backend))
        return _host(torch.cat(outs))

    def _canonicalize_hm(self, tickets) -> None:
        """Re-key each part's session bin-grid registry to the LAST
        overlapping heatmap ticket (arrival order) — the state the
        sequential reference naturally ends a tick in, whatever order
        the micro rounds interleaved reads (rotation is what gates
        which staged registrations survive publication)."""
        for tk in tickets:
            if tk.kind == "heatmap":
                for ti in self._parts_silent(tk.window):
                    ti.heatmap_cache(tk.window, tk.bins, tk.attr)

    def _parts_silent(self, window):
        """Window-overlapping, already-materialized parts — without the
        pruning accounting of :meth:`ChunkIndexSet.parts`."""
        index = self.index
        if not isinstance(index, ChunkIndexSet):
            return [index]
        out = []
        for chunk in index.ds.chunks():
            ti = index._indexes.get(chunk.chunk_id)
            if ti is not None and _chunk_overlaps(chunk.bbox, window):
                out.append(ti)
        return out


__all__ = ["ServingEngine", "Session", "Ticket", "NullStage"]
