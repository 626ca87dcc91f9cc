"""Windowed streaming aggregation over timestamped point streams (copy
of src/repro/analytics/window.py, numpy only; DESIGN.md §16).

``WindowedAggregator`` turns a stream of ``(timestamp, assigned block
ids, source ids)`` observations into per-window per-block statistics —
the mContain-style encounter/crowding workload the paper motivates:

  * **occupancy counts** per block per window (and crowding density,
    counts / block area, when the aggregator knows the geometry);
  * **distinct sources** per block per window via a linear-counting
    ``DistinctSketch`` (sketch.py) — mergeable, hash-only state;
  * **co-location / encounter counts**: distinct-pair counts
    ``C(d, 2)`` per block per window, d = the block's distinct-source
    estimate (two sources in the same block in the same window = one
    potential encounter pair);
  * **k-anonymity suppression**: blocks with fewer than ``k_anon``
    distinct sources in a window are suppressed from every published
    snapshot (the raw state keeps them — suppression is a publication
    rule, not a data loss).

**Window state machine.**  Internally everything is *tumbling panes* of
``slide_s`` seconds keyed by integer pane index ``floor(ts /
slide_s)``.  A window starting at pane ``w`` is the merge of panes
``[w, w + n_panes)`` where ``n_panes = window_s / slide_s`` (tumbling
windows are the ``n_panes == 1`` special case).  Pane state is
**mergeable** — counter sums and sketch ORs, the ``GeoStats.merge``
discipline: associative, commutative, non-mutating — which is what
makes sliding windows exact compositions of panes and lets concurrent
replica threads fold into one aggregator in any arrival order.

Event time, not arrival time, decides window membership, so the
pipeline tolerates out-of-order feeds: the watermark trails the max
observed timestamp by ``allowed_lateness_s``; an event whose *last*
covering window has already closed is dropped (counted in
``late_dropped``).  A window finalizes — its merged snapshot appended
to a bounded history — when the watermark passes its end; panes are
evicted once every window covering them has closed, so open state is
bounded by ``n_panes + lateness/slide`` panes regardless of stream
length.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.analytics.sketch import DEF_BITS, DistinctSketch


@dataclasses.dataclass(frozen=True)
class AnalyticsConfig:
    """Static windowed-analytics knobs (serving opts in via
    ``ServeConfig(analytics=AnalyticsConfig(...))``)."""

    window_s: float = 60.0             # window length (event time)
    slide_s: Optional[float] = None    # pane/slide; None = tumbling
    k_anon: int = 0                    # suppress blocks with fewer
    #                                    distinct sources (0 = off)
    sketch_bits: int = DEF_BITS        # distinct-sketch bitmap width
    allowed_lateness_s: Optional[float] = None  # None = window_s
    top_k: int = 10                    # rows in published snapshots
    max_finalized: int = 64            # finalized-window history bound
    # Serving timestamp source: the host stage stamps each batch once
    # with this clock (arrival order — see server._prepare_batch);
    # injectable for deterministic tests/replays.  Event time is
    # *wall* time on purpose: pane boundaries must line up across
    # processes and survive restarts, which monotonic clocks (origin
    # = process start) cannot do.
    clock: Callable[[], float] = time.time  # wallclock-ok: event time

    def resolve(self) -> tuple[float, int, float]:
        """(slide_s, n_panes, lateness_s) with validation."""
        slide = self.slide_s if self.slide_s is not None else self.window_s
        if slide <= 0 or self.window_s <= 0:
            raise ValueError(f"window_s/slide_s must be > 0, got "
                             f"{self.window_s}/{slide}")
        n_panes = round(self.window_s / slide)
        if n_panes < 1 or abs(n_panes * slide - self.window_s) > 1e-9:
            raise ValueError(f"window_s must be an integer multiple of "
                             f"slide_s, got {self.window_s}/{slide}")
        lateness = self.allowed_lateness_s \
            if self.allowed_lateness_s is not None else self.window_s
        if lateness < 0:
            raise ValueError(f"allowed_lateness_s must be >= 0, "
                             f"got {lateness}")
        return float(slide), int(n_panes), float(lateness)


class WindowState:
    """One pane's (or merged window's) mergeable state: per-block int64
    occupancy counts + the distinct-source sketch.  ``observe`` expects
    pre-validated ids in [0, n_blocks); ``merge`` returns a NEW state
    (sums and bitmap ORs — exactly associative and commutative, the
    GeoStats.merge discipline)."""

    __slots__ = ("counts", "sketch", "n_events")

    def __init__(self, n_blocks: int, sketch_bits: int = DEF_BITS, *,
                 counts: Optional[np.ndarray] = None,
                 sketch: Optional[DistinctSketch] = None,
                 n_events: int = 0):
        self.counts = counts if counts is not None \
            else np.zeros(n_blocks, np.int64)
        self.sketch = sketch if sketch is not None \
            else DistinctSketch(n_blocks, sketch_bits)
        self.n_events = n_events

    def observe(self, bids: np.ndarray,
                sources: Optional[np.ndarray] = None) -> None:
        np.add.at(self.counts, bids, 1)
        self.n_events += int(bids.size)
        if sources is not None:
            self.sketch.observe(bids, sources)

    def merge(self, other: "WindowState") -> "WindowState":
        return WindowState(len(self.counts),
                           counts=self.counts + other.counts,
                           sketch=self.sketch.merge(other.sketch),
                           n_events=self.n_events + other.n_events)


@dataclasses.dataclass
class WindowSnapshot:
    """One window's published view.  Arrays are [n_blocks]-shaped;
    ``suppressed`` marks active blocks below the k-anonymity threshold
    — ``top_k``/``as_dict`` (the serving surfaces) exclude them, the
    arrays keep them so tests and merges stay exact."""

    start: float
    end: float
    n_events: int
    counts: np.ndarray                  # [S] int64 occupancy
    distinct: np.ndarray                # [S] int64 distinct-source est.
    pairs: np.ndarray                   # [S] int64 encounter pairs
    suppressed: np.ndarray              # [S] bool
    density: Optional[np.ndarray]       # [S] f64, None without geometry
    k_anon: int

    def top_k(self, k: int = 10) -> list:
        """Top-k crowded publishable blocks (suppression applied),
        densest-by-count first."""
        ok = (self.counts > 0) & ~self.suppressed
        order = np.argsort(-self.counts[ok], kind="stable")
        rows = np.nonzero(ok)[0][order][:k]
        return [{"block": int(b), "count": int(self.counts[b]),
                 "distinct": int(self.distinct[b]),
                 "pairs": int(self.pairs[b]),
                 "density": (float(self.density[b])
                             if self.density is not None else None)}
                for b in rows]

    def as_dict(self, top_k: int = 10) -> dict:
        active = int((self.counts > 0).sum())
        return {"start": self.start, "end": self.end,
                "n_events": int(self.n_events),
                "active_blocks": active,
                "suppressed_blocks": int(self.suppressed.sum()),
                "k_anon": self.k_anon,
                "top": self.top_k(top_k)}


class WindowedAggregator:
    """The streaming per-block aggregator (see module docstring).

    Thread-safe: ``observe``/``snapshot``/``current`` run under one
    lock, and because pane folds are commutative sums, concurrent
    replica threads feeding batches out of completion order produce
    exactly the state an in-order feed would — window membership is
    decided by each batch's host-stage timestamp, not by who gets the
    lock first (DESIGN.md §16).
    """

    def __init__(self, n_blocks: int, cfg: Optional[AnalyticsConfig]
                 = None, areas: Optional[np.ndarray] = None):
        self.cfg = cfg or AnalyticsConfig()
        self.slide, self.n_panes, self.lateness = self.cfg.resolve()
        self.n_blocks = int(n_blocks)
        self.areas = None if areas is None \
            else np.asarray(areas, np.float64)
        if self.areas is not None:
            assert self.areas.shape == (self.n_blocks,), self.areas.shape
        self.panes: dict[int, WindowState] = {}     # guarded-by: _lock
        self.finalized: list[WindowSnapshot] = []   # guarded-by: _lock
        self.finalized_total = 0                    # guarded-by: _lock
        self.observed = 0                           # guarded-by: _lock
        self.off_map = 0                            # guarded-by: _lock
        self.late_dropped = 0                       # guarded-by: _lock
        self._max_ts = -math.inf                    # guarded-by: _lock
        self._last_emitted: Optional[int] = None    # guarded-by: _lock
        self._lock = threading.Lock()

    # -- feed --------------------------------------------------------------

    def observe(self, ts: float, bids, sources=None) -> int:
        """Fold one observation batch: ``bids`` [n] assigned block ids
        (< 0 / >= n_blocks counted as ``off_map`` and skipped),
        ``sources`` [n] optional source identities for the distinct
        sketch.  Returns rows absorbed (0 = the batch was beyond the
        lateness horizon and dropped)."""
        bids = np.asarray(bids).astype(np.int64).ravel()
        if sources is not None:
            sources = np.asarray(sources).ravel()
            assert sources.shape == bids.shape, (sources.shape,
                                                 bids.shape)
        with self._lock:
            self.observed += int(bids.size)
            self._max_ts = max(self._max_ts, float(ts))
            pane = math.floor(float(ts) / self.slide)
            if (pane + self.n_panes) * self.slide <= self._watermark():
                self.late_dropped += int(bids.size)
                self._advance()
                return 0
            valid = (bids >= 0) & (bids < self.n_blocks)
            self.off_map += int((~valid).sum())
            state = self.panes.get(pane)
            if state is None:
                state = self.panes[pane] = WindowState(
                    self.n_blocks, self.cfg.sketch_bits)
            state.observe(bids[valid],
                          None if sources is None else sources[valid])
            self._advance()
            return int(valid.sum())

    def advance(self, ts: float) -> int:
        """Push the watermark to ``ts - allowed_lateness`` without
        observing events (e.g. a quiet stream's periodic tick); returns
        windows finalized by the push."""
        with self._lock:
            before = self.finalized_total
            self._max_ts = max(self._max_ts, float(ts))
            self._advance()
            return self.finalized_total - before

    # -- state machine (lock held) ----------------------------------------

    def _watermark(self) -> float:
        return self._max_ts - self.lateness

    def _window_state(self, w: int) -> Optional[WindowState]:
        state = None
        for p in range(w, w + self.n_panes):
            pane = self.panes.get(p)
            if pane is not None:
                state = pane if state is None else state.merge(pane)
        return state

    def _advance(self) -> None:  # requires-lock: _lock
        wm = self._watermark()
        windows = sorted({w for p in self.panes
                          for w in range(p - self.n_panes + 1, p + 1)})
        for w in windows:
            if (w + self.n_panes) * self.slide > wm:
                break
            if self._last_emitted is not None and w <= self._last_emitted:
                continue
            state = self._window_state(w)
            if state is not None and state.n_events:
                self.finalized.append(self._snap(w, state))
                del self.finalized[:-self.cfg.max_finalized]
                self.finalized_total += 1
            self._last_emitted = w
        for p in [p for p in self.panes
                  if (p + self.n_panes) * self.slide <= wm]:
            del self.panes[p]

    def _snap(self, w: int, state: WindowState) -> WindowSnapshot:
        distinct = state.sketch.estimate_round()
        pairs = distinct * (distinct - 1) // 2
        if self.cfg.k_anon > 0:
            suppressed = (state.counts > 0) & (distinct < self.cfg.k_anon)
        else:
            suppressed = np.zeros(self.n_blocks, bool)
        density = None
        if self.areas is not None:
            with np.errstate(divide="ignore", invalid="ignore"):
                density = np.where(self.areas > 0,
                                   state.counts / self.areas, 0.0)
        return WindowSnapshot(start=w * self.slide,
                              end=w * self.slide + self.cfg.window_s,
                              n_events=state.n_events,
                              counts=state.counts, distinct=distinct,
                              pairs=pairs, suppressed=suppressed,
                              density=density, k_anon=self.cfg.k_anon)

    # -- read --------------------------------------------------------------

    def current(self) -> Optional[WindowSnapshot]:
        """The open window's live snapshot: the most-complete window
        containing the newest observed pane (None = no open state)."""
        with self._lock:
            if not self.panes or not math.isfinite(self._max_ts):
                return None
            w = math.floor(self._max_ts / self.slide) - self.n_panes + 1
            state = self._window_state(w)
            if state is None or not state.n_events:
                return None
            return self._snap(w, state)

    def snapshot(self) -> dict:
        """JSON-ready view: config echo, feed counters, the finalized
        window history (suppression applied to every published row) and
        the open window (DESIGN.md §16 schema; scripts/analytics_smoke.py
        checks it)."""
        with self._lock:
            fin = [s.as_dict(self.cfg.top_k) for s in self.finalized]
            if self.panes and math.isfinite(self._max_ts):
                w = math.floor(self._max_ts / self.slide) \
                    - self.n_panes + 1
                state = self._window_state(w)
                open_d = (self._snap(w, state).as_dict(self.cfg.top_k)
                          if state is not None and state.n_events
                          else None)
            else:
                open_d = None
            return {"config": {"window_s": self.cfg.window_s,
                               "slide_s": self.slide,
                               "k_anon": self.cfg.k_anon,
                               "sketch_bits": self.cfg.sketch_bits,
                               "lateness_s": self.lateness},
                    "observed": self.observed,
                    "off_map": self.off_map,
                    "late_dropped": self.late_dropped,
                    "open_panes": len(self.panes),
                    "finalized_total": self.finalized_total,
                    "finalized": fin,
                    "open": open_d}
