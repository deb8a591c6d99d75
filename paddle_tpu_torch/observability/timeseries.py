"""Windowed time series of the metrics registry.

Counterpart of ``paddle_tpu/observability/timeseries.py`` (standard
library only, so the port keeps its own copy). Lifetime counter ratios
drown a regression of the last minute in hours of good history; this
module keeps a bounded ring of ``(wall_ts, value)`` points a metric,
sampled on the per-process dumper's tick, so that a reader can ask for
the delta or rate over the last window (``counter_rate``).

- Armed by ``PADDLE_TPU_METRICS_DIR`` (the knob that arms the dumps);
  ``PADDLE_TPU_TIMESERIES=0`` forces it off. Both are memoized: the
  disarmed path is one load and a branch.
- A ring holds ``PADDLE_TPU_TIMESERIES_WINDOWS`` points (default 64).
- Counters are sampled as absolute values; a window's delta sums the
  hops, each clamped at 0, so a counter reset across a relaunch reads as
  no progress, never a negative rate.
- A histogram rides as two monotone series, ``<qn>#sum`` and
  ``<qn>#count``: a window's mean is ``delta(sum) / delta(count)``.

Each process's series ride its dump (``distributed.dump_process`` adds
``doc["series"]``); ``job_windows`` folds several processes' series into
windows of one wall interval, each process's timestamps rebased by its
applied clock skew.
"""
from __future__ import annotations

import os
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

SERIES_ENV = "PADDLE_TPU_TIMESERIES"
WINDOWS_ENV = "PADDLE_TPU_TIMESERIES_WINDOWS"
ARM_ENV = "PADDLE_TPU_METRICS_DIR"
DEFAULT_WINDOWS = 64

_OFF_VALUES = ("0", "off", "false", "no")

# memoized knobs: None = unread. Read-mostly after first touch; the
# lock only guards the (rare) mutation of the series store itself.
_ENABLED: Optional[bool] = None
_CAP: Optional[int] = None
_lock = threading.Lock()
# qualified metric name -> {"kind": "counter"|"gauge",
#                           "points": deque[(wall_ts, value)]}
_store: Dict[str, Dict[str, Any]] = {}


def series_enabled() -> bool:
    """True iff sampling is armed: dumps are on (metrics dir set) and
    ``PADDLE_TPU_TIMESERIES`` does not force it off. Memoized."""
    global _ENABLED
    if _ENABLED is None:
        raw = os.environ.get(SERIES_ENV, "").strip().lower()
        if raw in _OFF_VALUES and raw != "":
            _ENABLED = False
        else:
            _ENABLED = bool(os.environ.get(ARM_ENV))
    return _ENABLED


def window_cap() -> int:
    """Ring bound: points kept per series. Memoized; min 2 (a delta
    needs two samples)."""
    global _CAP
    if _CAP is None:
        try:
            _CAP = int(os.environ.get(WINDOWS_ENV, "") or DEFAULT_WINDOWS)
        except ValueError:
            _CAP = DEFAULT_WINDOWS
        if _CAP < 2:
            _CAP = 2
    return _CAP


def _reset_for_tests() -> None:
    global _ENABLED, _CAP
    with _lock:
        _ENABLED = None
        _CAP = None
        _store.clear()


def _append_locked(name: str, kind: str, ts: float, value: float) -> None:
    ser = _store.get(name)
    if ser is None:
        ser = {"kind": kind, "points": deque(maxlen=window_cap())}
        _store[name] = ser
    ser["points"].append((ts, value))


def record_point(name: str, value: Any, wall_ts: Optional[float] = None,
                 kind: str = "gauge") -> None:
    """Record one sample of one series. Safe to call unconditionally:
    no-op (memoized branch) when sampling is off or the value is not
    numeric."""
    if not series_enabled():
        return
    if not isinstance(value, (int, float)) or isinstance(value, bool):
        return
    import time

    ts = float(wall_ts) if wall_ts is not None else time.time()
    with _lock:
        _append_locked(name, kind, ts, float(value))


def record_samples(snapshot: Optional[Dict[str, Any]],
                   wall_ts: Optional[float] = None) -> int:
    """Sample every metric in a registry ``snapshot()`` dict into the
    ring. Called on the periodic-dump tick. Returns the number of
    series touched (0 when disabled or the snapshot is unusable)."""
    if not series_enabled():
        return 0
    if not isinstance(snapshot, dict):
        return 0
    import time

    ts = float(wall_ts) if wall_ts is not None else time.time()
    touched = 0
    counters = snapshot.get("counters") or {}
    gauges = snapshot.get("gauges") or {}
    histograms = snapshot.get("histograms") or {}
    with _lock:
        for qn, v in counters.items():
            if isinstance(v, (int, float)):
                _append_locked(qn, "counter", ts, float(v))
                touched += 1
        for qn, v in gauges.items():
            if isinstance(v, (int, float)):
                _append_locked(qn, "gauge", ts, float(v))
                touched += 1
        for qn, h in histograms.items():
            if not isinstance(h, dict):
                continue
            s, c = h.get("sum"), h.get("count")
            if isinstance(s, (int, float)) and isinstance(c, (int, float)):
                # monotone pair: windowed mean = delta(sum)/delta(count)
                _append_locked(qn + "#sum", "counter", ts, float(s))
                _append_locked(qn + "#count", "counter", ts, float(c))
                touched += 1
    return touched


def process_series() -> Dict[str, Dict[str, Any]]:
    """JSON-able snapshot of this process's rings:
    ``{qn: {"kind": ..., "points": [[ts, value], ...]}}``. Empty when
    sampling is off or nothing was recorded."""
    if not series_enabled():
        return {}
    out: Dict[str, Dict[str, Any]] = {}
    with _lock:
        for qn, ser in _store.items():
            out[qn] = {"kind": ser["kind"],
                       "points": [[t, v] for (t, v) in ser["points"]]}
    return out


# ---------------------------------------------------------------------------
# pure window queries (operate on a points list; no global state)
# ---------------------------------------------------------------------------

def _window_points(points: Sequence[Sequence[float]],
                   window_s: Optional[float] = None,
                   now: Optional[float] = None
                   ) -> List[Tuple[float, float]]:
    pts = [(float(p[0]), float(p[1])) for p in points
           if isinstance(p, (list, tuple)) and len(p) >= 2]
    pts.sort(key=lambda p: p[0])
    if window_s is None or not pts:
        return pts
    t_hi = float(now) if now is not None else pts[-1][0]
    t_lo = t_hi - float(window_s)
    return [p for p in pts if p[0] >= t_lo]


def counter_delta(points: Sequence[Sequence[float]],
                  window_s: Optional[float] = None,
                  now: Optional[float] = None) -> Optional[float]:
    """Total increase of a sampled monotone counter over the trailing
    window. Each adjacent hop contributes ``max(0, v[i+1]-v[i])`` — a
    drop (counter reset across relaunch) clamps that hop at 0, so the
    delta never goes negative. None with fewer than 2 points."""
    pts = _window_points(points, window_s, now)
    if len(pts) < 2:
        return None
    total = 0.0
    for (_, a), (_, b) in zip(pts, pts[1:]):
        total += max(0.0, b - a)
    return total


def window_span(points: Sequence[Sequence[float]],
                window_s: Optional[float] = None,
                now: Optional[float] = None) -> Optional[float]:
    """Seconds between first and last point in the window; None with
    fewer than 2 points."""
    pts = _window_points(points, window_s, now)
    if len(pts) < 2:
        return None
    return pts[-1][0] - pts[0][0]


def counter_rate(points: Sequence[Sequence[float]],
                 window_s: Optional[float] = None,
                 now: Optional[float] = None) -> Optional[float]:
    """Windowed delta / windowed span (per-second rate); None when the
    delta is undefined or the span is not positive."""
    delta = counter_delta(points, window_s, now)
    span = window_span(points, window_s, now)
    if delta is None or span is None or span <= 0:
        return None
    return delta / span


def last_value(points: Sequence[Sequence[float]]) -> Optional[float]:
    pts = _window_points(points)
    return pts[-1][1] if pts else None


# ---------------------------------------------------------------------------
# job-level fold (used by distributed.merge_job_dir)
# ---------------------------------------------------------------------------

def job_windows(per_proc_series: Dict[str, Dict[str, Dict[str, Any]]],
                skews_us: Optional[Dict[str, float]] = None,
                window_s: Optional[float] = None) -> Dict[str, Any]:
    """Fold per-process series into job-aligned windows. Each rank's
    timestamps are rebased by its APPLIED clock skew (the
    correction: ``distributed.applied_clock_skew_us``) so a window
    means the same wall interval on every rank. Counter series fold to
    a summed-across-ranks delta + rate with per-rank provenance;
    gauge series fold to per-rank last values."""
    skews_us = skews_us or {}
    out: Dict[str, Any] = {}
    by_metric: Dict[str, Dict[str, Dict[str, Any]]] = {}
    for proc, series in (per_proc_series or {}).items():
        if not isinstance(series, dict):
            continue
        off_s = float(skews_us.get(proc, 0.0) or 0.0) / 1e6
        for qn, ser in series.items():
            if not isinstance(ser, dict):
                continue
            pts = [[float(p[0]) - off_s, float(p[1])]
                   for p in (ser.get("points") or [])
                   if isinstance(p, (list, tuple)) and len(p) >= 2]
            if not pts:
                continue
            slot = by_metric.setdefault(qn, {})
            slot[proc] = {"kind": ser.get("kind", "gauge"), "points": pts}
    for qn, ranks in by_metric.items():
        kinds = {r["kind"] for r in ranks.values()}
        kind = "counter" if kinds == {"counter"} else (
            "gauge" if kinds == {"gauge"} else "mixed")
        if kind == "counter":
            per_rank: Dict[str, Any] = {}
            total = 0.0
            t0: Optional[float] = None
            t1: Optional[float] = None
            for proc, ser in ranks.items():
                d = counter_delta(ser["points"], window_s)
                if d is None:
                    continue
                span = window_span(ser["points"], window_s) or 0.0
                pts = _window_points(ser["points"], window_s)
                per_rank[proc] = {
                    "delta": d,
                    "rate": (d / span) if span > 0 else None,
                    "t0": pts[0][0], "t1": pts[-1][0],
                }
                total += d
                t0 = pts[0][0] if t0 is None else min(t0, pts[0][0])
                t1 = pts[-1][0] if t1 is None else max(t1, pts[-1][0])
            if not per_rank:
                continue
            span = (t1 - t0) if (t0 is not None and t1 is not None) else 0.0
            out[qn] = {"kind": "counter", "delta": total,
                       "rate": (total / span) if span > 0 else None,
                       "t0": t0, "t1": t1, "per_rank": per_rank}
        else:
            per_rank = {}
            for proc, ser in ranks.items():
                v = last_value(ser["points"])
                if v is not None:
                    per_rank[proc] = v
            if per_rank:
                out[qn] = {"kind": kind, "per_rank": per_rank}
    return out
