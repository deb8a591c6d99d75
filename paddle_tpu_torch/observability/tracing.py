"""Host spans: one bounded in-process buffer of completed spans.

Counterpart of ``paddle_tpu/observability/tracing.py`` (standard library
only, so the port keeps its own copy). Fed by the executor's
``compiled_step`` spans, the interpreter's ops under a profiler session,
the data-parallel engine's ``parallel/step``, the pipeline's
``pipeline/step`` / ``pipeline/stage`` and the serving front's request
spans. Two switches arm it:

- the metrics layer (``PADDLE_TPU_METRICS`` / ``FLAGS_tpu_metrics``,
  ``observability.enable()``): always-on telemetry, exported by
  ``observability.chrome_trace()``;
- a ``fluid.profiler`` session (``start_profiler`` / ``stop_profiler``):
  bounded in time, its spans drained into the session's snapshot at the
  stop, so that sessions never bleed into each other.

Disarmed, ``span()`` returns one shared no-op context manager: no
allocation and no clock read.

Span records are tuples ``(name, ts_us, dur_us, tid, cat, args)`` (args
may be None), ``ts_us`` on ``time.perf_counter()``'s clock: a chrome
``trace_event`` "X" entry's fields. With the span spool installed
(``observability/spool.py``) every record is offered to it too.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["span", "active", "trace_events", "chrome_trace",
           "write_chrome_trace", "clear"]

_MAX_EVENTS = 65536

_lock = threading.Lock()
_events: List[Tuple] = []   # (name, ts_us, dur_us, tid, cat, args)
_dropped = 0

# on-disk span spool (observability/spool.py), installed by
# distributed.arm when PADDLE_TPU_METRICS_DIR is set: the bounded ring
# above then becomes a live CACHE while the spool's head segments +
# seeded reservoir are the RECORD a day-long job merges from. None
# (the default) costs one attribute load per recorded span.
_spool = None


def _set_spool(sp) -> None:
    global _spool
    _spool = sp


def spool():
    return _spool

# armed-by: the metrics layer (observability.enable) and/or a legacy
# profiler session (profiler.start_profiler)
_metrics_on = False
_profiler_on = False
_session_start = 0   # index into _events where the live session began
# exact per-name (count, total_us) aggregates for the live profiler
# session: the span BUFFER is bounded (old spans drop under pressure)
# but the session summary table must stay exact for any session length
# — the contract the old profiler's _host_events defaultdict kept
_session_agg: Dict[str, List] = {}


def active() -> bool:
    return _metrics_on or _profiler_on


def _set_metrics_on(on: bool) -> None:
    global _metrics_on
    _metrics_on = bool(on)


class _NullSpan:
    """Shared disabled-path context manager — zero per-use allocation."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


# set by a fluid.profiler device session (``torch.profiler.
# record_function``): every span then opens a range of that name too, so
# that the session's table gives its device time beside its host time
_range_fn = None


def _set_range_fn(fn) -> None:
    global _range_fn
    _range_fn = fn


class Span:
    __slots__ = ("name", "cat", "args", "_t0", "_rf")

    def __init__(self, name: str, cat: str, args: Optional[Dict]):
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        rf = _range_fn
        self._rf = rf(self.name) if rf is not None else None
        if self._rf is not None:
            self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if active():   # session may have stopped mid-span; drop then
            dur = time.perf_counter() - self._t0
            _record(self.name, self._t0 * 1e6, dur * 1e6,
                    self.cat, self.args)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def span(name: str, cat: str = "op", **args):
    """Context manager timing a host span. No-op unless the layer is
    armed. Nesting works naturally (inner spans simply record shorter,
    later-starting intervals on the same thread id — chrome tracing
    reconstructs the stack from containment)."""
    if not (_metrics_on or _profiler_on):
        return _NULL
    return Span(name, cat, args or None)


def _record(name, ts_us, dur_us, cat, args) -> None:
    global _dropped, _session_start
    ev = (name, ts_us, dur_us, threading.get_ident(), cat, args)
    with _lock:
        if _profiler_on:
            agg = _session_agg.get(name)
            if agg is None:
                agg = _session_agg[name] = [0, 0.0]
            agg[0] += 1
            agg[1] += dur_us
        if len(_events) >= _MAX_EVENTS:
            # drop the oldest half in one move: amortized O(1) per
            # record, and the newest spans (the ones being debugged)
            # survive
            cut = _MAX_EVENTS // 2
            del _events[:cut]
            _dropped += cut
            _session_start = max(0, _session_start - cut)
        _events.append(ev)
    sp = _spool
    if sp is not None:
        sp.offer(ev)


def stats() -> Dict[str, int]:
    with _lock:
        return {"recorded": len(_events), "dropped": _dropped}


def trace_events() -> List[Tuple]:
    """All buffered spans (live metrics spans + any live profiler
    session)."""
    with _lock:
        return list(_events)


def clear() -> None:
    global _dropped, _session_start
    with _lock:
        del _events[:]
        _dropped = 0
        _session_start = 0
        _session_agg.clear()


# -- legacy profiler sessions ---------------------------------------------

def profiler_session_active() -> bool:
    return _profiler_on


def profiler_session_start() -> None:
    global _profiler_on, _session_start
    with _lock:
        _session_start = len(_events)
        _session_agg.clear()
    _profiler_on = True


def profiler_session_events() -> List[Tuple]:
    """Spans recorded since the live session started (empty when no
    session is live)."""
    if not _profiler_on:
        return []
    with _lock:
        return list(_events[_session_start:])


def profiler_session_reset() -> None:
    """Discard the live session's spans and aggregates without ending
    it (and without touching metrics-mode spans recorded before the
    session — the legacy reset_profiler only ever owned its own
    events)."""
    global _session_start
    with _lock:
        if _profiler_on:
            del _events[_session_start:]
        else:
            _session_start = len(_events)
        _session_agg.clear()


def profiler_session_stop():
    """End the live session: (spans, exact per-name aggregates). The
    spans are drained OUT of the buffer (the old profiler's
    snapshot-and-clear contract: sessions never bleed into each other,
    and a later metrics-mode chrome export doesn't double-count them);
    the aggregates are exact even if buffer pressure dropped old spans
    mid-session. A stop with no live session is a harmless no-op (the
    legacy profiler tolerated it; without this guard it would drain
    metrics-mode spans that were never the session's)."""
    global _profiler_on
    if not _profiler_on:
        return [], {}
    _profiler_on = False
    with _lock:
        sess = list(_events[_session_start:])
        del _events[_session_start:]
        agg = {k: tuple(v) for k, v in _session_agg.items()}
        _session_agg.clear()
    return sess, agg


# -- chrome trace_event export --------------------------------------------

def chrome_trace(extra_events=None) -> Dict:
    """chrome://tracing / Perfetto ``trace_event`` JSON object.

    Merges the live span buffer with ``extra_events`` — (name, ts_us,
    dur_us) triples or full 6-tuples — which is how the legacy
    ``profiler.get_trace_events()`` timeline survives into the unified
    export (observability.chrome_trace passes it in)."""
    seen = []
    for ev in trace_events():
        seen.append(ev)
    for ev in (extra_events or []):
        if len(ev) == 3:
            name, ts, dur = ev
            seen.append((name, ts, dur, 0, "op", None))
        else:
            seen.append(tuple(ev))
    out = []
    for name, ts, dur, tid, cat, args in seen:
        entry = {"name": name, "ph": "X", "ts": ts, "dur": dur,
                 "pid": 0, "tid": tid, "cat": cat}
        if args:
            entry["args"] = dict(args)
        out.append(entry)
    out.sort(key=lambda e: e["ts"])
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, extra_events=None) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(extra_events), f)
    return path
