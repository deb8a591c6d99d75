"""Host span buffer: one bounded in-process list of completed spans.

Counterpart of the metrics half of ``paddle_tpu/observability/tracing.py``
(the legacy profiler sessions and the on-disk spool stay with the JAX
package's profiler work). ``observability.enable()`` arms it; while it
is disarmed the serving hooks (``distributed.child_span`` /
``record_span``) record nothing.

Span records are tuples ``(name, ts_us, dur_us, tid, cat, args)`` (args
may be None): ``ts_us`` is ``time.perf_counter()`` in microseconds, the
shape of a chrome ``trace_event`` "X" entry.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Tuple

__all__ = ["active", "trace_events", "clear", "stats"]

_MAX_EVENTS = 65536

_lock = threading.Lock()
_events: List[Tuple] = []   # (name, ts_us, dur_us, tid, cat, args)
_dropped = 0
_metrics_on = False


def active() -> bool:
    return _metrics_on


def _set_metrics_on(on: bool) -> None:
    global _metrics_on
    _metrics_on = bool(on)


def _record(name, ts_us, dur_us, cat, args) -> None:
    global _dropped
    ev = (name, ts_us, dur_us, threading.get_ident(), cat, args)
    with _lock:
        if len(_events) >= _MAX_EVENTS:
            # drop the oldest half in one move; the newest spans survive
            cut = _MAX_EVENTS // 2
            del _events[:cut]
            _dropped += cut
        _events.append(ev)


def stats() -> Dict[str, int]:
    with _lock:
        return {"recorded": len(_events), "dropped": _dropped}


def trace_events() -> List[Tuple]:
    with _lock:
        return list(_events)


def clear() -> None:
    global _dropped
    with _lock:
        del _events[:]
        _dropped = 0
