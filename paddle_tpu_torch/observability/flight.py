"""Flight recorder: a bounded ring of recent structured events.

Counterpart of ``paddle_tpu/observability/flight.py`` (standard library
only, so the port keeps its own copy). Metrics say how many times something
happened; the ring says what the process was doing just before: each
interesting decision (a KV-cache preemption in the decode engine, say)
appends one small tuple to a process-wide ring of
``PADDLE_TPU_FLIGHT_RING`` entries (default 2048), and old history falls
off. Recording is unconditional and cheap: one ``deque.append``.

Event shape: ``(ts_us, kind, fields)``: ``ts_us`` is
``time.perf_counter()`` in microseconds, ``kind`` a dotted string
(``serving.kv_preempt``), ``fields`` a small dict of json-safe scalars or
None. Dumping the ring to disk and the crash hook wait for the job-level
dump (ROADMAP queue 1 item 11).
"""
from __future__ import annotations

import collections
import os
import time
from typing import Dict, List, Tuple

__all__ = ["record", "events", "clear", "stats"]

_RING_CAP = max(16, int(os.environ.get("PADDLE_TPU_FLIGHT_RING",
                                       "2048") or "2048"))
_ring: "collections.deque[Tuple]" = collections.deque(maxlen=_RING_CAP)
_recorded = 0  # total ever recorded (recorded - len(ring) = dropped)


def record(kind: str, /, **fields) -> None:
    """Append one event to the ring. Callers pass only small json-safe
    scalars in ``fields``."""
    global _recorded
    _ring.append((time.perf_counter() * 1e6, kind, fields or None))
    _recorded += 1


def events() -> List[Tuple]:
    """Snapshot of the ring, oldest first."""
    return list(_ring)


def clear() -> None:
    global _recorded
    _ring.clear()
    _recorded = 0


def stats() -> Dict[str, int]:
    n = len(_ring)
    return {"recorded": _recorded, "buffered": n,
            "dropped": _recorded - n, "capacity": _RING_CAP}
