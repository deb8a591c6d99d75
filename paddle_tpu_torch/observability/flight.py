"""Flight recorder: a bounded ring of recent structured events.

Counterpart of ``paddle_tpu/observability/flight.py`` (standard library
only, so the port keeps its own copy). Metrics say how many times something
happened; the ring says what the process was doing just before: each
interesting decision (a KV-cache preemption in the decode engine, a canary
decision, a steering proposal) appends one small tuple to a process-wide
ring of ``PADDLE_TPU_FLIGHT_RING`` entries (default 2048), and old history
falls off. Recording is unconditional and cheap: one ``deque.append``.
What is gated is persistence: the ring reaches disk in the per-process
dumps of ``observability.distributed`` (periodic, at exit, on SIGTERM),
and on an uncaught exception ``install_excepthook`` prints its tail to
stderr, so a worker with no metrics directory still leaves a postmortem in
its log.

Event shape: ``(ts_us, kind, fields)``: ``ts_us`` is
``time.perf_counter()`` in microseconds (the span clock; a dump carries
the offset that rebases both onto the wall clock), ``kind`` a dotted
string (``serving.kv_preempt``), ``fields`` a small dict of json-safe
scalars or None.
"""
from __future__ import annotations

import collections
import os
import sys
import time
from typing import Dict, List, Tuple

__all__ = ["record", "events", "clear", "stats", "tail_lines",
           "install_excepthook"]

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


def tail_lines(n: int = 50) -> List[str]:
    """The newest ``n`` events, one line each (the stderr postmortem;
    ``tools/torch_ft_timeline.py`` renders the merged job's)."""
    out = []
    for ts_us, kind, fields in list(_ring)[-n:]:
        kv = "" if not fields else " " + " ".join(
            "%s=%s" % (k, fields[k]) for k in sorted(fields))
        out.append("[flight +%12.3fms] %s%s" % (ts_us / 1e3, kind, kv))
    return out


def install_excepthook() -> None:
    """Chain a hook onto ``sys.excepthook`` that prints the ring's tail to
    stderr before the traceback, and dumps the process where a metrics
    directory is set: the last thing a crashing worker says is what it
    was doing. Once a process."""
    prev = sys.excepthook
    if getattr(prev, "_flight_hook", False):
        return

    def hook(exc_type, exc, tb):
        try:
            lines = tail_lines(50)
            if lines:
                print("-- flight recorder (last %d of %d events) --"
                      % (len(lines), _recorded), file=sys.stderr,
                      flush=True)
                for ln in lines:
                    print(ln, file=sys.stderr)
        except Exception:
            pass
        try:
            from . import distributed as _dist

            _dist.dump_process()  # nothing without a directory
        except Exception:
            pass
        prev(exc_type, exc, tb)

    hook._flight_hook = True
    sys.excepthook = hook
