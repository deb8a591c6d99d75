"""Trace-context propagation: the part of distributed observability that
serving uses.

Counterpart of ``paddle_tpu/observability/distributed.py:73-343``. A
``TraceContext`` is a ``(trace_id, span_id)`` pair. The HTTP front opens a
``child_span`` per request under the caller's ``X-Trace-Id`` /
``X-Parent-Span`` (or a fresh trace), ``ServingEngine.submit`` captures
the thread's ``current()`` context, and the worker that dispatches the
batch records a ``serving.dispatch`` span under it; the fleet router
sends its request's context on every attempt, so one fleet request is one
trace across the router and the replica that answered.

``inject`` / ``extract`` stamp and read ``trace_id`` / ``parent_span`` on
a JSON header dict; ``job_trace_id`` is the launcher-minted
``PADDLE_TPU_TRACE_ID``; ``dump_path`` names this process's file in
``$PADDLE_TPU_METRICS_DIR`` (the ``/healthz`` body reports it). Writing
that file, the span spool and the job-level merge stay with the JAX
package for now (ROADMAP queue 1 item 11).

Every span records only while the span layer is armed
(``observability.enable()``); disarmed, these helpers yield None and cost
one branch.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Optional, Tuple

from . import tracing

__all__ = ["TraceContext", "current", "set_current", "trace",
           "child_span", "record_span", "inject", "extract",
           "process_identity", "metrics_dir",
           "dump_path", "job_trace_id", "JOB_TRACE_ENV"]


def _gen_id(nhex: int) -> str:
    return os.urandom(nhex // 2).hex()


class TraceContext:
    """One node of a distributed trace: every span created under this
    context records ``trace_id`` and parents to ``span_id``."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = str(trace_id)
        self.span_id = str(span_id)

    @classmethod
    def new(cls, parent: Optional["TraceContext"] = None):
        return cls(parent.trace_id if parent is not None else _gen_id(16),
                   _gen_id(8))

    def __repr__(self):
        return "TraceContext(%s/%s)" % (self.trace_id, self.span_id)


_tls = threading.local()


def current() -> Optional[TraceContext]:
    return getattr(_tls, "ctx", None)


def set_current(ctx: Optional[TraceContext]) -> Optional[TraceContext]:
    """Install ``ctx`` as this thread's context; returns the previous one
    (callers restore it; ``child_span`` does)."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    return prev


def _span_args(ctx: TraceContext, parent_span, args) -> Dict:
    a = {"trace_id": ctx.trace_id, "span_id": ctx.span_id}
    if parent_span:
        a["parent_span"] = str(parent_span)
    a.update(args)
    return a


@contextlib.contextmanager
def trace(name: str, cat: str = "trace", **args):
    """Root span of a new trace, installed as the thread's context: work
    submitted inside it (a serving ``submit``) joins the trace. Yields
    None when the span layer is disarmed."""
    if not tracing.active():
        yield None
        return
    ctx = TraceContext.new()
    prev = set_current(ctx)
    t0 = time.perf_counter()
    try:
        yield ctx
    finally:
        set_current(prev)
        if tracing.active():
            tracing._record(name, t0 * 1e6,
                            (time.perf_counter() - t0) * 1e6, cat,
                            _span_args(ctx, None, args))


@contextlib.contextmanager
def child_span(name: str, cat: str = "rpc",
               trace_id: Optional[str] = None,
               parent_span: Optional[str] = None, **args):
    """Span under a propagated or ambient context. An explicit
    ``trace_id`` / ``parent_span`` (from a request header) wins; otherwise
    the thread's current context parents the span; with neither a fresh
    trace starts. The span is the thread's context for its duration."""
    if not tracing.active():
        yield None
        return
    if trace_id is None:
        amb = current()
        if amb is not None:
            trace_id, parent_span = amb.trace_id, amb.span_id
        else:
            # a parent without its trace id would join an unrelated trace
            trace_id, parent_span = _gen_id(16), None
    ctx = TraceContext(trace_id, _gen_id(8))
    prev = set_current(ctx)
    t0 = time.perf_counter()
    try:
        yield ctx
    finally:
        set_current(prev)
        if tracing.active():
            tracing._record(name, t0 * 1e6,
                            (time.perf_counter() - t0) * 1e6, cat,
                            _span_args(ctx, parent_span, args))


def record_span(name: str, t0_perf: float, cat: str = "rpc",
                ctx: Optional[TraceContext] = None, **args) -> None:
    """A span from ``t0_perf`` (a ``time.perf_counter()`` reading) to now,
    under ``ctx`` or the current context."""
    if not tracing.active():
        return
    if ctx is None:
        ctx = current()
    a = dict(args)
    if ctx is not None:
        a.setdefault("trace_id", ctx.trace_id)
        a.setdefault("parent_span", ctx.span_id)
    tracing._record(name, t0_perf * 1e6,
                    (time.perf_counter() - t0_perf) * 1e6, cat, a or None)


def inject(msg: Dict, ctx: Optional[TraceContext] = None) -> Dict:
    """Stamp ``trace_id`` / ``parent_span`` onto a header dict (mutates
    and returns it); a no-op when disarmed or without a context."""
    if tracing.active():
        if ctx is None:
            ctx = current()
        if ctx is not None:
            msg["trace_id"] = ctx.trace_id
            msg["parent_span"] = ctx.span_id
    return msg


def extract(msg: Dict) -> Tuple[Optional[str], Optional[str]]:
    """(trace_id, parent_span) from a header dict; (None, None) when the
    peer sent none."""
    tid = msg.get("trace_id") if isinstance(msg, dict) else None
    if not tid:
        return None, None
    return str(tid), (str(msg["parent_span"])
                      if msg.get("parent_span") else None)


JOB_TRACE_ENV = "PADDLE_TPU_TRACE_ID"


def job_trace_id() -> Optional[str]:
    """The job trace id a launcher minted into the environment, or None."""
    tid = os.environ.get(JOB_TRACE_ENV, "").strip()
    return tid or None


def process_identity() -> Tuple[str, int, int]:
    """(role, rank, restart) for dump naming: role from ``PADDLE_ROLE`` /
    ``FT_ROLE``, rank from the role's index variable; a process outside
    any launcher is ``proc-<pid>``."""
    restart = int(os.environ.get("PADDLE_RESTART_COUNT", "0") or 0)
    role = os.environ.get("PADDLE_ROLE") or os.environ.get("FT_ROLE")
    if not role:
        return "proc", os.getpid(), restart
    if role == "pserver":
        rank = int(os.environ.get("PADDLE_PSERVER_GLOBAL_INDEX")
                   or os.environ.get("PADDLE_PSERVER_INDEX", "0") or 0)
    elif role == "serving":
        rank = int(os.environ.get("PADDLE_SERVING_REPLICA_INDEX", "0")
                   or 0)
    else:
        rank = int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0)
    return str(role), rank, restart


def _dump_basename() -> str:
    role, rank, restart = process_identity()
    base = "%s-%d" % (role, rank)
    if restart:
        base += ".r%d" % restart
    try:
        inc = int(os.environ.get("PADDLE_INCARNATION", "0") or 0)
    except ValueError:
        inc = 0
    if inc:
        base += ".i%d" % inc
    return base + ".json"


def metrics_dir() -> Optional[str]:
    d = os.environ.get("PADDLE_TPU_METRICS_DIR", "").strip()
    return d or None


def dump_path() -> Optional[str]:
    """This process's file in ``$PADDLE_TPU_METRICS_DIR`` (None when the
    directory is unset)."""
    d = metrics_dir()
    return os.path.join(d, _dump_basename()) if d else None
