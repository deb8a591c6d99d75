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
``$PADDLE_TPU_METRICS_DIR`` (the ``/healthz`` body reports it).

The per-process dumper (``arm``, armed by a set ``PADDLE_TPU_METRICS_DIR``
when the layer initializes) writes that file every
``PADDLE_TPU_DUMP_PERIOD`` seconds, at exit and on SIGTERM
(``dump_process``: the registry, the span buffer, the flight ring, the
time series), and installs the span spool (``observability/spool.py``)
beside it. ``load_dumps`` / ``load_sampled_profiles`` read a directory of
them back. The job-level merge of several processes' dumps stays with the
JAX package (ROADMAP.md).

Every span records only while the span layer is armed
(``observability.enable()``); disarmed, these helpers yield None and cost
one branch.
"""
from __future__ import annotations

import atexit
import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from . import flight, timeseries, tracing

__all__ = ["TraceContext", "current", "set_current", "trace",
           "child_span", "record_span", "inject", "extract",
           "process_identity", "metrics_dir",
           "dump_path", "job_trace_id", "JOB_TRACE_ENV", "dump_process",
           "arm", "disarm", "arm_from_env", "clear_stale_dumps", "load_dumps",
           "load_sampled_profiles"]


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


# -- the per-process dumper ----------------------------------------------

_DUMP_SCHEMA = 1
_SAMPLED_SCHEMA = "sampled_profile_v1"

_arm_lock = threading.Lock()
_arm_state: Dict[str, object] = {}
# dumps against clear_stale_dumps; an RLock, as the SIGTERM handler may
# interrupt the main thread inside a dump
_dump_lock = threading.RLock()


def dump_process(path: Optional[str] = None) -> Optional[str]:
    """Write this process's registry snapshot, span buffer and flight ring
    to ``path`` (default its file in ``$PADDLE_TPU_METRICS_DIR``; None and
    nothing written when neither is known), atomically: a reader never
    sees a torn dump, and the newest write wins. Each dump also flushes
    the span spool and samples the time series."""
    from .. import observability as _obs
    from ..checkpoint import atomic_write_bytes

    with _dump_lock:
        if path is None:
            path = dump_path()
            if path is None:
                return None
        sp = tracing.spool()
        if sp is not None:
            sp.flush()
        role, rank, restart = process_identity()
        doc = {
            "schema": _DUMP_SCHEMA,
            "proc": os.path.splitext(os.path.basename(path))[0],
            "role": role, "rank": rank, "restart": restart,
            "pid": os.getpid(),
            "wrote_at": time.time(),
            # rebases perf_counter-stamped spans and flight events onto
            # the wall clock
            "clock_offset_us": time.time() * 1e6
            - time.perf_counter() * 1e6,
            "metrics": _obs.metrics().snapshot(),
            "spans": [list(ev) for ev in tracing.trace_events()],
            "span_stats": tracing.stats(),
            "flight": [list(ev) for ev in flight.events()],
            "flight_stats": flight.stats(),
        }
        if sp is not None:
            doc["spool"] = sp.stats()
        if timeseries.series_enabled():
            timeseries.record_samples(doc["metrics"],
                                      wall_ts=doc["wrote_at"])
            series = timeseries.process_series()
            if series:
                doc["series"] = series
        atomic_write_bytes(path, json.dumps(doc, default=str).encode())
        return path


def arm(dirname: Optional[str] = None,
        period_s: Optional[float] = None) -> bool:
    """Arm the periodic, at-exit and on-SIGTERM dumper (once a process)
    and, unless ``PADDLE_TPU_SPOOL=0``, the span spool. ``dirname``
    defaults to ``$PADDLE_TPU_METRICS_DIR``, the period to
    ``$PADDLE_TPU_DUMP_PERIOD`` seconds (5). False, and nothing armed,
    without a directory."""
    if dirname is None:
        dirname = metrics_dir()
    if not dirname:
        return False
    with _arm_lock:
        if _arm_state.get("armed"):
            return True
        os.makedirs(dirname, exist_ok=True)
        if os.environ.get("PADDLE_TPU_SPOOL", "").strip().lower() \
                not in ("0", "off", "false", "no"):
            from .spool import SpanSpool

            base = os.path.splitext(_dump_basename())[0]
            tracing._set_spool(SpanSpool.from_env(dirname, base))
        if period_s is None:
            period_s = float(os.environ.get("PADDLE_TPU_DUMP_PERIOD",
                                            "5") or 5)
        stop = threading.Event()

        def _loop():
            while not stop.wait(max(0.05, period_s)):
                try:
                    dump_process()
                except Exception:
                    pass  # a failed periodic dump must not stop the work

        t = threading.Thread(target=_loop, name="obs-dumper", daemon=True)
        t.start()
        atexit.register(_final_dump)
        _install_sigterm_dump()
        _arm_state.update(armed=True, stop=stop, thread=t, dir=dirname,
                          period=period_s)
    return True


def disarm() -> None:
    """Stop the periodic dumper, dump once more and uninstall the span
    spool (the at-exit and SIGTERM hooks stay, writing nothing without a
    directory)."""
    with _arm_lock:
        stop = _arm_state.pop("stop", None)
        thread = _arm_state.pop("thread", None)
        _arm_state.clear()
    if stop is not None:
        stop.set()
        thread.join(timeout=5)
        _final_dump()
    tracing._set_spool(None)


def arm_from_env() -> bool:
    """A set ``PADDLE_TPU_METRICS_DIR`` arms the dumper (the caller arms
    the metrics layer)."""
    return arm()


def _final_dump() -> None:
    try:
        dump_process()
    except Exception:
        pass


def _install_sigterm_dump() -> None:
    """Dump before a SIGTERM ends the process, then the earlier handler;
    skipped off the main thread (``signal.signal`` raises there)."""
    import signal as _signal

    try:
        prev = _signal.getsignal(_signal.SIGTERM)

        def _on_term(signum, frame):
            _final_dump()
            if prev is _signal.SIG_IGN:
                return
            if callable(prev):
                prev(signum, frame)
            else:
                _signal.signal(_signal.SIGTERM, _signal.SIG_DFL)
                os.kill(os.getpid(), _signal.SIGTERM)

        _signal.signal(_signal.SIGTERM, _on_term)
    except (ValueError, OSError):
        pass


def clear_stale_dumps(dirname: str) -> int:
    """Remove the dumps (``*.json``), span segments (``*.jsonl``) and
    temporaries in ``dirname``; never ``job.json``,
    ``__manifest__.json`` or ``oplog.jsonl``, nor a directory. Returns
    how many files went."""
    if not os.path.isdir(dirname):
        return 0
    keep = ("job.json", "__manifest__.json", "oplog.jsonl")
    n = 0
    with _dump_lock:
        for fn in os.listdir(dirname):
            if fn in keep:
                continue
            if fn.endswith(".json") or fn.endswith(".jsonl") \
                    or fn.startswith(".tmp-"):
                try:
                    os.unlink(os.path.join(dirname, fn))
                    n += 1
                except OSError:
                    pass
    return n


def _load_json_files(dirname: str, suffix: str, schema) -> List[Dict]:
    out = []
    if not os.path.isdir(dirname):
        return out
    for fn in sorted(os.listdir(dirname)):
        if not fn.endswith(suffix):
            continue
        try:
            with open(os.path.join(dirname, fn), "r",
                      encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(doc, dict) and doc.get("schema") == schema \
                and "proc" in doc:
            out.append(doc)
    return out


def load_dumps(dirname: str) -> List[Dict]:
    """Every readable per-process dump in ``dirname``, by proc name."""
    return _load_json_files(dirname, ".json", _DUMP_SCHEMA)


def load_sampled_profiles(dirname: str) -> Dict[str, Dict]:
    """Every readable sampled-capture report (``<proc>.profile.json``) in
    ``dirname``, by proc name."""
    return {d["proc"]: d for d in _load_json_files(
        dirname, ".profile.json", _SAMPLED_SCHEMA)}
