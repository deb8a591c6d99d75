"""Distributed observability: trace-context propagation, the per-process
dumper and the job-level merge.

Counterpart of ``paddle_tpu/observability/distributed.py``. A
``TraceContext`` is a ``(trace_id, span_id)`` pair. The HTTP front opens a
``child_span`` per request under the caller's ``X-Trace-Id`` /
``X-Parent-Span`` (or a fresh trace), ``ServingEngine.submit`` captures
the thread's ``current()`` context, and the worker that dispatches the
batch records a ``serving.dispatch`` span under it; the fleet router
sends its request's context on every attempt, so one fleet request is one
trace across the router and the replica that answered.

``inject`` / ``extract`` stamp and read ``trace_id`` / ``parent_span`` on
a JSON header dict; ``job_trace_id`` is the launcher-minted
``PADDLE_TPU_TRACE_ID`` and ``fleet_round_args`` joins a data-parallel
round's span on every rank to it; ``dump_path`` names this process's file
in ``$PADDLE_TPU_METRICS_DIR`` (the ``/healthz`` body reports it).

The per-process dumper (``arm``, armed by a set ``PADDLE_TPU_METRICS_DIR``
when the layer initializes) writes that file every
``PADDLE_TPU_DUMP_PERIOD`` seconds, at exit and on SIGTERM
(``dump_process``: the registry, the span buffer, the flight ring, the
time series), installs the span spool (``observability/spool.py``) beside
it and the flight ring's crash hook (``flight.install_excepthook``).

The job merge (``merge_job_dir``, which the launcher runs at teardown and
the steering daemon every poll) folds a directory of dumps into
``metrics.json`` (each process's metrics under its name, the summed
``counters_total``, the time-series windows, the sampled profiles and
their cross-rank drift) and ``trace.json`` (one chrome trace: spans as
"X" events and flight events as instants, a track a process, on the wall
clock). The clock handshake (``write_clock_ping`` in the child,
``record_clock_offset`` in the launcher) corrects a process whose clock is
off by more than the handshake's own uncertainty.

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
           "set_identity", "process_identity", "job_incarnation",
           "metrics_dir", "dump_path", "job_trace_id", "JOB_TRACE_ENV",
           "fleet_round_args", "dump_process", "arm", "disarm",
           "arm_from_env", "clear_stale_dumps", "load_dumps",
           "load_sampled_profiles", "doc_flight_events",
           "sampled_profile_drift", "merge_job_dir",
           "write_clock_ping", "record_clock_offset",
           "load_clock_offsets", "applied_clock_skew_us",
           "CLOCK_PING_ENV", "MERGED_METRICS_NAME", "MERGED_TRACE_NAME"]

MERGED_METRICS_NAME = "metrics.json"
MERGED_TRACE_NAME = "trace.json"


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


def fleet_round_args(round_no: int) -> Dict:
    """Span args joining one data-parallel round to the job trace: every
    rank stamps ``trace_id`` (the job's) and ``parent_span`` (a round id
    from ``round_no``), so the merged ``trace.json`` shows the ranks' round
    N as one timeline. Empty while the span layer is disarmed or no
    launcher minted a job trace id."""
    if not tracing.active():
        return {}
    tid = job_trace_id()
    if tid is None:
        return {}
    return {"trace_id": tid, "parent_span": "dpround-%d" % int(round_no)}


# -- process identity -------------------------------------------------------------

_identity: Optional[Tuple[str, int]] = None


def set_identity(role: str, rank: int) -> None:
    """Override the env-derived identity (the launcher calls
    ``set_identity("launcher", 0)``: its own env names no role). An armed
    span spool moves to the new name, under which the dump and the merge
    look for it."""
    global _identity
    _identity = (str(role), int(rank))
    sp = tracing.spool()
    if sp is not None:
        base = os.path.splitext(_dump_basename())[0]
        if base != sp.base:
            from .spool import SpanSpool

            tracing._set_spool(SpanSpool.from_env(sp.dirname, base))


def process_identity() -> Tuple[str, int, int]:
    """(role, rank, restart) for dump naming: role from ``PADDLE_ROLE`` /
    ``FT_ROLE``, rank from the role's index variable; a process outside
    any launcher is ``proc-<pid>``."""
    restart = int(os.environ.get("PADDLE_RESTART_COUNT", "0") or 0)
    if _identity is not None:
        return _identity[0], _identity[1], restart
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


_INCARNATION_ENV = "PADDLE_INCARNATION"


def job_incarnation() -> int:
    """The whole-job incarnation of this process (0: the first launch;
    a launcher bumps ``PADDLE_INCARNATION`` on a cold restart)."""
    try:
        return int(os.environ.get(_INCARNATION_ENV, "0") or 0)
    except ValueError:
        return 0


def _dump_basename() -> str:
    role, rank, restart = process_identity()
    base = "%s-%d" % (role, rank)
    if restart:
        base += ".r%d" % restart
    inc = job_incarnation()
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


# -- the clock handshake -----------------------------------------------------------
#
# Rebasing spans and flight events onto ``wall_us`` assumes one wall clock
# for every process: true on one host, not across nodes. The launcher
# pings each child's clock at spawn: the child writes its wall-clock
# reading to a ping file as soon as telemetry arms; the launcher brackets
# the observation between two readings of its own clock (the last poll
# that did not see the file and the one that did) and records
# ``skew_us = child_wall - midpoint``, ``uncertainty_us = window / 2`` in
# ``<proc>.clock.json``. The merge subtracts a skew only where it exceeds
# its uncertainty, so a same-host handshake adds no poll-latency noise to a
# timeline that was already right.

CLOCK_PING_ENV = "PADDLE_TPU_CLOCK_PING"
_CLOCK_SCHEMA = "clock_offset_v1"


def write_clock_ping(path: Optional[str] = None) -> Optional[str]:
    """The child's half: write this process's wall-clock reading to the
    ping file ``$PADDLE_TPU_CLOCK_PING`` names (nothing outside a
    launcher)."""
    if path is None:
        path = os.environ.get(CLOCK_PING_ENV, "").strip()
    if not path:
        return None
    try:
        from ..checkpoint import atomic_write_bytes

        atomic_write_bytes(path, json.dumps(
            {"wall_us": time.time() * 1e6, "pid": os.getpid()}).encode())
        return path
    except Exception:
        return None  # telemetry must not stop the work


def record_clock_offset(dirname: str, proc: str, child_wall_us: float,
                        t0_us: float, t1_us: float) -> Tuple[float, float]:
    """The launcher's half: the child read ``child_wall_us`` at some
    launcher time in ``[t0_us, t1_us]``. The skew against the window's
    midpoint, bounded by the half-window, goes to ``<proc>.clock.json``."""
    skew = float(child_wall_us) - (float(t0_us) + float(t1_us)) / 2.0
    unc = max(0.0, (float(t1_us) - float(t0_us)) / 2.0)
    try:
        from ..checkpoint import atomic_write_bytes

        atomic_write_bytes(
            os.path.join(dirname, "%s.clock.json" % proc),
            json.dumps({"schema": _CLOCK_SCHEMA, "proc": proc,
                        "skew_us": skew, "uncertainty_us": unc,
                        "measured_at": time.time()}).encode())
    except Exception:
        pass
    return skew, unc


def load_clock_offsets(dirname: str) -> Dict[str, Tuple[float, float]]:
    """{proc: (skew_us, uncertainty_us)} from every ``*.clock.json`` in
    ``dirname``."""
    out: Dict[str, Tuple[float, float]] = {}
    if not os.path.isdir(dirname):
        return out
    for fn in sorted(os.listdir(dirname)):
        if not fn.endswith(".clock.json"):
            continue
        try:
            with open(os.path.join(dirname, fn), "r",
                      encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(doc, dict) and doc.get("schema") == _CLOCK_SCHEMA:
            out[doc.get("proc") or fn[:-len(".clock.json")]] = (
                float(doc.get("skew_us") or 0.0),
                float(doc.get("uncertainty_us") or 0.0))
    return out


def applied_clock_skew_us(skew: float, uncertainty: float) -> float:
    """The correction the merge applies: the measured skew where it is
    larger than the handshake's own uncertainty, else 0."""
    return skew if abs(skew) > uncertainty else 0.0


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
            "incarnation": job_incarnation(),
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
        # the child's half of the clock handshake, as early as telemetry
        # exists: the narrower the spawn-to-ping window, the tighter the
        # skew's bound
        write_clock_ping()
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
        flight.install_excepthook()
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
                    or fn.endswith(".clockping") \
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
    """Every readable per-process dump in ``dirname``, by proc name (the
    merge's own outputs and foreign json skipped)."""
    return [d for d in _load_json_files(dirname, ".json", _DUMP_SCHEMA)
            if d["proc"] + ".json" not in (MERGED_METRICS_NAME,
                                           MERGED_TRACE_NAME)]


def load_sampled_profiles(dirname: str) -> Dict[str, Dict]:
    """Every readable sampled-capture report (``<proc>.profile.json``) in
    ``dirname``, by proc name."""
    return {d["proc"]: d for d in _load_json_files(
        dirname, ".profile.json", _SAMPLED_SCHEMA)}


# -- the job merge ------------------------------------------------------------------


def doc_flight_events(doc: Dict):
    """One dump's flight events on the wall clock: ``(t_us, kind,
    fields)``. The one place the event tuple and the rebase rule live:
    ``merge_job_dir`` and ``tools/torch_ft_timeline.py`` both read through
    it."""
    off = float(doc.get("clock_offset_us") or 0.0)
    for ev in doc.get("flight") or []:
        ts, kind, fields = (list(ev) + [None] * 3)[:3]
        yield float(ts) + off, kind, fields or {}


# the per-rank profile numbers whose spread over the ranks the steering
# daemon watches (a straggler shows as step_ms spread)
_DRIFT_METRICS = ("step_ms", "overlap_frac", "critical_path_ms",
                  "exposed_collective_ms", "feed_ms", "optimizer_ms",
                  "host_device_agreement")


def sampled_profile_drift(sampled: Dict[str, Dict]) -> Dict[str, Dict]:
    """Each metric's spread over the ranks' newest sampled reports:
    ``{metric: {per_rank, min, max, spread}}``; phases as
    ``phase_ms.<name>`` rows."""
    series: Dict[str, Dict[str, float]] = {}
    for proc, doc in sampled.items():
        prof = doc.get("profile")
        if not isinstance(prof, dict):
            continue
        for m in _DRIFT_METRICS:
            v = prof.get(m)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                series.setdefault(m, {})[proc] = float(v)
        ph = prof.get("phase_ms")
        if isinstance(ph, dict):
            for name, v in ph.items():
                if isinstance(v, (int, float)):
                    series.setdefault("phase_ms.%s" % name,
                                      {})[proc] = float(v)
    out: Dict[str, Dict] = {}
    for m, per_rank in series.items():
        vals = list(per_rank.values())
        out[m] = {"per_rank": per_rank, "min": min(vals),
                  "max": max(vals), "spread": max(vals) - min(vals)}
    return out


def merge_job_dir(dirname: str) -> Tuple[Optional[str], Optional[str]]:
    """Fold every per-process dump in ``dirname`` into ``metrics.json``
    (each process's metrics under its ``<role>-<rank>`` name and the summed
    ``counters_total``) and ``trace.json`` (one chrome trace: spans as "X"
    events, flight events as instants, a named track a process, all on the
    wall clock). Returns the two paths, or ``(None, None)`` with nothing to
    merge. Only one job incarnation merges: this process's
    (``PADDLE_INCARNATION``), else the newest present.

    A process's spans: its spool (head segments and sampled reservoir, the
    record of a long run) joined with its dump's ring (the exact newest
    window), without duplicates; the ring alone where it never spooled."""
    from ..checkpoint import atomic_write_bytes
    from .spool import load_spooled_spans

    docs = load_dumps(dirname)
    if not docs:
        return None, None
    raw_inc = (os.environ.get(_INCARNATION_ENV) or "").strip()
    try:
        inc = int(raw_inc)
    except ValueError:
        inc = max((int(d.get("incarnation", 0) or 0) for d in docs),
                  default=0)
    docs = [d for d in docs if int(d.get("incarnation", 0) or 0) == inc]
    if not docs:
        return None, None
    clock_offsets = load_clock_offsets(dirname)
    processes: Dict[str, Dict] = {}
    totals: Dict[str, float] = {}
    events: List[Dict] = []
    metas: List[Dict] = []
    per_series: Dict[str, Dict] = {}
    series_skews: Dict[str, float] = {}
    for doc in docs:
        key = doc["proc"]
        raw_skew, skew_unc = clock_offsets.get(key, (0.0, 0.0))
        skew = applied_clock_skew_us(raw_skew, skew_unc)
        spooled = load_spooled_spans(dirname, key)
        ring = doc.get("spans") or []
        if spooled is None:
            spans = ring
        else:
            seen = {json.dumps(ev, sort_keys=True, default=str)
                    for ev in spooled}
            spans = spooled + [
                ev for ev in ring
                if json.dumps(list(ev), sort_keys=True,
                              default=str) not in seen]
        processes[key] = {
            "role": doc.get("role"), "rank": doc.get("rank"),
            "restart": doc.get("restart"),
            "incarnation": int(doc.get("incarnation", 0) or 0),
            "pid": doc.get("pid"),
            "wrote_at": doc.get("wrote_at"),
            "metrics": doc.get("metrics") or {},
            "span_stats": doc.get("span_stats"),
            "span_source": "spool" if spooled is not None else "ring",
            "spool": doc.get("spool"),
            "flight_stats": doc.get("flight_stats"),
            "clock_skew_us": {"measured": raw_skew,
                              "uncertainty": skew_unc,
                              "applied": skew} if (key in clock_offsets)
            else None,
        }
        ser = doc.get("series")
        if isinstance(ser, dict) and ser:
            processes[key]["series"] = ser
            per_series[key] = ser
            series_skews[key] = skew
        for qn, v in (doc.get("metrics") or {}).get("counters",
                                                    {}).items():
            totals[qn] = totals.get(qn, 0) + v
        off = float(doc.get("clock_offset_us") or 0.0) - skew
        pid = int(doc.get("pid") or 0)
        metas.append({"name": "process_name", "ph": "M", "pid": pid,
                      "tid": 0, "args": {"name": key}})
        for ev in spans:
            name, ts, dur, tid, cat, args = (list(ev) + [None] * 6)[:6]
            entry = {"name": name, "ph": "X", "ts": ts + off,
                     "dur": dur, "pid": pid, "tid": tid, "cat": cat}
            if args:
                entry["args"] = args
            events.append(entry)
        for ts, kind, fields in doc_flight_events(doc):
            entry = {"name": kind, "ph": "i", "ts": ts - skew,
                     "pid": pid, "tid": 0, "s": "p", "cat": "flight"}
            if fields:
                entry["args"] = fields
            events.append(entry)
    events.sort(key=lambda e: e["ts"])
    sampled = load_sampled_profiles(dirname)
    for key, sdoc in sampled.items():
        if key in processes:
            processes[key]["sampled_profile"] = sdoc
    merged = {"merged_at": time.time(), "incarnation": inc,
              "processes": processes, "counters_total": totals}
    if per_series:
        # windows aligned over the job: each rank rebased by its applied
        # skew
        merged["series_windows"] = timeseries.job_windows(
            per_series, skews_us=series_skews)
    if sampled:
        merged["sampled_profiles"] = sampled
        merged["sampled_profile_drift"] = sampled_profile_drift(sampled)
    mpath = os.path.join(dirname, MERGED_METRICS_NAME)
    tpath = os.path.join(dirname, MERGED_TRACE_NAME)
    atomic_write_bytes(mpath, json.dumps(
        merged, default=str, sort_keys=True).encode())
    atomic_write_bytes(tpath, json.dumps(
        {"traceEvents": metas + events, "displayTimeUnit": "ms"},
        default=str).encode())
    return mpath, tpath
