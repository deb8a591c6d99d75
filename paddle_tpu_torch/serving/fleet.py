"""Replica-fleet front end: one router over N serving replicas.

Counterpart of ``paddle_tpu/serving/fleet.py``. A ``FleetRouter`` stands
in front of N replicas, each an engine (``ServingEngine`` or
``DecodeEngine``) behind its own HTTP front, and owns what a fleet needs
and one engine cannot have:

- **Shared admission control.** One bounded queue for the whole fleet;
  past ``max_queue`` a submit is rejected with the typed
  ``ServerOverloaded``.

- **Cost-class load shedding with priority lanes.** Every request carries
  a cost class; each class has an admission watermark (a fraction of
  ``max_queue``). As the shared queue fills, the cheapest watermark trips
  first: low-priority requests are shed (typed ``RequestShed``,
  ``serving.shed{class=}``) while high-priority traffic still admits,
  and the dispatch order is a priority heap. Requests past their deadline
  are dropped before any dispatch and fail with ``DeadlineExpired``.

- **Health-checked routing.** A prober polls each replica's ``/healthz``;
  a replica reporting ``draining`` / ``stopped`` leaves rotation at once,
  and one that fails ``eject_after`` probes or dispatches in a row is
  ejected (``serving.replica_ejections{cause=}`` and a
  ``serving.replica_ejected`` flight event). A replica that answers
  ``serving`` again rejoins (``serving.replica_rejoins``,
  ``serving.replica_rejoined``). Routing picks the least-inflight
  routable replica, round-robin on ties; the probe learns each replica's
  ``engine_kind`` and KV occupancy.

- **Bounded hedged retries, exactly once.** An attempt that fails is
  re-dispatched to another replica with the remaining deadline, never the
  original one; an attempt that straggles past ``hedge_after_ms`` gets a
  racing hedge on a second replica (``serving.hedges``, at most
  ``max_hedges``). Every request has an idempotent request id (replica
  engines dedup duplicate deliveries against it), a per-request latch
  surfaces the first completion and discards the loser
  (``serving.hedge_wasted``), and the loser's socket is closed.

- **Token-level stream failover.** ``generate()`` proxies a decode
  replica's chunked ``/generate`` stream; when the replica dies
  mid-stream the router resumes on a survivor with ``resume_from`` set to
  the next undelivered index and drops anything already yielded, so the
  caller sees every token index once, in order, with no gap
  (``serving.stream_resumes`` and ``serving.stream_resume`` flight
  events). Streams are priced in cost units scaled by ``max_tokens``
  (``FleetConfig.cost_unit_tokens``), so a long low-priority stream sheds
  before a short high-priority one.

The router speaks plain HTTP/1.1 to the replicas over raw sockets and
routes every frame through ``distributed.fault.get_injector()``, so a
test or a drill can drop, delay or sever fleet RPCs deterministically.
Every attempt sends ``X-Trace-Id`` / ``X-Parent-Span`` under the
submitter's trace context (or the launcher's job trace id).

``FleetRouter`` has the ``predict`` / ``health`` / ``stats`` surface of
``ServingEngine`` (and ``generate`` of ``DecodeEngine``), so
``serving.start_http_server(router)`` puts an HTTP front on the fleet.
"""
from __future__ import annotations

import heapq
import itertools
import json
import socket
import threading
import time
import uuid
from collections import OrderedDict
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..distributed import fault as _fault
from ..observability import distributed as _dtrace
from ..observability import flight as _flight
from . import metrics as _m
from .engine import (DeadlineExpired, EngineStopped, ServerOverloaded,
                     ServingError)

__all__ = ["FleetConfig", "FleetRouter", "Replica", "RequestShed",
           "ReplicaUnavailable", "DEFAULT_COST_CLASSES"]


class RequestShed(ServerOverloaded):
    """Load shedding by cost class: the shared queue crossed THIS
    class's admission watermark. A cheaper/higher-priority class may
    still be admitted right now — retry later or downgrade the work,
    don't hammer the same lane."""


class ReplicaUnavailable(ServingError):
    """Every dispatch attempt failed and the retry budget (or the
    deadline) is exhausted — no replica produced a result."""


# priority lanes, highest first. The float is the class's admission
# watermark as a fraction of max_queue: class requests are SHED once
# queue depth reaches it. "high" admits up to the hard bound (only
# ServerOverloaded proper rejects it); cheaper lanes trip earlier, so
# under overload the low-priority shed rate is strictly above the
# high-priority one.
DEFAULT_COST_CLASSES: Tuple[Tuple[str, float], ...] = (
    ("high", 1.0), ("normal", 0.75), ("low", 0.5))


class FleetConfig:
    """Router knobs.

    ``cost_classes`` — ordered (name, admit_frac) pairs, highest
    priority first; ``admit_frac * max_queue`` is the queue depth — in
    COST UNITS — at which that class starts shedding.
    ``hedge_after_ms=None`` disables straggler hedging (failure
    retries still run). ``request_timeout_s`` bounds a request WITHOUT
    an explicit deadline. ``eject_after`` is consecutive
    probe/dispatch failures before a replica leaves rotation; with
    ``health_interval_ms`` it bounds how long a dead replica can keep
    eating traffic.

    Cost units price admission by EXPECTED WORK, not request count: a
    one-shot predict is 1 unit, a decode stream is
    ``ceil(max_tokens / cost_unit_tokens)`` units
    (``default_stream_tokens`` when the caller names no budget) — so
    one 512-token stream weighs what 32 one-shot requests weigh, and
    under pressure a long low-priority stream sheds BEFORE a short
    high-priority one rather than both being "one request"."""

    def __init__(self,
                 max_queue: int = 128,
                 num_dispatchers: int = 8,
                 cost_classes: Optional[Sequence[Tuple[str, float]]] = None,
                 default_class: Optional[str] = None,
                 default_deadline_ms: Optional[float] = None,
                 request_timeout_s: float = 30.0,
                 max_attempts: int = 3,
                 hedge_after_ms: Optional[float] = 200.0,
                 max_hedges: int = 1,
                 health_interval_ms: float = 100.0,
                 eject_after: int = 2,
                 connect_timeout_s: float = 2.0,
                 backoff_ms: float = 25.0,
                 cost_unit_tokens: int = 16,
                 default_stream_tokens: int = 16,
                 stream_stall_s: float = 5.0):
        self.max_queue = int(max_queue)
        if self.max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        self.num_dispatchers = int(num_dispatchers)
        if self.num_dispatchers < 1:
            raise ValueError("num_dispatchers must be >= 1")
        classes = list(cost_classes if cost_classes is not None
                       else DEFAULT_COST_CLASSES)
        if not classes:
            raise ValueError("need at least one cost class")
        self.cost_classes: List[Tuple[str, float]] = []
        seen = set()
        for name, frac in classes:
            name = str(name)
            frac = float(frac)
            if name in seen:
                raise ValueError("duplicate cost class %r" % name)
            if not 0.0 < frac <= 1.0:
                raise ValueError(
                    "admit fraction for %r must be in (0, 1], got %g"
                    % (name, frac))
            seen.add(name)
            self.cost_classes.append((name, frac))
        self.default_class = (str(default_class) if default_class
                              else self.cost_classes[0][0])
        if self.default_class not in seen:
            raise ValueError("default_class %r not among cost classes %s"
                             % (self.default_class, sorted(seen)))
        self.default_deadline_ms = default_deadline_ms
        self.request_timeout_s = float(request_timeout_s)
        self.max_attempts = max(1, int(max_attempts))
        self.hedge_after_ms = (None if hedge_after_ms is None
                               else float(hedge_after_ms))
        self.max_hedges = max(0, int(max_hedges))
        self.health_interval_ms = float(health_interval_ms)
        self.eject_after = max(1, int(eject_after))
        self.connect_timeout_s = float(connect_timeout_s)
        self.backoff_ms = float(backoff_ms)
        self.cost_unit_tokens = max(1, int(cost_unit_tokens))
        self.default_stream_tokens = max(1, int(default_stream_tokens))
        # the streaming analogue of hedging: a stream attempt that
        # goes THIS long with no bytes (no token, no finish) is
        # declared stalled and failed over — without it a replica that
        # accepts the connection and then wedges burns the caller's
        # whole deadline on one attempt
        self.stream_stall_s = float(stream_stall_s)

    def stream_units(self, max_tokens: Optional[int]) -> int:
        """Admission weight of a decode stream: its expected decode
        cost in one-shot-request equivalents."""
        toks = (int(max_tokens) if max_tokens is not None
                else self.default_stream_tokens)
        return max(1, -(-toks // self.cost_unit_tokens))

    def class_rank(self, name: str) -> int:
        for i, (n, _) in enumerate(self.cost_classes):
            if n == name:
                return i
        raise ValueError("unknown cost class %r (have %s)"
                         % (name, [n for n, _ in self.cost_classes]))

    def admit_depth(self, name: str) -> int:
        """Queue depth at which ``name`` starts shedding."""
        for n, frac in self.cost_classes:
            if n == name:
                return max(1, int(round(frac * self.max_queue)))
        raise ValueError("unknown cost class %r" % name)


# -- replica state -----------------------------------------------------------

class Replica:
    """One replica endpoint and everything the router knows about it.
    ``state`` is the last OBSERVED lifecycle ("unknown" until the first
    probe — optimistically routable so a fresh fleet doesn't stall on
    its first health interval)."""

    ROUTABLE = ("serving", "unknown")

    def __init__(self, endpoint: str):
        self.endpoint = str(endpoint)
        self.state = "unknown"
        self.failures = 0          # consecutive probe/dispatch failures
        self.inflight = 0
        self.served = 0            # results actually surfaced from here
        self.ejections = 0
        self.was_ejected = False   # a rejoin is only a rejoin after one
        self.kind = "unknown"      # healthz engine_kind: oneshot|decode
        self.kv_occupancy: Optional[float] = None

    @property
    def routable(self) -> bool:
        return self.state in self.ROUTABLE

    def snapshot(self) -> Dict:
        return {"endpoint": self.endpoint, "state": self.state,
                "failures": self.failures, "inflight": self.inflight,
                "served": self.served, "ejections": self.ejections,
                "kind": self.kind, "kv_occupancy": self.kv_occupancy}


class _FleetRequest:
    """One admitted request: payload, lane, deadline, the exactly-once
    completion latch, and the live-attempt bookkeeping the dispatcher's
    hedge/retry loop runs on."""

    __slots__ = ("inputs", "cost_class", "rank", "deadline", "rid",
                 "future", "t_enqueue", "trace_ctx", "cond", "done",
                 "live", "last_launch", "last_error", "attempt_socks",
                 "tried", "units")

    def __init__(self, inputs, cost_class, rank, deadline, rid,
                 trace_ctx, units=1):
        self.inputs = inputs          # {name: nested list} (json-ready)
        self.cost_class = cost_class
        self.rank = rank
        self.deadline = deadline      # monotonic ts or None
        self.rid = rid
        self.future: Future = Future()
        self.t_enqueue = time.monotonic()
        self.trace_ctx = trace_ctx
        self.cond = threading.Condition()
        self.done = False
        self.live = 0                 # attempts in flight
        self.last_launch = 0.0
        self.last_error: Optional[BaseException] = None
        self.attempt_socks: List[socket.socket] = []
        self.tried: set = set()       # endpoints with a LIVE attempt
        self.units = int(units)       # admission cost units held


class _FleetStream:
    """Iterator over a fleet decode stream. Exists so the admission
    cost units release EXACTLY once on every exit path — exhaustion,
    ``close()``/``cancel()``, caller error, or a stream that is never
    iterated at all (a bare generator's ``finally`` never runs if its
    body never starts). ``cancel`` is the duck-typed hook the HTTP
    front calls when the downstream client disconnects."""

    __slots__ = ("_gen", "_release")

    def __init__(self, gen, release):
        self._gen = gen
        self._release = release

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self._gen)
        except BaseException:
            # StopIteration included: the stream is over either way
            self._release()
            raise

    def close(self) -> None:
        self._gen.close()
        self._release()

    def cancel(self) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except (RuntimeError, AttributeError):
            # finalizer during interpreter teardown: the generator may
            # be mid-run (RuntimeError) or the module half-cleared
            # (AttributeError) — neither may raise out of __del__
            pass


# -- minimal fault-injectable HTTP client ------------------------------------

class _Transport(OSError):
    """A fleet RPC attempt died in transit (connect/send/recv failure,
    injected fault, replica-side 503). Retryable on another replica."""


def _http_call(endpoint: str, method: str, path: str,
               body: Optional[bytes], timeout_s: float,
               connect_timeout_s: float,
               headers: Sequence[Tuple[str, str]] = (),
               sock_sink=None) -> Tuple[int, bytes]:
    """One HTTP/1.1 exchange over a raw socket, every frame routed
    through the process fault injector (the drillable fleet RPC path).
    Returns (status, body). ``sock_sink(sock)`` exposes the live socket
    to the caller for hedged-loser cancellation."""
    host, _, port = endpoint.rpartition(":")
    try:
        sock = socket.create_connection((host or "127.0.0.1", int(port)),
                                        timeout=connect_timeout_s)
    except OSError as e:
        raise _Transport("connect %s: %s" % (endpoint, e)) from e
    try:
        sock.settimeout(max(0.05, timeout_s))
        if sock_sink is not None:
            sock_sink(sock)
        lines = ["%s %s HTTP/1.1" % (method, path),
                 "Host: %s" % endpoint,
                 "Connection: close",
                 "Content-Length: %d" % (len(body) if body else 0),
                 "Content-Type: application/json"]
        for k, v in headers:
            lines.append("%s: %s" % (k, v))
        frame = ("\r\n".join(lines) + "\r\n\r\n").encode() + (body or b"")
        inj = _fault.get_injector()
        try:
            if inj is not None:
                if not inj.on_send(sock, frame):
                    # injected send-drop: the replica never sees the
                    # request; the peer's silence surfaces as a recv
                    # timeout below, exactly like a real lost frame
                    pass
            else:
                sock.sendall(frame)
            if inj is not None:
                verdict = inj.on_recv(sock)
                if verdict == "drop":
                    # injected recv-drop: the reply dies on the wire —
                    # surface a silence-shaped failure so the retry
                    # path engages exactly as for a real lost response
                    raise socket.timeout("injected: response dropped")
            return _read_http_response(sock)
        except _fault.FaultInjected as e:
            raise _Transport("injected: %s" % e) from e
        except (socket.timeout, OSError, ValueError) as e:
            raise _Transport("%s %s: %s: %s"
                             % (method, endpoint, type(e).__name__,
                                e)) from e
    finally:
        try:
            sock.close()
        except OSError:
            pass


def _read_http_response(sock: socket.socket) -> Tuple[int, bytes]:
    buf = b""
    while b"\r\n\r\n" not in buf:
        chunk = sock.recv(65536)
        if not chunk:
            raise ValueError("EOF before response headers")
        buf += chunk
        if len(buf) > 1 << 20:
            raise ValueError("oversized response headers")
    head, _, rest = buf.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    parts = lines[0].split(None, 2)
    if len(parts) < 2 or not parts[1].isdigit():
        raise ValueError("bad status line %r" % lines[0])
    status = int(parts[1])
    clen = None
    for ln in lines[1:]:
        k, _, v = ln.partition(":")
        if k.strip().lower() == "content-length":
            clen = int(v.strip())
    if clen is None:
        # Connection: close — read to EOF
        while True:
            chunk = sock.recv(65536)
            if not chunk:
                break
            rest += chunk
        return status, rest
    while len(rest) < clen:
        chunk = sock.recv(65536)
        if not chunk:
            raise ValueError("EOF mid-body (%d/%d bytes)"
                             % (len(rest), clen))
        rest += chunk
    return status, rest[:clen]


class _StreamHTTP(Exception):
    """A /generate attempt got a complete NON-200 reply: the replica is
    alive and said no. Carries status + error body so the caller can
    route (503 retry elsewhere, 4xx/5xx surface typed)."""

    def __init__(self, status: int, raw: bytes):
        super().__init__("HTTP %d: %s" % (status, _err_of(raw)))
        self.status = int(status)
        self.raw = raw


def _http_stream(endpoint: str, method: str, path: str,
                 body: Optional[bytes], timeout_s: float,
                 connect_timeout_s: float,
                 headers: Sequence[Tuple[str, str]] = (),
                 sock_sink=None,
                 stall_timeout_s: Optional[float] = None):
    """One chunked-transfer HTTP/1.1 exchange: generator yielding each
    ndjson event object as its bytes arrive, so tokens surface with
    decode-step latency instead of stream-end latency. Same raw-socket
    + fault-injector discipline as ``_http_call`` (a drill
    kills replicas mid-chunk and this path must die honestly: any
    transport failure — EOF mid-chunk, reset, timeout, injected drop —
    raises ``_Transport`` so the router can fail over and resume)."""
    host, _, port = endpoint.rpartition(":")
    try:
        sock = socket.create_connection((host or "127.0.0.1", int(port)),
                                        timeout=connect_timeout_s)
    except OSError as e:
        raise _Transport("connect %s: %s" % (endpoint, e)) from e
    try:
        # the socket timeout bounds each recv(), i.e. the silence
        # BETWEEN events — the overall deadline is the caller's loop
        sock.settimeout(max(0.05, min(timeout_s, stall_timeout_s)
                            if stall_timeout_s is not None
                            else timeout_s))
        if sock_sink is not None:
            sock_sink(sock)
        lines = ["%s %s HTTP/1.1" % (method, path),
                 "Host: %s" % endpoint,
                 "Connection: close",
                 "Content-Length: %d" % (len(body) if body else 0),
                 "Content-Type: application/json"]
        for k, v in headers:
            lines.append("%s: %s" % (k, v))
        frame = ("\r\n".join(lines) + "\r\n\r\n").encode() + (body or b"")
        inj = _fault.get_injector()
        try:
            if inj is not None:
                if not inj.on_send(sock, frame):
                    pass  # injected send-drop -> recv timeout below
            else:
                sock.sendall(frame)
            if inj is not None and inj.on_recv(sock) == "drop":
                raise socket.timeout("injected: response dropped")
            buf = b""
            while b"\r\n\r\n" not in buf:
                chunk = sock.recv(65536)
                if not chunk:
                    raise ValueError("EOF before response headers")
                buf += chunk
                if len(buf) > 1 << 20:
                    raise ValueError("oversized response headers")
            head, _, buf = buf.partition(b"\r\n\r\n")
            hlines = head.decode("latin-1").split("\r\n")
            parts = hlines[0].split(None, 2)
            if len(parts) < 2 or not parts[1].isdigit():
                raise ValueError("bad status line %r" % hlines[0])
            status = int(parts[1])
            hdrs = {}
            for ln in hlines[1:]:
                k, _, v = ln.partition(":")
                hdrs[k.strip().lower()] = v.strip()
            if status != 200:
                # complete (small) error doc, then the typed refusal
                clen = int(hdrs.get("content-length") or 0)
                while len(buf) < clen:
                    chunk = sock.recv(65536)
                    if not chunk:
                        break
                    buf += chunk
                raise _StreamHTTP(status, buf[:clen])
            if hdrs.get("transfer-encoding", "").lower() != "chunked":
                raise ValueError("stream reply is not chunked")
            pending = b""  # decoded bytes not yet forming a full line
            while True:
                while b"\r\n" not in buf:
                    chunk = sock.recv(65536)
                    if not chunk:
                        raise ValueError("EOF mid-chunk header")
                    buf += chunk
                size_line, _, buf = buf.partition(b"\r\n")
                size = int(size_line.strip().split(b";")[0] or b"0", 16)
                if size == 0:
                    return  # terminal chunk — clean stream end
                while len(buf) < size + 2:  # data + trailing CRLF
                    chunk = sock.recv(65536)
                    if not chunk:
                        raise ValueError("EOF mid-chunk (%d/%d bytes)"
                                         % (len(buf), size))
                    buf += chunk
                pending += buf[:size]
                buf = buf[size + 2:]
                while b"\n" in pending:
                    line, _, pending = pending.partition(b"\n")
                    if line.strip():
                        yield json.loads(line.decode())
        except _StreamHTTP:
            raise
        except _fault.FaultInjected as e:
            raise _Transport("injected: %s" % e) from e
        except (socket.timeout, OSError, ValueError) as e:
            # json.JSONDecodeError is a ValueError: a half-written line
            # from a dying replica is a transport failure, not a
            # protocol error
            raise _Transport("%s %s: %s: %s"
                             % (method, endpoint, type(e).__name__,
                                e)) from e
    finally:
        try:
            sock.close()
        except OSError:
            pass


# -- the router --------------------------------------------------------------

class FleetRouter:
    """The fleet front end. Construct over the replica endpoints, then
    ``start()``; ``submit``/``predict`` mirror ``ServingEngine`` (plus
    ``cost_class``), so the HTTP front (``serving.start_http_server``)
    works on a fleet unchanged."""

    def __init__(self, endpoints: Sequence[str],
                 config: Optional[FleetConfig] = None):
        eps = [str(e).strip() for e in endpoints if str(e).strip()]
        if not eps:
            raise ValueError("FleetRouter needs at least one endpoint")
        self.config = config or FleetConfig()
        self.replicas = [Replica(e) for e in eps]
        self._rep_lock = threading.Lock()
        self._rr = itertools.count()
        self._heap: List[Tuple[int, int, _FleetRequest]] = []
        self._seq = itertools.count()
        self._cond = threading.Condition()
        # admission depth in COST UNITS (see FleetConfig): queued
        # one-shot requests + live decode streams, both under _cond
        self._queued_units = 0
        self._stream_units = 0
        # request-id -> Future, LRU-bounded (same contract as the
        # engine's cache: completed ids stay joinable until evicted)
        self._ids: "OrderedDict[str, Future]" = OrderedDict()
        self._ids_lock = threading.Lock()
        self._dispatchers: List[threading.Thread] = []
        self._health_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._started = False
        self._stopped = False

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "FleetRouter":
        if self._stopped:
            raise EngineStopped("fleet router cannot be restarted")
        if self._started:
            return self
        self._started = True
        for i in range(self.config.num_dispatchers):
            t = threading.Thread(target=self._dispatch_loop,
                                 name="fleet-dispatch-%d" % i,
                                 daemon=True)
            t.start()
            self._dispatchers.append(t)
        self._health_thread = threading.Thread(
            target=self._health_loop, name="fleet-health", daemon=True)
        self._health_thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        """Refuse new submits, fail everything still queued (typed),
        join the dispatchers."""
        if self._stopped:
            return
        self._stopped = True
        self._stop.set()
        with self._cond:
            leftovers = [req for _, _, req in self._heap]
            self._heap = []
            self._queued_units = 0
            self._cond.notify_all()
        for req in leftovers:
            self._finish_error(req, EngineStopped("fleet stopped"))
        end = time.monotonic() + timeout
        for t in self._dispatchers:
            t.join(max(0.0, end - time.monotonic()))
        if self._health_thread is not None:
            self._health_thread.join(max(0.0, end - time.monotonic()))

    def __enter__(self) -> "FleetRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def health(self) -> str:
        if self._stopped:
            return "stopped"
        if not self._started:
            return "starting"
        return "serving"

    @property
    def running(self) -> bool:
        return self._started and not self._stopped

    def stats(self) -> Dict:
        out = _m.snapshot()
        with self._cond:
            out["queue_depth"] = len(self._heap)
            out["queue_units"] = self._queued_units + self._stream_units
        out["running"] = self.running
        out["state"] = self.health()
        with self._rep_lock:
            out["replicas"] = [r.snapshot() for r in self.replicas]
        return out

    def healthy_count(self) -> int:
        """Replicas the prober has actually SEEN serving. Stricter than
        routable (which optimistically includes never-probed replicas so
        a fresh fleet doesn't stall): this is the "wait until the fleet
        is up" primitive, and an unprobed replica isn't up yet."""
        with self._rep_lock:
            return sum(1 for r in self.replicas if r.state == "serving")

    # -- request path --------------------------------------------------------

    def submit(self, feed: Dict[str, np.ndarray],
               deadline_ms: Optional[float] = None,
               request_id: Optional[str] = None,
               cost_class: Optional[str] = None) -> Future:
        """Admit one request into the fleet queue. Typed failures:
        ``ServerOverloaded`` (hard queue bound), ``RequestShed`` (this
        class's watermark tripped), ``EngineStopped``. The returned
        future resolves to the winning replica's outputs (name ->
        ndarray) or the typed error. Duplicate ``request_id`` submits
        join the original future (idempotent, like the engine)."""
        if not self.running:
            raise EngineStopped("fleet router is not accepting requests")
        cls = cost_class or self.config.default_class
        rank = self.config.class_rank(cls)  # raises on unknown class
        if not isinstance(feed, dict) or not feed:
            raise ValueError("feed must be a non-empty dict name -> array")
        if request_id is not None:
            with self._ids_lock:
                f = self._ids.get(str(request_id))
                if f is not None:
                    self._ids.move_to_end(str(request_id))
            if f is not None:
                _m.inc(_m.DEDUP_HITS)
                return f
        if deadline_ms is None:
            deadline_ms = self.config.default_deadline_ms
        deadline = (time.monotonic() + float(deadline_ms) / 1e3
                    if deadline_ms is not None else None)
        inputs = {str(n): np.asarray(v).tolist() for n, v in feed.items()}
        rid = str(request_id) if request_id is not None else uuid.uuid4().hex
        ctx = _dtrace.current()
        if ctx is None and _dtrace.job_trace_id() is not None:
            # under a launcher every fleet request joins the ONE job
            # trace, so per-replica serving spans merge into a single
            # cross-process timeline
            ctx = _dtrace.TraceContext(_dtrace.job_trace_id(),
                                       "fleetreq-" + rid[:12])
        req = _FleetRequest(inputs, cls, rank, deadline, rid, ctx)
        if request_id is not None:
            # register BEFORE admission, re-checking under the lock:
            # two concurrent duplicates race here, and the loser must
            # join the winner's future, never enqueue a second copy
            with self._ids_lock:
                f = self._ids.get(rid)
                if f is not None:
                    self._ids.move_to_end(rid)
                    _m.inc(_m.DEDUP_HITS)
                    return f
                self._ids[rid] = req.future
                while len(self._ids) > 4096:
                    self._ids.popitem(last=False)
        try:
            with self._cond:
                # depth is measured in COST UNITS: a queued decode
                # stream holding 32 units pressures the watermarks as
                # hard as 32 queued one-shot requests would
                depth = self._queued_units + self._stream_units
                admit = self.config.admit_depth(cls)
                if depth + req.units - 1 >= admit:
                    # the class's watermark tripped. For the TOP lane
                    # the watermark IS the hard bound
                    # (ServerOverloaded); any cheaper lane is SHED —
                    # typed per class, even when the queue is also
                    # full, so shed accounting reads "this class was
                    # turned away under overload"
                    if admit >= self.config.max_queue:
                        _m.inc(_m.REJECTED)
                        raise ServerOverloaded(
                            "fleet queue full (%d requests); retry "
                            "later" % self.config.max_queue)
                    _m.inc(_m.SHED, **{"class": cls})
                    raise RequestShed(
                        "queue depth %d at/over class %r watermark %d "
                        "— shed; retry later or use a higher-priority "
                        "class" % (depth, cls, admit))
                heapq.heappush(self._heap, (rank, next(self._seq), req))
                self._queued_units += req.units
                _m.inc(_m.REQUESTS)
                self._set_depth(len(self._heap))
                self._cond.notify()
        except ServerOverloaded as exc:
            if request_id is not None:
                # a concurrent duplicate may already hold this future:
                # resolve it with the same rejection so the holder is
                # never left waiting on a request that was never
                # admitted, then forget the id (a RETRY of it is a
                # fresh admission attempt, not a join of the failure)
                with self._ids_lock:
                    self._ids.pop(rid, None)
                try:
                    req.future.set_exception(exc)
                except Exception:
                    pass
            raise
        return req.future

    def predict(self, feed: Dict[str, np.ndarray],
                deadline_ms: Optional[float] = None,
                timeout: Optional[float] = None,
                request_id: Optional[str] = None,
                cost_class: Optional[str] = None) -> Dict[str, np.ndarray]:
        """Blocking submit().result() convenience."""
        return self.submit(feed, deadline_ms, request_id=request_id,
                           cost_class=cost_class).result(timeout)

    # -- streaming decode across the fleet -----------------------------------

    def generate(self, prompt, *, max_tokens: Optional[int] = None,
                 request_id: Optional[str] = None,
                 cost_class: Optional[str] = None,
                 deadline_s: Optional[float] = None,
                 resume_from: int = 0):
        """Stream one decode request through the fleet: pick a decode
        replica, proxy its ``/generate`` chunked stream, and on replica
        death RESUME on a survivor from the next undelivered token.
        The ``(request_id, token_index)`` contract makes failover
        exactly-once at the token level: each index is yielded at most
        once, in order, with no gaps, however many replicas die
        mid-stream (the survivor regenerates deterministically and the
        router suppresses anything already delivered).

        Admission is cost-priced: the stream holds
        ``ceil(max_tokens / cost_unit_tokens)`` queue units for its
        lifetime, so a long low-priority stream trips its shed
        watermark before a short high-priority one. Pre-stream
        failures are typed like ``submit`` (``RequestShed`` /
        ``ServerOverloaded`` / ``EngineStopped`` / ``ValueError``);
        once streaming, terminal failures arrive in-band as a finish
        event (reason ``deadline_expired`` / ``replica_unavailable`` /
        ``error``) — the engine's own contract, since the HTTP front
        cannot retract a 200 mid-stream."""
        if not self.running:
            raise EngineStopped("fleet router is not accepting requests")
        cls = cost_class or self.config.default_class
        self.config.class_rank(cls)  # raises on unknown class
        if not isinstance(prompt, (list, tuple)) or not prompt:
            raise ValueError("prompt must be a non-empty token list")
        prompt = [int(t) for t in prompt]
        if max_tokens is not None:
            max_tokens = int(max_tokens)
            if max_tokens < 1:
                raise ValueError("max_tokens must be >= 1")
        units = self.config.stream_units(max_tokens)
        admit = self.config.admit_depth(cls)
        with self._cond:
            depth = self._queued_units + self._stream_units
            if depth + units - 1 >= admit:
                if admit >= self.config.max_queue:
                    _m.inc(_m.REJECTED)
                    raise ServerOverloaded(
                        "fleet queue full (%d + %d units over %d); "
                        "retry later"
                        % (depth, units, self.config.max_queue))
                _m.inc(_m.SHED, **{"class": cls})
                raise RequestShed(
                    "stream of %d cost unit(s) at depth %d would cross "
                    "class %r watermark %d — shed; retry later, lower "
                    "max_tokens, or use a higher-priority class"
                    % (units, depth, cls, admit))
            self._stream_units += units
        rid = (str(request_id) if request_id is not None
               else uuid.uuid4().hex)
        deadline = time.monotonic() + (
            float(deadline_s) if deadline_s is not None
            else self.config.request_timeout_s)
        _m.inc(_m.STREAMS)
        released = []

        def release():
            # exactly-once: both the generator's finally and the
            # wrapper call this; a stream the caller never iterates
            # (generator body never entered) still releases on close
            if released:
                return
            released.append(True)
            with self._cond:
                self._stream_units = max(0, self._stream_units - units)

        return _FleetStream(
            self._generate_stream(prompt, max_tokens, rid, cls,
                                  deadline, int(resume_from), release),
            release)

    def _generate_stream(self, prompt, max_tokens, rid, cls, deadline,
                         resume_from, release):
        """The post-admission attempt loop (a generator: admission
        already happened eagerly in ``generate`` so callers get typed
        refusals at call time, not at first ``next()``)."""
        cfg = self.config
        next_index = int(resume_from)  # next token index owed caller
        emitted = 0
        failures = 0          # consecutive attempts with NO progress
        tried: set = set()    # endpoints failed since last progress
        last_error: Optional[BaseException] = None
        try:
            while True:
                rem = deadline - time.monotonic()
                if rem <= 0:
                    _m.inc(_m.DEADLINE_EXPIRED)
                    yield {"type": "finish",
                           "reason": "deadline_expired",
                           "error": "stream deadline expired after %d "
                                    "delivered token(s)" % emitted,
                           "tokens": emitted}
                    return
                if failures >= cfg.max_attempts:
                    _m.inc(_m.STREAM_ERRORS)
                    yield {"type": "finish",
                           "reason": "replica_unavailable",
                           "error": "no replica could continue the "
                                    "stream after %d attempt(s)%s"
                                    % (failures,
                                       (": last error %s" % last_error)
                                       if last_error else ""),
                           "tokens": emitted}
                    return
                rep = self._pick(exclude=tried, kind="decode")
                if rep is None:
                    # nothing routable right now: bounded nap — a
                    # relaunching replica may rejoin within deadline
                    failures += 1
                    time.sleep(max(0.0, min(cfg.backoff_ms / 1e3, rem)))
                    continue
                if failures > 0 or next_index > int(resume_from):
                    _m.inc(_m.FLEET_RETRIES)
                if next_index > int(resume_from):
                    # a true mid-stream failover: the stream resumes
                    # token-exact on another replica
                    _m.inc(_m.STREAM_RESUMES)
                    _flight.record("serving.stream_resume",
                                   rid=rid[:12], endpoint=rep.endpoint,
                                   from_index=next_index)
                body = json.dumps({"prompt": prompt,
                                   "max_tokens": max_tokens,
                                   "cost_class": cls,
                                   "deadline_ms": rem * 1e3,
                                   "resume_from": next_index}).encode()
                with self._rep_lock:
                    rep.inflight += 1
                try:
                    for ev in _http_stream(
                            rep.endpoint, "POST", "/generate", body,
                            timeout_s=rem,
                            connect_timeout_s=min(cfg.connect_timeout_s,
                                                  max(rem, 0.05)),
                            headers=[("X-Request-Id", rid)],
                            stall_timeout_s=cfg.stream_stall_s):
                        kind = ev.get("type")
                        if kind == "token":
                            idx = int(ev.get("index", -1))
                            if idx < next_index:
                                continue  # replayed duplicate — drop
                            if idx > next_index:
                                # a hole means the replica's replay
                                # contract broke; treat as transport
                                # and resume cleanly elsewhere
                                raise _Transport(
                                    "token index gap from %s: got %d, "
                                    "expected %d"
                                    % (rep.endpoint, idx, next_index))
                            next_index += 1
                            emitted += 1
                            failures = 0
                            tried = set()
                            yield ev
                        elif kind == "finish":
                            reason = str(ev.get("reason") or "")
                            if reason in ("engine_stopped", "cancelled"):
                                # the REPLICA is going away (drain /
                                # replica-local cancel), not our
                                # caller: fail over and resume
                                raise _Transport(
                                    "replica %s ended stream early: %s"
                                    % (rep.endpoint, reason))
                            if reason == "deadline_expired":
                                _m.inc(_m.DEADLINE_EXPIRED)
                            with self._rep_lock:
                                rep.served += 1
                            yield ev
                            return
                        else:
                            yield ev  # forward-compat passthrough
                    raise _Transport(
                        "stream from %s ended without a finish event"
                        % rep.endpoint)
                except _StreamHTTP as e:
                    last_error = e
                    if e.status == 503:
                        # alive-but-refusing (overload/drain): proof of
                        # life, never an ejection signal
                        with self._rep_lock:
                            rep.failures = 0
                        tried.add(rep.endpoint)
                        failures += 1
                    elif e.status == 501:
                        # a one-shot replica in a mixed fleet: remember
                        # its kind so streams stop landing on it
                        with self._rep_lock:
                            rep.kind = "oneshot"
                        tried.add(rep.endpoint)
                        failures += 1
                    else:
                        # 4xx/5xx: deterministic — a retry would fail
                        # identically; surface in-band
                        _m.inc(_m.STREAM_ERRORS)
                        yield {"type": "finish", "reason": "error",
                               "error": str(e), "tokens": emitted}
                        return
                except _Transport as e:
                    last_error = e
                    self._note_failure(rep, str(e))
                    tried.add(rep.endpoint)
                    failures += 1
                finally:
                    with self._rep_lock:
                        rep.inflight -= 1
        finally:
            release()

    def _set_depth(self, n: int) -> None:
        _m.set_queue_depth(n)

    # -- dispatch: retry + hedge state machine -------------------------------

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            with self._cond:
                if not self._heap:
                    self._cond.wait(0.05)
                if not self._heap:
                    continue
                _, _, req = heapq.heappop(self._heap)
                self._queued_units = max(0, self._queued_units
                                         - req.units)
                self._set_depth(len(self._heap))
            self._serve(req)

    def _remaining_s(self, req: _FleetRequest) -> float:
        if req.deadline is not None:
            return req.deadline - time.monotonic()
        # no explicit deadline: the router still bounds the request
        return (req.t_enqueue + self.config.request_timeout_s
                - time.monotonic())

    def _serve(self, req: _FleetRequest) -> None:
        cfg = self.config
        now = time.monotonic()
        if req.deadline is not None and now > req.deadline:
            # dropped BEFORE any dispatch is wasted — and the caller
            # gets the typed 504, never silence
            _m.inc(_m.DEADLINE_EXPIRED)
            self._finish_error(req, DeadlineExpired(
                "deadline passed %.1f ms ago while queued in the fleet"
                % ((now - req.deadline) * 1e3)))
            return
        _m.observe(_m.QUEUE_MS, (now - req.t_enqueue) * 1e3)
        attempts = 0
        hedges = 0
        with req.cond:
            while not req.done:
                rem = self._remaining_s(req)
                if rem <= 0:
                    break
                hedge_due = (
                    req.live > 0 and hedges < cfg.max_hedges
                    and cfg.hedge_after_ms is not None
                    and (time.monotonic() - req.last_launch) * 1e3
                    >= cfg.hedge_after_ms)
                want_launch = (req.live == 0) or hedge_due
                if want_launch and req.live == 0 \
                        and attempts >= cfg.max_attempts:
                    break  # retry budget exhausted, nothing in flight
                if want_launch and (req.live > 0
                                    or attempts < cfg.max_attempts):
                    rep = self._pick(exclude=req.tried)
                    if rep is None and req.live == 0:
                        # nowhere to send and nothing in flight: a
                        # short bounded nap — a relaunching replica
                        # may rejoin within the deadline
                        req.cond.wait(min(cfg.backoff_ms / 1e3, rem))
                        continue
                    if rep is not None:
                        if req.live > 0:
                            hedges += 1
                            _m.inc(_m.HEDGES)
                            _flight.record("serving.hedge",
                                           rid=req.rid[:12],
                                           endpoint=rep.endpoint)
                        elif attempts > 0:
                            _m.inc(_m.FLEET_RETRIES)
                        attempts += 1
                        self._launch_attempt(req, rep)
                        continue
                # wait for an attempt to finish, the hedge window to
                # open, or the deadline — whichever is first
                timeout = rem
                if req.live > 0 and hedges < cfg.max_hedges \
                        and cfg.hedge_after_ms is not None:
                    window = (cfg.hedge_after_ms / 1e3
                              - (time.monotonic() - req.last_launch))
                    timeout = min(timeout, max(window, 0.005))
                req.cond.wait(max(0.005, min(timeout, 0.25)))
        if req.done:
            return
        # loop exited without a winner: deadline or budget exhausted
        self._cancel_attempts(req)
        if self._remaining_s(req) <= 0 and (req.deadline is not None):
            _m.inc(_m.DEADLINE_EXPIRED)
            self._finish_error(req, DeadlineExpired(
                "deadline expired after %d attempt(s)%s" % (
                    attempts,
                    (": last error %s" % req.last_error)
                    if req.last_error else "")))
        else:
            self._finish_error(req, ReplicaUnavailable(
                "no replica answered after %d attempt(s)%s" % (
                    attempts,
                    (": last error %s" % req.last_error)
                    if req.last_error else "")))

    def _launch_attempt(self, req: _FleetRequest, rep: Replica) -> None:
        """Called with ``req.cond`` held."""
        req.live += 1
        req.last_launch = time.monotonic()
        req.tried.add(rep.endpoint)
        t = threading.Thread(target=self._run_attempt, args=(req, rep),
                             name="fleet-attempt", daemon=True)
        t.start()

    def _run_attempt(self, req: _FleetRequest, rep: Replica) -> None:
        t0 = time.perf_counter()
        with self._rep_lock:
            rep.inflight += 1
        err: Optional[BaseException] = None
        outcome = "error"
        try:
            rem = self._remaining_s(req)
            if rem <= 0:
                raise _Transport("deadline expired before attempt")
            # the attempt inherits the REMAINING deadline — a hedge or
            # retry must never hand the replica the original budget
            body = json.dumps({"inputs": req.inputs,
                               "deadline_ms": rem * 1e3,
                               "cost_class": req.cost_class}).encode()
            headers = [("X-Request-Id", req.rid)]
            if req.trace_ctx is not None:
                headers += [("X-Trace-Id", req.trace_ctx.trace_id),
                            ("X-Parent-Span", req.trace_ctx.span_id)]
            socks: List[socket.socket] = []

            def sink(s):
                socks.append(s)
                with req.cond:
                    req.attempt_socks.append(s)

            status, raw = _http_call(
                rep.endpoint, "POST", "/predict", body,
                timeout_s=rem, connect_timeout_s=min(
                    self.config.connect_timeout_s, max(rem, 0.05)),
                headers=headers, sock_sink=sink)
            if status == 200:
                doc = json.loads(raw.decode() or "{}")
                outputs = {str(n): np.asarray(v)
                           for n, v in (doc.get("outputs") or {}).items()}
                if self._complete(req, rep, outputs):
                    outcome = "won"
                else:
                    outcome = "wasted"
            elif status == 503:
                # replica-side overload/draining: retryable elsewhere.
                # The reply PROVES the replica process is alive, so
                # this must not count toward dead-replica ejection —
                # ejecting a busy replica under a burst would cascade
                # the overload onto the survivors (the prober handles
                # a genuinely draining one via its lifecycle state)
                e = _Transport("replica %s answered 503"
                               % rep.endpoint)
                e.replica_alive = True
                raise e
            elif status == 504:
                # the REPLICA's queue expired the deadline — it is
                # global, so the request is over everywhere
                _m.inc(_m.DEADLINE_EXPIRED)
                self._finish_error(req, DeadlineExpired(
                    "replica %s: %s" % (rep.endpoint,
                                        _err_of(raw))))
                outcome = "expired"
            else:
                # 400/500: deterministic request/model failure — a
                # retry would fail identically, surface it typed
                self._finish_error(req, ServingError(
                    "replica %s answered %d: %s"
                    % (rep.endpoint, status, _err_of(raw))))
                outcome = "failed"
        except _Transport as e:
            err = e
            if getattr(e, "replica_alive", False):
                with self._rep_lock:
                    rep.failures = 0
            elif not self._was_cancelled(req):
                self._note_failure(rep, str(e))
        except Exception as e:  # noqa: BLE001 — malformed reply etc.
            err = e
            if not self._was_cancelled(req):
                self._note_failure(rep, repr(e))
        finally:
            with self._rep_lock:
                rep.inflight -= 1
                if outcome in ("won", "wasted"):
                    # any completed exchange proves the replica alive
                    rep.failures = 0
            if req.trace_ctx is not None:
                _dtrace.record_span("serving.fleet_attempt", t0,
                                    cat="serving", ctx=req.trace_ctx,
                                    endpoint=rep.endpoint,
                                    outcome=outcome)
            with req.cond:
                req.live -= 1
                req.tried.discard(rep.endpoint)
                if err is not None:
                    req.last_error = err
                req.cond.notify_all()

    @staticmethod
    def _was_cancelled(req: _FleetRequest) -> bool:
        """True when the request already completed — this attempt's
        socket was closed by the winner's cancellation, so its error
        is OUR doing and must not mark the replica unhealthy."""
        with req.cond:
            return req.done

    def _complete(self, req: _FleetRequest, rep: Replica,
                  outputs: Dict[str, np.ndarray]) -> bool:
        """Exactly-once latch: the first completion wins; later ones
        are discarded (and counted) — a hedge can never surface two
        results for one request."""
        with req.cond:
            if req.done:
                _m.inc(_m.HEDGE_WASTED)
                return False
            req.done = True
            req.cond.notify_all()
        with self._rep_lock:
            rep.served += 1
        _m.observe(_m.TOTAL_MS,
                   (time.monotonic() - req.t_enqueue) * 1e3)
        try:
            req.future.set_result(outputs)
        except Exception:
            pass  # caller cancelled
        self._cancel_attempts(req)
        return True

    def _finish_error(self, req: _FleetRequest, exc: Exception) -> None:
        with req.cond:
            if req.done:
                return
            req.done = True
            req.cond.notify_all()
        _m.inc(_m.ERRORS)
        try:
            req.future.set_exception(exc)
        except Exception:
            pass
        self._cancel_attempts(req)

    @staticmethod
    def _cancel_attempts(req: _FleetRequest) -> None:
        """Close every attempt socket still open: the hedge loser (or
        an attempt outliving the deadline) stops consuming a replica
        slot NOW instead of running to completion for a discarded
        result."""
        with req.cond:
            socks, req.attempt_socks = req.attempt_socks, []
        for s in socks:
            try:
                s.close()
            except OSError:
                pass

    # -- routing + health ----------------------------------------------------

    def _pick(self, exclude=(), kind: Optional[str] = None
              ) -> Optional[Replica]:
        """Least-inflight routable replica, round-robin on ties;
        ``exclude`` keeps a hedge off the endpoint its original is
        already waiting on (falls back to it when there is nothing
        else — a straggler beats nothing). ``kind`` restricts to
        replicas whose probed ``engine_kind`` matches (unknown is
        optimistically allowed, like unprobed state)."""
        with self._rep_lock:
            routable = [r for r in self.replicas if r.routable]
            if kind is not None:
                routable = [r for r in routable
                            if r.kind in (kind, "unknown")]
            cands = [r for r in routable if r.endpoint not in exclude] \
                or routable
            if not cands:
                return None
            start = next(self._rr) % len(cands)
            order = cands[start:] + cands[:start]
            return min(order, key=lambda r: r.inflight)

    def _note_failure(self, rep: Replica, why: str) -> None:
        with self._rep_lock:
            rep.failures += 1
            should_eject = (rep.failures >= self.config.eject_after
                            and rep.routable)
        if should_eject:
            self._eject(rep, cause="dead", why=why)

    def _eject(self, rep: Replica, cause: str, why: str = "") -> None:
        with self._rep_lock:
            if not rep.routable:
                return
            rep.state = "draining" if cause == "draining" else "dead"
            rep.ejections += 1
            rep.was_ejected = True
        _m.inc(_m.REPLICA_EJECTIONS, cause=cause)
        _flight.record("serving.replica_ejected", endpoint=rep.endpoint,
                       cause=cause, why=why[:120])

    def _mark_up(self, rep: Replica) -> None:
        with self._rep_lock:
            rep.failures = 0
            if rep.routable:
                if rep.state == "unknown":
                    rep.state = "serving"
                return
            rep.state = "serving"
            rejoin = rep.was_ejected
        if rejoin:
            _m.inc(_m.REPLICA_REJOINS)
            _flight.record("serving.replica_rejoined",
                           endpoint=rep.endpoint)

    def _health_loop(self) -> None:
        interval = max(0.01, self.config.health_interval_ms / 1e3)
        while not self._stop.wait(interval):
            for rep in list(self.replicas):
                if self._stop.is_set():
                    return
                self._probe(rep)

    def _probe(self, rep: Replica) -> None:
        try:
            status, raw = _http_call(
                rep.endpoint, "GET", "/healthz", None,
                timeout_s=max(0.25,
                              self.config.health_interval_ms / 1e3 * 4),
                connect_timeout_s=self.config.connect_timeout_s)
            doc = {}
            try:
                doc = json.loads(raw.decode() or "{}")
            except ValueError:
                pass
            state = str(doc.get("status") or "")
            if status == 200 and state in ("serving", "ok"):
                ekind = str(doc.get("engine_kind") or "")
                occ = doc.get("kv_occupancy")
                with self._rep_lock:
                    if ekind:
                        rep.kind = ekind
                    rep.kv_occupancy = (float(occ) if isinstance(
                        occ, (int, float)) else None)
                self._mark_up(rep)
            elif state in ("draining", "stopped"):
                # the replica SAID it is leaving: stop routing NOW —
                # this is the proactive half the connection-refusal
                # path cannot give
                self._eject(rep, cause="draining", why=state)
            else:
                self._note_failure(rep, "healthz %d %s" % (status, state))
        except (_Transport, OSError, ValueError) as e:
            self._note_failure(rep, str(e))


def _err_of(raw: bytes) -> str:
    try:
        doc = json.loads(raw.decode() or "{}")
        return str(doc.get("error") or doc)[:200]
    except ValueError:
        return raw[:200].decode("latin-1", "replace")
