"""Deterministic fault injection at the RPC frame boundary.

Counterpart of the injector of ``paddle_tpu/distributed/fault.py:92-490``:
the part the fleet router's transport calls (``serving/fleet.py`` routes
every frame it sends and every reply it reads through
``get_injector()``), and so does the parameter server's socket RPC
(``ps_rpc.py``), so a test or a drill can drop, delay, duplicate,
truncate or sever fleet and PS RPCs on demand, seeded so a failing run
replays. ``clock_skew`` is the one clock every lease deadline and
election timer of the parameter server reads, and ``random_plan`` draws
the seeded drop / dup / delay / partition plans of the chaos drills.

Grammar (``PADDLE_TPU_FAULTS``)::

    plan  := spec[,spec...]
    spec  := <side>.<kind>:<prob>[:<param>]
           | partition:<prob>:<peer>[|<peer>]
           | clock_jitter:<prob>:<ms>
    side  := send | recv | any
    kind  := drop | delay | dup | truncate | close
    prob  := float in [0, 1]           (per-frame probability)
    param := delay ms (delay, default 20) | byte count (truncate)
           | endpoint (pair) (partition)

``PADDLE_TPU_FAULT_SEED`` seeds the rolls. Kinds per side: ``send``: drop
(never transmitted), delay (sleep, then transmit), dup (transmit twice:
exercises the replica's request-id dedup), truncate (a prefix, then
sever), close (sever without transmitting); ``recv``: drop (the reader
sees silence), delay, close. A ``partition`` rule blackholes frames to
one peer (or, for an ``A|B`` pair, between the two processes whose
identity, ``set_identity`` or ``PADDLE_TPU_FAULT_IDENTITY``, is A or B).
A ``clock_jitter:<prob>:<ms>`` rule skews this process's lease clock: a
constant offset drawn once in ``[-ms, +ms]`` (seeded by the seed and the
process identity) plus, with probability ``prob`` on each read, a fresh
jitter in the same range.

Every injected fault increments ``fault.injected{side=,kind=}`` in the
observability registry (unconditionally) and records a ``fault.injected``
flight event naming the peer.
"""
from __future__ import annotations

import hashlib
import os
import random
import socket
import threading
import time
from typing import List, Optional

from .. import observability as _obs
from ..observability import flight as _flight

__all__ = ["FaultRule", "FaultInjector", "FaultInjected",
           "get_injector", "reset_injector", "parse_plan",
           "random_plan", "set_identity", "get_identity",
           "clock_skew"]

_SIDES = ("send", "recv", "any")
_KINDS = ("drop", "delay", "dup", "truncate", "close", "partition",
          "clock_jitter")
_RECV_KINDS = ("drop", "delay", "close", "partition")


class FaultInjected(OSError):
    """Raised by the injector when it severs a connection (close /
    truncate) — an ``OSError`` so transport retry paths treat it
    exactly like a real peer failure."""


class FaultRule:
    __slots__ = ("side", "kind", "prob", "param")

    def __init__(self, side: str, kind: str, prob: float,
                 param=None):
        if side not in _SIDES:
            raise ValueError("fault side must be one of %s, got %r"
                             % (_SIDES, side))
        if kind not in _KINDS:
            raise ValueError("fault kind must be one of %s, got %r"
                             % (_KINDS, kind))
        if side == "recv" and kind not in _RECV_KINDS:
            raise ValueError(
                "recv-side faults support %s (a receiver cannot %s a "
                "frame it does not own)" % (_RECV_KINDS, kind))
        if not 0.0 <= prob <= 1.0:
            raise ValueError("fault probability must be in [0,1], got %r"
                             % prob)
        if kind == "partition":
            if not param or not str(param).strip():
                raise ValueError(
                    "partition rules need a peer endpoint (or an A|B "
                    "pair) as their param")
            param = str(param).strip()
        if kind == "clock_jitter":
            if param is None or float(param) <= 0:
                raise ValueError(
                    "clock_jitter rules need a positive magnitude in "
                    "milliseconds as their param")
            param = float(param)
        self.side = side
        self.kind = kind
        self.prob = prob
        self.param = param

    def partition_peer(self, identity: Optional[str]) -> Optional[str]:
        """The endpoint this rule severs FROM THIS PROCESS, or None
        when the rule is inactive here. A pair ``A|B`` is active only
        when the process identity is one of the pair (the peer is the
        other one); a single-endpoint param partitions this process
        from that peer unconditionally."""
        if self.kind != "partition":
            return None
        if "|" in self.param:
            a, _, b = self.param.partition("|")
            a, b = a.strip(), b.strip()
            if identity == a:
                return b
            if identity == b:
                return a
            return None
        return self.param

    def __repr__(self):
        if self.param is None:
            return "%s.%s:%g" % (self.side, self.kind, self.prob)
        if isinstance(self.param, str):
            return "%s.%s:%g:%s" % (self.side, self.kind, self.prob,
                                    self.param)
        return "%s.%s:%g:%g" % (self.side, self.kind, self.prob,
                                self.param)


def parse_plan(plan: str) -> List[FaultRule]:
    """Parse the ``PADDLE_TPU_FAULTS`` grammar into rules; raises
    ``ValueError`` naming the offending spec."""
    rules = []
    for spec in plan.split(","):
        spec = spec.strip()
        if not spec:
            continue
        try:
            head, _, rest = spec.partition(":")
            side, dot, kind = head.partition(".")
            if not dot and side in ("partition", "clock_jitter"):
                # bare "partition:prob:peer" / "clock_jitter:prob:ms" —
                # side is meaningless for a non-frame fault, default it
                side, kind = "any", side
            if kind == "partition":
                # the param is an endpoint (pair) and endpoints contain
                # colons: only the FIRST colon after prob splits
                prob_s, _, param_s = rest.partition(":")
                prob = float(prob_s)
                param = param_s or None
            else:
                parts = rest.split(":")
                prob = float(parts[0])
                param = float(parts[1]) if len(parts) > 1 else None
            rules.append(FaultRule(side, kind, prob, param))
        except (ValueError, IndexError) as e:
            raise ValueError(
                "bad PADDLE_TPU_FAULTS spec %r (grammar: "
                "side.kind:prob[:param]): %s" % (spec, e)) from None
    return rules


def _count(side: str, kind: str, **fields) -> None:
    _obs.counter("fault.injected", side=side, kind=kind).inc()
    # black-box line: the postmortem of a drill needs WHICH frames the
    # injector ate interleaved with the recovery decisions they caused
    # (partition events carry the severed peer so the drill can prove
    # WHICH pair was cut)
    _flight.record("fault.injected", side=side, kind=kind, **fields)


# the menu of randomized chaos schedules: only faults that retry and
# dedupe absorb. close / truncate sever the connection, which at a
# drill's probabilities would spend the retry budget and fail over a
# healthy primary; they stay material for directed tests.
_RANDOM_MENU = (
    ("send", "drop", (0.01, 0.05), None),
    ("send", "dup", (0.01, 0.05), None),
    ("send", "delay", (0.02, 0.10), (5.0, 30.0)),
    ("recv", "drop", (0.01, 0.04), None),
    ("recv", "delay", (0.02, 0.10), (5.0, 30.0)),
    ("any", "delay", (0.02, 0.08), (5.0, 20.0)),
)


def clock_skew() -> float:
    """The clock offset (seconds) the lease and election timers apply
    right now; 0.0 without an injector or a ``clock_jitter`` rule."""
    inj = get_injector()
    if inj is None or not inj.clock_rules:
        return 0.0
    return inj.clock_skew_s()


def random_plan(rng: random.Random, max_rules: int = 3,
                partition_peers=None, clock_jitter_ms=None) -> str:
    """A seeded ``PADDLE_TPU_FAULTS`` plan drawn from the recoverable
    menu: the same ``rng`` state gives the same plan (and the JAX
    package's ``random_plan`` draws the same one). ``partition_peers``
    (``"A|B"`` pairs) adds one hard ``partition:1`` rule for a pair the
    rng picks; ``clock_jitter_ms`` appends ``clock_jitter:0.5:<ms>``
    after the other draws, using no rng."""
    n = rng.randint(1, max(1, int(max_rules)))
    picks = rng.sample(range(len(_RANDOM_MENU)), min(n, len(_RANDOM_MENU)))
    specs = []
    for i in sorted(picks):
        side, kind, (plo, phi), prange = _RANDOM_MENU[i]
        prob = round(rng.uniform(plo, phi), 4)
        if prange is None:
            specs.append("%s.%s:%g" % (side, kind, prob))
        else:
            param = round(rng.uniform(*prange), 1)
            specs.append("%s.%s:%g:%g" % (side, kind, prob, param))
    if partition_peers:
        pair = partition_peers[rng.randrange(len(partition_peers))]
        specs.append("partition:1:%s" % pair)
    if clock_jitter_ms:
        specs.append("clock_jitter:0.5:%g" % float(clock_jitter_ms))
    plan = ",".join(specs)
    parse_plan(plan)  # a drawn plan always parses
    return plan


# -- process identity (partition rules) -------------------------------------

_identity: Optional[str] = None


def set_identity(endpoint: Optional[str]) -> None:
    """Name this process for endpoint-pair partition rules (env
    ``PADDLE_TPU_FAULT_IDENTITY`` seeds it otherwise)."""
    global _identity
    _identity = endpoint


def get_identity() -> Optional[str]:
    global _identity
    if _identity is None:
        _identity = os.environ.get("PADDLE_TPU_FAULT_IDENTITY") or None
    return _identity


def _peer_endpoint(sock) -> Optional[str]:
    """``host:port`` of the socket's remote end, or None when the
    socket has no peer (fakes in tests, already-severed conns)."""
    try:
        addr = sock.getpeername()
        return "%s:%d" % (addr[0], addr[1])
    except (OSError, AttributeError, TypeError, IndexError):
        return None


class FaultInjector:
    """Seeded per-process fault source. One shared ``random.Random``
    behind a lock: the ROLL SEQUENCE (not per-connection state) is what
    the seed pins, so a run's fault pattern replays given the same
    interleaving — and tests that need exact replay use a single
    thread."""

    def __init__(self, rules: List[FaultRule], seed: int = 0):
        self.rules = [r for r in rules
                      if r.kind not in ("partition", "clock_jitter")]
        self.partitions = [r for r in rules if r.kind == "partition"]
        self.clock_rules = [r for r in rules
                            if r.kind == "clock_jitter"]
        self._rng = random.Random(seed)
        self._seed = int(seed)
        self._lock = threading.Lock()
        # the per-process constant skew, drawn at the first clock read
        self._clock_skew_s: Optional[float] = None

    @classmethod
    def from_env(cls) -> Optional["FaultInjector"]:
        plan = os.environ.get("PADDLE_TPU_FAULTS", "")
        if not plan.strip():
            return None
        seed = int(os.environ.get("PADDLE_TPU_FAULT_SEED", "0"))
        return cls(parse_plan(plan), seed=seed)

    def _pick(self, side: str) -> Optional[FaultRule]:
        """At most ONE fault per frame: the first matching rule whose
        roll fires wins (rules are evaluated in plan order). An
        ``any``-side rule whose kind has no recv meaning (dup,
        truncate) only ever applies on the send side."""
        with self._lock:
            for r in self.rules:
                if r.side not in (side, "any"):
                    continue
                if side == "recv" and r.kind not in _RECV_KINDS:
                    continue
                if self._rng.random() < r.prob:
                    return r
        return None

    @staticmethod
    def _sever(sock: socket.socket) -> None:
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass

    def _partitioned(self, side: str, sock: socket.socket) -> bool:
        """True when the frame crossing ``sock`` must be blackholed by
        a partition rule: the socket's peer is the severed endpoint and
        the per-frame roll fires. Evaluated BEFORE the single-fault
        menu — a partition overrides everything else on that link."""
        if not self.partitions:
            return False
        peer = _peer_endpoint(sock)
        if peer is None:
            return False
        me = get_identity()
        for r in self.partitions:
            if r.partition_peer(me) != peer:
                continue
            with self._lock:
                fires = self._rng.random() < r.prob
            if fires:
                _count(side, "partition", peer=peer)
                return True
        return False

    # -- the clock hook (the PS lease and election timers read it) --------

    def clock_skew_s(self) -> float:
        """How far (seconds) this process's lease clock is off right
        now: the per-process constant skew plus, with each rule's
        probability, a fresh jitter. 0.0 without ``clock_jitter``."""
        if not self.clock_rules:
            return 0.0
        with self._lock:
            if self._clock_skew_s is None:
                ident = get_identity() or ""
                h = int.from_bytes(
                    hashlib.blake2b(
                        ("%d|%s" % (self._seed, ident)).encode(),
                        digest_size=8).digest(), "big")
                srng = random.Random(h)
                skew = 0.0
                for r in self.clock_rules:
                    skew += srng.uniform(-r.param, r.param) / 1e3
                self._clock_skew_s = skew
                _flight.record("fault.clock_skew", identity=ident,
                               skew_ms=round(skew * 1e3, 1))
            off = self._clock_skew_s
            for r in self.clock_rules:
                if self._rng.random() < r.prob:
                    off += self._rng.uniform(-r.param, r.param) / 1e3
                    _count("any", "clock_jitter")
        return off

    # -- frame hooks (the fleet router's transport calls them) -----------

    def on_send(self, sock: socket.socket, frame: bytes) -> bool:
        """Apply at most one send-side fault to ``frame``. Returns True
        when the frame reached the wire (possibly twice), False when it
        was dropped; raises ``FaultInjected`` when the connection was
        severed."""
        if self._partitioned("send", sock):
            return False  # blackholed: the peer sees silence, not EOF
        r = self._pick("send")
        if r is None:
            sock.sendall(frame)
            return True
        # the flight line names the severed peer: a fleet/PS drill's
        # postmortem needs WHICH link each eaten frame belonged to
        _count("send", r.kind, peer=_peer_endpoint(sock))
        if r.kind == "drop":
            return False
        if r.kind == "delay":
            time.sleep((r.param if r.param is not None else 20.0) / 1e3)
            sock.sendall(frame)
            return True
        if r.kind == "dup":
            sock.sendall(frame)
            sock.sendall(frame)
            return True
        if r.kind == "truncate":
            cut = int(r.param) if r.param is not None else max(
                1, len(frame) // 2)
            sock.sendall(frame[:max(0, min(cut, len(frame) - 1))])
            self._sever(sock)
            raise FaultInjected("injected: frame truncated mid-send")
        # close
        self._sever(sock)
        raise FaultInjected("injected: connection closed before send")

    def on_recv(self, sock: socket.socket) -> str:
        """Decide the fate of the NEXT incoming frame. Returns
        ``"pass"`` (deliver), ``"drop"`` (read and discard), or raises
        ``FaultInjected`` after severing (close)."""
        if self._partitioned("recv", sock):
            return "drop"  # the peer's reply dies in the partition
        r = self._pick("recv")
        if r is None:
            return "pass"
        _count("recv", r.kind, peer=_peer_endpoint(sock))
        if r.kind == "delay":
            time.sleep((r.param if r.param is not None else 20.0) / 1e3)
            return "pass"
        if r.kind == "drop":
            return "drop"
        self._sever(sock)
        raise FaultInjected("injected: connection closed before recv")


# -- process-wide injector (env-armed, resettable for tests) ---------------

_UNSET = object()
_injector = _UNSET
_injector_lock = threading.Lock()


def get_injector() -> Optional[FaultInjector]:
    """The process injector, built from ``PADDLE_TPU_FAULTS`` on first
    use; ``None`` when no plan is configured."""
    global _injector
    if _injector is _UNSET:
        with _injector_lock:
            if _injector is _UNSET:
                _injector = FaultInjector.from_env()
    return _injector


def reset_injector() -> None:
    """Drop the cached injector so the next ``get_injector`` re-reads
    the environment (tests toggle the plan mid-process)."""
    global _injector
    with _injector_lock:
        _injector = _UNSET
