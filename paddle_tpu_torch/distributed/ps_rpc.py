"""Socket RPC for the parameter server: the dataplane half.

The port of ``paddle_tpu/distributed/ps_rpc.py`` for what a CTR job needs
to train over pservers in sync and async mode: the wire format, the
server's round protocol and dataplane kinds, heartbeat eviction, the
nonce dedupe, and the client with its deadlines, retries and heartbeats.
The wire is the JAX package's, frame for frame, so a client of either
package talks to a server of the other.

Wire format (no pickle: a frame from the network must not be able to run
code): an 8-byte little-endian header length, the json header, an 8-byte
raw length, the raw array bytes. The header carries json scalars only;
an array travels as dtype and shape in the header plus the raw section.

Round protocol (sync mode, the reference's RunSyncLoop): ``send_grad``
buffers one grad a trainer; the fanin-th ``send_barrier`` sums each
grad in trainer-id order, runs its optimize block and opens the params;
``get_param`` waits for the open round; the fanin-th ``fetch_barrier``
closes it. A ``send_barrier`` of round N+1 waits until round N is
fully fetched. Async mode (RunAsyncLoop) applies each grad on arrival.
``pull_sparse`` / ``push_sparse`` serve a row-sliced table outside the
rounds, as pslib does: a push runs the table's optimize block at once.

Fault tolerance kept here: every frame passes through ``fault.py``'s
injector; the client retries each rpc with bounded exponential backoff
after a timeout, EOF or lost connection, with a ``(cid, round, seq)``
token the server executes once; a server armed with ``evict_after``
evicts a trainer whose heartbeats stop, shrinking the fanin, and
re-admits it when it trains again.

The survivability half of the JAX module is not ported yet: replication
to backups and failover, leases and the quorum election, the catch-up
of a rejoining server, live and range migrations, durable rounds and the
async op log, and ``PSWitness``. Each of their knobs raises
``NotImplementedError`` naming the missing part (``_refuse``).

On the card a server's executor holds its state as CUDA tensors; every
array crossing the wire is copied between host and device at
``host_array`` / ``device_tensor``, which count the copies
(``copy_counts``).
"""
from __future__ import annotations

import json
import os
import random
import socket
import struct
import sys
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..observability import distributed as _dtrace
from ..observability import flight as _flight
from . import fault as _fault

__all__ = ["PSServer", "PSClient", "HeartBeatMonitor",
           "snapshot_scope_to_dir", "copy_counts", "reset_copy_counts",
           "host_array", "device_tensor", "gather_rows", "write_array",
           "selected_rows"]

_ROUND_TIMEOUT = float(os.environ.get("PADDLE_PS_ROUND_TIMEOUT", "120"))

# kinds whose per-frame flight events would flood the bounded ring
_FLIGHT_QUIET = ("heartbeat", "repl_status", "lease_renew")

# the kinds of the survivability half, refused by name on both sides
_SURVIVABILITY_KINDS = {
    "replicate": "replication to backups",
    "join_backup": "the catch-up of a rejoining server",
    "repl_status": "replication to backups",
    "lease_renew": "leases and the quorum election",
    "vote": "leases and the quorum election",
    "migrate_begin": "live migration",
    "migrate_install": "live migration",
    "migrate_commit": "live migration",
    "migrate_range_begin": "range migration",
    "migrate_range_install": "range migration",
    "migrate_range_commit": "range migration",
}


def _refuse(part: str):
    raise NotImplementedError(
        "%s of the JAX package's parameter server is not ported to "
        "paddle_tpu_torch yet (ROADMAP.md queue 1 item 5)" % part)


def _counter(name: str, **labels):
    from .. import observability as _obs

    return _obs.counter(name, **labels)


def _gauge(name: str, **labels):
    from .. import observability as _obs

    return _obs.gauge(name, **labels)


def _histogram(name: str, **labels):
    from .. import observability as _obs

    return _obs.histogram(name, **labels)


def _endpoints_from_env() -> List[str]:
    raw = os.environ.get("PADDLE_PSERVER_ENDPOINTS", "")
    return [e.strip() for e in raw.split(",") if e.strip()]


# -- host <-> device copies --------------------------------------------------

_copies = {"h2d": 0, "d2h": 0, "h2d_bytes": 0, "d2h_bytes": 0}
_copies_lock = threading.Lock()


def copy_counts() -> Dict[str, int]:
    """Host-to-device and device-to-host copies made by the PS ops and the
    server since the last ``reset_copy_counts``: counts and bytes."""
    with _copies_lock:
        return dict(_copies)


def reset_copy_counts() -> None:
    with _copies_lock:
        for k in _copies:
            _copies[k] = 0


def _count_copy(direction: str, nbytes: int) -> None:
    with _copies_lock:
        _copies[direction] += 1
        _copies[direction + "_bytes"] += int(nbytes)


def host_array(val) -> np.ndarray:
    """A scope value as a numpy array on the host; a tensor on the card
    is copied down (one counted device-to-host copy)."""
    if isinstance(val, np.ndarray):
        return val
    if isinstance(val, torch.Tensor):
        t = val.detach()
        if t.device.type != "cpu":
            _count_copy("d2h", t.numel() * t.element_size())
            t = t.cpu()
        return t.numpy()
    if hasattr(val, "array"):  # a LoDTensor
        return host_array(val.array)
    return np.asarray(val)


def device_tensor(executor, arr) -> torch.Tensor:
    """A host array as a tensor on ``executor``'s device; a copy up to the
    card is counted."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    dev = torch.device(executor.device)
    if dev.type != "cpu":
        _count_copy("h2d", t.numel() * t.element_size())
        t = t.to(dev)
    return t


def gather_rows(tbl, ids: np.ndarray) -> np.ndarray:
    """Rows ``ids`` of a table, gathered where the table lies: on the card
    the ids go up and only the gathered rows come down."""
    if isinstance(tbl, torch.Tensor):
        idx = torch.from_numpy(np.ascontiguousarray(
            np.asarray(ids, dtype=np.int64)))
        if tbl.device.type != "cpu":
            _count_copy("h2d", idx.numel() * idx.element_size())
            idx = idx.to(tbl.device)
        return np.ascontiguousarray(host_array(tbl[idx]))
    return np.ascontiguousarray(host_array(tbl)[ids])


def write_array(executor, scope, name: str, arr) -> None:
    executor._write_var(scope, name, device_tensor(executor, arr))


def selected_rows(executor, rows, vals, height: int):
    from ..core.tensor import LoDTensor, SelectedRows

    sr = SelectedRows(rows=[int(r) for r in rows], height=int(height))
    sr._value = LoDTensor(device_tensor(executor, vals))
    return sr


# -- the wire -----------------------------------------------------------------

def _send_msg(sock: socket.socket, msg: dict,
              raw: bytes = b"") -> None:
    header = json.dumps(msg).encode("utf-8")
    frame = (struct.pack("<Q", len(header)) + header
             + struct.pack("<Q", len(raw)) + raw)
    inj = _fault.get_injector()
    if inj is not None:
        inj.on_send(sock, frame)  # may drop/dup/sever per the plan
    else:
        sock.sendall(frame)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def _recv_msg(sock: socket.socket):
    """Returns (msg_dict, raw_bytes) or None on EOF."""
    while True:
        inj = _fault.get_injector()
        action = inj.on_recv(sock) if inj is not None else "pass"
        h = _recv_exact(sock, 8)
        if h is None:
            return None
        (hlen,) = struct.unpack("<Q", h)
        header = _recv_exact(sock, hlen)
        if header is None:
            return None
        r = _recv_exact(sock, 8)
        if r is None:
            return None
        (rlen,) = struct.unpack("<Q", r)
        raw = _recv_exact(sock, rlen) if rlen else b""
        if raw is None:
            return None
        if action == "drop":
            continue  # injected: the frame evaporates in flight
        return json.loads(header.decode("utf-8")), raw


def _array_header(arr: np.ndarray) -> dict:
    return {"dtype": str(arr.dtype), "shape": list(arr.shape)}


def _array_from(header: dict, raw: bytes) -> np.ndarray:
    return np.frombuffer(raw, dtype=header["dtype"]).reshape(
        header["shape"]).copy()


def _bare_rpc(endpoint: str, msg: dict, timeout: float = 1.0) -> dict:
    """One connect and frame exchange with none of ``PSClient``'s retry or
    dedupe: where a failure is the signal. ``ConnectionRefusedError``
    propagates as itself (no listener owns the endpoint), distinct from a
    timeout. Frames still pass the fault injector."""
    host, port = endpoint.rsplit(":", 1)
    sock = socket.create_connection((host or "127.0.0.1", int(port)),
                                    timeout=timeout)
    try:
        sock.settimeout(timeout)
        _send_msg(sock, msg)
        got = _recv_msg(sock)
        if got is None:
            raise OSError("EOF from %s during %s"
                          % (endpoint, msg.get("kind")))
        return got[0]
    finally:
        try:
            sock.close()
        except OSError:
            pass


def snapshot_scope_to_dir(executor, scope, dirname: str,
                          names_map: bool = False) -> None:
    """Write every tensor var of ``scope`` into ``dirname`` in the
    reference's tensor-stream format (``core/proto_format.py``), so the
    files load in either package. Each file lands by tmp + fsync +
    rename, and the sha256 manifest is rewritten over the whole directory
    after this server's files: several servers may share one directory.
    ``names_map=True`` also writes ``__vars__.json`` (file name -> var
    name) for a dedicated snapshot."""
    from ..checkpoint import (SCOPE_VARS_NAME, atomic_write_bytes,
                              makedirs_durable, write_manifest)
    from ..core import proto_format

    makedirs_durable(dirname)
    names: Dict[str, str] = {}
    for name in list(scope.local_var_names()):
        val = executor._read_var(scope, name)
        if val is None or not hasattr(val, "shape"):
            continue
        fn = name.replace("/", "_")
        names[fn] = name
        atomic_write_bytes(
            os.path.join(dirname, fn),
            proto_format.serialize_lod_tensor(host_array(val)))
    if names_map:
        atomic_write_bytes(
            os.path.join(dirname, SCOPE_VARS_NAME),
            json.dumps(names, indent=1, sort_keys=True).encode())
    write_manifest(dirname)


class HeartBeatMonitor:
    """Per-trainer last-ping tracking (the reference's
    ``heart_beat_monitor.h``)."""

    def __init__(self, stale_seconds: float = 60.0):
        self._last: Dict[int, float] = {}
        self._stale = stale_seconds
        self._lock = threading.Lock()

    def ping(self, trainer_id: int) -> None:
        with self._lock:
            self._last[int(trainer_id)] = time.time()

    def register(self, trainer_ids) -> None:
        """Start the staleness clock of expected trainers that have not
        pinged yet: a rank that dies before its first rpc must still
        become evictable."""
        now = time.time()
        with self._lock:
            for t in trainer_ids:
                self._last.setdefault(int(t), now)

    def forget(self, trainer_id: int) -> None:
        with self._lock:
            self._last.pop(int(trainer_id), None)

    def status(self) -> Dict[int, float]:
        """trainer_id -> seconds since last ping."""
        now = time.time()
        with self._lock:
            return {t: now - ts for t, ts in self._last.items()}

    def stale_trainers(self) -> List[int]:
        return [t for t, age in self.status().items()
                if age > self._stale]


class PSServer:
    """One pserver endpoint: the RunSyncLoop round protocol in sync mode,
    each grad applied on arrival in async mode, sparse pulls and pushes
    outside the rounds.

    ``evict_after`` (seconds; env ``PADDLE_PS_EVICT_AFTER``, 0 = off)
    arms the heartbeat monitor: a trainer silent that long leaves the
    effective fanin so the survivors' barriers complete, and the
    heartbeat response names it. The knobs of the survivability half
    (backups in ``endpoints``, ``rejoin``, ``lease_ms``, ``witnesses``,
    ``durable_dir``, ``block_factory``) raise ``NotImplementedError``."""

    _DEDUPE_CAP = 512  # distinct live client nonces remembered

    _DATAPLANE = ("send_grad", "send_barrier", "get_param",
                  "fetch_barrier", "pull_sparse", "push_sparse")

    def __init__(self, endpoint: str, executor, scope, grad_to_block,
                 fanin: int = 1, sync_mode: bool = True,
                 evict_after: Optional[float] = None,
                 endpoints: Optional[List[str]] = None,
                 rejoin: Optional[bool] = None,
                 anchor_every: Optional[int] = None,
                 lease_ms: Optional[float] = None,
                 shard: Optional[int] = None,
                 witnesses: Optional[List[str]] = None,
                 block_factory=None,
                 durable_dir: Optional[str] = None):
        if endpoints is None:
            endpoints = _endpoints_from_env()
        group = [e.strip() for e in (endpoints or []) if e.strip()]
        if endpoint in group and len(group) > 1:
            _refuse("replication to backups (a server group of %d "
                    "endpoints)" % len(group))
        if rejoin is None:
            rejoin = os.environ.get("PADDLE_PS_REJOIN") == "1"
        if rejoin:
            _refuse("the catch-up of a rejoining server (rejoin)")
        if witnesses is None:
            witnesses = [e for e in os.environ.get(
                "PADDLE_PS_WITNESSES", "").split(",") if e.strip()]
        if witnesses:
            _refuse("PSWitness and the witness quorum (witnesses)")
        if lease_ms:
            _refuse("leases and the quorum election (lease_ms)")
        if durable_dir is None:
            durable_dir = os.environ.get("PADDLE_PS_DURABLE_DIR") or None
        if durable_dir:
            _refuse("durable rounds and the async op log (durable_dir)")
        if block_factory is not None:
            _refuse("live migration (block_factory)")
        if anchor_every is not None:
            _refuse("delta replication (anchor_every)")
        host, port = endpoint.rsplit(":", 1)
        if _fault.get_identity() is None:
            _fault.set_identity(endpoint)
        self._executor = executor
        self._scope = scope
        self._grad_to_block = grad_to_block
        self._fanin = max(int(fanin), 1)
        self._sync = bool(sync_mode)
        self._own_endpoint = endpoint
        if shard is None:
            shard = int(os.environ.get("PADDLE_PSERVER_SHARD", "0"))
        self._shard = str(int(shard))
        self._applied_round = 0
        if evict_after is None:
            evict_after = float(os.environ.get("PADDLE_PS_EVICT_AFTER",
                                               "0"))
        self._evict_after = float(evict_after)
        self.monitor = HeartBeatMonitor(
            stale_seconds=self._evict_after if self._evict_after > 0
            else 60.0)
        self._evicted: set = set()
        self._clock_started = False
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # var name -> {trainer_id: grad}: keyed, so a relaunched trainer
        # re-sending its round replaces its dead incarnation's grad, and
        # summed in trainer-id order, so the total is bit-deterministic
        self._pending: Dict[str, Dict[int, np.ndarray]] = {}
        self._send_barriers = 0
        self._fetch_barriers = 0
        self._round_complete = True   # params servable before round 1
        self._fetches_pending = False  # between apply and last fetch
        # per-client (token, response) cache, keyed by the client's
        # random nonce: a resend after a reconnect runs once
        self._dedupe: Dict[str, list] = {}   # cid -> [key, ev, resp, raw, ts]
        self._last_seq: Dict[str, int] = {}  # cid -> highest seq admitted
        self._dedupe_lock = threading.Lock()
        self._shutdown = threading.Event()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host or "127.0.0.1", int(port)))
        self._sock.listen(16)
        self._threads: List[threading.Thread] = []
        self._conns: set = set()
        self._conn_lock = threading.Lock()
        if self._evict_after > 0:
            t = threading.Thread(target=self._evict_loop,
                                 name="ps-evict-monitor", daemon=True)
            t.start()
            self._threads.append(t)

    # -- round protocol ---------------------------------------------------

    def _effective_fanin(self) -> int:
        return max(1, self._fanin - len(self._evicted))

    def _stale_train_round_locked(self, msg: dict) -> bool:
        """True when the rpc names a training round (``tr``) this server
        already applied: the re-send of a trainer whose round sailed
        without it (eviction shrank the fanin)."""
        tr = msg.get("tr")
        stale = tr is not None and int(tr) <= self._applied_round
        if stale:
            _counter("ps.stale_rounds").inc()
            _flight.record("ps.stale_round", kind=msg.get("kind"),
                           tr=int(tr), applied=self._applied_round,
                           trainer=msg.get("trainer_id"))
        return stale

    def _apply_round(self):
        """Every trainer's grads are in (locked by caller): sum each grad
        in trainer-id order, run its optimize block, open the params."""
        nxt = self._applied_round + 1
        _flight.record("ps.round_apply", round=nxt,
                       vars=len(self._pending))
        t_apply = time.monotonic()
        with _dtrace.child_span("ps.apply_round", cat="ps", round=nxt):
            for name in sorted(self._pending):
                by_tid = self._pending[name]
                tids = sorted(by_tid)
                total = by_tid[tids[0]]
                for t in tids[1:]:
                    total = total + by_tid[t]
                write_array(self._executor, self._scope, name, total)
                sub = self._grad_to_block.get(name)
                if sub is not None:
                    t_blk = time.monotonic()
                    self._executor.run_block(sub, self._scope)
                    _histogram("ps.apply_ms", shard=self._shard,
                               table=name.split("@", 1)[0]).observe(
                        (time.monotonic() - t_blk) * 1e3)
            self._pending.clear()
            self._send_barriers = 0
            self._applied_round += 1
        _histogram("ps.apply_ms", shard=self._shard,
                   table="_round").observe(
            (time.monotonic() - t_apply) * 1e3)
        _flight.record("ps.round_applied", round=self._applied_round)
        self._round_complete = True
        self._fetches_pending = True
        self._cond.notify_all()

    def _wait_for(self, predicate, what: str):
        """Bounded condition wait (locked by caller): names the stale
        trainers instead of hanging when a rank died."""
        deadline = time.time() + _ROUND_TIMEOUT
        while not predicate():
            if self._shutdown.is_set():
                raise RuntimeError("pserver shut down mid-round")
            if time.time() > deadline:
                raise RuntimeError(
                    "PS round stalled waiting for %s (fanin=%d); stale "
                    "trainers by heartbeat: %s"
                    % (what, self._fanin, self.monitor.stale_trainers()))
            self._cond.wait(timeout=1.0)

    # -- eviction (heart_beat_monitor.h semantics) ------------------------

    def _evict_loop(self):
        period = max(self._evict_after / 4.0, 0.05)
        while not self._shutdown.wait(period):
            stale = self.monitor.stale_trainers()
            if not stale:
                continue
            with self._lock:
                for t in stale:
                    if t not in self._evicted:
                        self._evict_locked(t)

    def _evict_locked(self, trainer_id: int) -> None:
        """Remove a dead trainer from the round math (locked by caller):
        shrink the effective fanin and re-check both barriers."""
        self._evicted.add(trainer_id)
        self.monitor.forget(trainer_id)
        _counter("ps.evictions").inc()
        _flight.record("ps.eviction", trainer=trainer_id,
                       effective_fanin=self._effective_fanin())
        print("[ps_rpc] evicting trainer %d (silent > %.1fs); "
              "effective fanin now %d"
              % (trainer_id, self._evict_after, self._effective_fanin()),
              file=sys.stderr, flush=True)
        eff = self._effective_fanin()
        if not self._round_complete and self._send_barriers >= eff:
            self._apply_round()
        if self._fetches_pending and self._fetch_barriers >= eff:
            self._fetch_barriers = 0
            self._fetches_pending = False
        self._cond.notify_all()

    def _readmit(self, trainer_id: int) -> None:
        with self._lock:
            if trainer_id in self._evicted:
                self._evicted.discard(trainer_id)
                _counter("ps.readmissions").inc()
                _flight.record("ps.readmission", trainer=trainer_id)
                print("[ps_rpc] re-admitting trainer %d; effective "
                      "fanin now %d"
                      % (trainer_id, self._effective_fanin()),
                      file=sys.stderr, flush=True)

    def _read_host(self, name: str):
        val = self._executor._read_var(self._scope, name)
        return None if val is None else host_array(val)

    def _handle(self, msg: dict, raw: bytes):
        """Returns (response_dict, response_raw)."""
        kind = msg["kind"]
        if kind in _SURVIVABILITY_KINDS:
            return {"ok": False,
                    "error": "kind %r (%s) is not ported to "
                             "paddle_tpu_torch" % (
                                 kind, _SURVIVABILITY_KINDS[kind])}, b""
        if kind in self._DATAPLANE:
            with self._lock:
                if int(msg.get("round", 0)) > self._applied_round:
                    return {"ok": False, "not_primary": True,
                            "error": "endpoint %s is at round %d but "
                            "the client observed round %s — refusing "
                            "to serve stale params"
                            % (self._own_endpoint, self._applied_round,
                               msg.get("round"))}, b""
        if "trainer_id" in msg:
            tid = int(msg["trainer_id"])
            if self._evict_after > 0 and not self._clock_started:
                # the first sign of life arms the clock for every
                # expected rank
                self._clock_started = True
                self.monitor.register(range(self._fanin))
            self.monitor.ping(tid)
            if tid in self._evicted and kind in self._DATAPLANE:
                self._readmit(tid)
        if kind == "send_grad":
            arr = _array_from(msg["array"], raw)
            with self._lock:
                if self._sync:
                    if self._stale_train_round_locked(msg):
                        return {"ok": True, "stale_round": True,
                                "round": self._applied_round}, b""
                    self._pending.setdefault(
                        msg["name"], {})[int(msg.get("trainer_id",
                                                     0))] = arr
                else:  # async: apply now (RunAsyncLoop)
                    write_array(self._executor, self._scope, msg["name"], arr)
                    sub = self._grad_to_block.get(msg["name"])
                    if sub is not None:
                        self._executor.run_block(sub, self._scope)
            return {"ok": True}, b""
        if kind == "send_barrier":
            with self._lock:
                if self._sync and self._stale_train_round_locked(msg):
                    return {"ok": True, "stale_round": True,
                            "round": self._applied_round}, b""
                # gate round N+1 on round N being fully fetched
                self._wait_for(lambda: not self._fetches_pending,
                               "previous round's fetch barriers")
                self._send_barriers += 1
                self._round_complete = False
                if self._send_barriers >= self._effective_fanin():
                    self._apply_round()
                else:
                    self._wait_for(lambda: self._round_complete,
                                   "all trainers' send barriers")
                resp = {"ok": True, "round": self._applied_round}
            return resp, b""
        if kind == "get_param":
            with self._lock:
                if self._sync:
                    self._wait_for(lambda: self._round_complete,
                                   "the optimize round")
                val = self._read_host(msg["name"])
            if val is None:
                return {"ok": False,
                        "error": "no var %r" % msg["name"]}, b""
            arr = np.ascontiguousarray(val)
            return {"ok": True, "array": _array_header(arr)}, \
                arr.tobytes()
        if kind == "fetch_barrier":
            with self._lock:
                if self._fetches_pending:
                    self._fetch_barriers += 1
                    if self._fetch_barriers >= self._effective_fanin():
                        self._fetch_barriers = 0
                        self._fetches_pending = False
                        self._cond.notify_all()
            return {"ok": True}, b""
        if kind == "pull_sparse":
            # LOCAL row ids in, value rows out; not gated on the dense
            # round (a pull happens at forward time: two sync trainers
            # would deadlock on each other's barrier)
            ids = _array_from(msg["array"], raw).reshape(-1)
            with self._lock:
                tbl = self._executor._read_var(self._scope, msg["name"])
                if tbl is not None:
                    vals = gather_rows(tbl, ids)
            if tbl is None:
                return {"ok": False,
                        "error": "no table %r" % msg["name"]}, b""
            return {"ok": True, "array": _array_header(vals)}, \
                vals.tobytes()
        if kind == "push_sparse":
            # applied at once (pslib PushSparseVarsAsync); raw = rows
            # bytes + values bytes; rows are LOCAL to this shard
            rh, vh = msg["rows"], msg["array"]
            nrows_bytes = int(np.dtype(rh["dtype"]).itemsize
                              * int(np.prod(rh["shape"])))
            rows = np.frombuffer(raw[:nrows_bytes],
                                 dtype=rh["dtype"]).reshape(-1)
            vals = _array_from(vh, raw[nrows_bytes:])
            with self._lock:
                pname = msg.get("param", "")
                tbl = self._executor._read_var(self._scope, pname)
                height = (int(tbl.shape[0]) if tbl is not None
                          else int(rows.max()) + 1)
                self._executor._write_var(
                    self._scope, msg["name"],
                    selected_rows(self._executor, rows, vals, height))
                sub = self._grad_to_block.get(msg["name"])
                t_blk = time.monotonic()
                if sub is not None:
                    self._executor.run_block(sub, self._scope)
                if pname:
                    _histogram("ps.apply_ms", shard=self._shard,
                               table=pname).observe(
                        (time.monotonic() - t_blk) * 1e3)
                    _gauge("ps.table_rows", shard=self._shard,
                           table=pname).set(int(msg.get("gh") or height))
            return {"ok": True}, b""
        if kind == "checkpoint":
            # checkpoint_notify: snapshot every servable var
            with self._lock:
                snapshot_scope_to_dir(self._executor, self._scope,
                                      msg.get("dir", ""))
            return {"ok": True}, b""
        if kind == "heartbeat":
            with self._lock:
                evicted = sorted(self._evicted)
                eff = self._effective_fanin()
            return {"ok": True,
                    "status": {str(k): v
                               for k, v in
                               self.monitor.status().items()},
                    "evicted": evicted,
                    "fanin": self._fanin,
                    "effective_fanin": eff,
                    "active": True,
                    "round": self._applied_round,
                    "evictions": _counter("ps.evictions").value,
                    "readmissions": _counter("ps.readmissions").value,
                    "promotions": _counter("ps.promotions").value,
                    "shard_map": {"version": 0, "overrides": {}},
                    }, b""
        if kind == "shutdown":
            self._shutdown.set()
            with self._lock:
                self._cond.notify_all()
            return {"ok": True}, b""
        return {"ok": False, "error": "unknown kind %r" % kind}, b""

    def _traced_handle(self, msg: dict, raw: bytes):
        """Flight-record the rpc token and run the handler under the
        client's propagated trace context, when the header carries one."""
        kind = msg.get("kind", "?")
        if kind not in _FLIGHT_QUIET:
            _flight.record("ps.rpc", kind=kind, cid=msg.get("cid"),
                           seq=msg.get("seq"), round=msg.get("round"),
                           fo=msg.get("fo"))
        tid, pspan = _dtrace.extract(msg)
        if tid is None:
            return self._handle(msg, raw)
        with _dtrace.child_span("rpc.server." + kind, trace_id=tid,
                                parent_span=pspan, cid=msg.get("cid"),
                                seq=msg.get("seq")):
            return self._handle(msg, raw)

    # -- socket plumbing --------------------------------------------------

    def _dispatch(self, msg: dict, raw: bytes):
        """Dedupe and handle one request. A resend arriving after the
        original completed gets the cached response; one arriving while
        the original still runs (blocked in a barrier) waits for it; a
        resend older than the client's latest request gets a stale
        marker and never runs again."""
        seq = msg.get("seq") if isinstance(msg, dict) else None
        cid = msg.get("cid") if isinstance(msg, dict) else None
        if seq is None or cid is None:
            return self._traced_handle(msg, raw)
        key = (msg.get("round", 0), seq)
        with self._dedupe_lock:
            cached = self._dedupe.get(cid)
            if cached is not None and cached[0] == key:
                ev = cached[1]
            elif seq <= self._last_seq.get(cid, 0):
                return {"ok": False, "stale": True,
                        "error": "stale duplicate (seq %s <= %s)"
                        % (seq, self._last_seq.get(cid, 0))}, b""
            else:
                # dict insertion order doubles as the LRU order
                prev_seq = int(self._last_seq.pop(cid, 0))
                self._last_seq[cid] = int(seq)
                ev = threading.Event()
                self._dedupe[cid] = [key, ev, None, b"", time.time()]
                if len(self._dedupe) > self._DEDUPE_CAP:
                    self._prune_dedupe_locked()
                cached = None
        if cached is not None:  # duplicate: the original owns the handler
            if not ev.wait(timeout=_ROUND_TIMEOUT):
                return {"ok": False,
                        "error": "duplicate request (cid %s seq %s) "
                        "still in flight" % (cid, seq)}, b""
            with self._dedupe_lock:
                c2 = self._dedupe.get(cid)
            if c2 is not None and c2[0] == key:
                return c2[2], c2[3]
            return {"ok": False, "stale": True,
                    "error": "dedupe entry superseded"}, b""
        try:
            resp, rraw = self._traced_handle(msg, raw)
        except Exception as e:
            resp, rraw = {"ok": False, "error": "%s: %s"
                          % (type(e).__name__, e)}, b""
        if isinstance(resp, dict) and resp.get("not_primary"):
            # a refusal is not an execution: un-record the token so a
            # retry runs the handler once
            with self._dedupe_lock:
                ent = self._dedupe.get(cid)
                if ent is not None and ent[0] == key:
                    del self._dedupe[cid]
                if self._last_seq.get(cid) == int(seq):
                    if prev_seq:
                        self._last_seq[cid] = prev_seq
                    else:
                        self._last_seq.pop(cid, None)
            ev.set()
            return resp, rraw
        with self._dedupe_lock:
            ent = self._dedupe.get(cid)
            if ent is not None and ent[0] == key:
                ent[2], ent[3], ent[4] = resp, rraw, time.time()
        ev.set()
        return resp, rraw

    def _prune_dedupe_locked(self):
        """Cap the per-client caches: drop the least recently used
        completed responses; keep the small ``_last_seq`` watermark far
        longer, so a stale duplicate of a live client never runs twice."""
        done = sorted(
            (cid for cid, e in self._dedupe.items() if e[1].is_set()),
            key=lambda c: self._dedupe[c][4])
        for cid in done[:max(0, len(self._dedupe) - self._DEDUPE_CAP)]:
            del self._dedupe[cid]
        while len(self._last_seq) > 16 * self._DEDUPE_CAP:
            self._last_seq.pop(next(iter(self._last_seq)))

    def _serve_conn(self, conn: socket.socket):
        with self._conn_lock:
            self._conns.add(conn)
        try:
            while not self._shutdown.is_set():
                got = _recv_msg(conn)
                if got is None:
                    return
                msg, raw = got
                # any handler error (a malformed message, a bad dtype)
                # gets a reply: a dead thread would leave the client
                # blocked until its own deadline
                try:
                    resp, rraw = self._dispatch(msg, raw)
                except Exception as e:
                    resp, rraw = {"ok": False, "error": "%s: %s"
                                  % (type(e).__name__, e)}, b""
                if isinstance(msg, dict) and msg.get("seq") is not None:
                    # echo the token: the client matches replies by seq
                    resp.setdefault("seq", msg.get("seq"))
                    resp.setdefault("cid", msg.get("cid"))
                if self._evict_after > 0:
                    # clients of an eviction-armed server heartbeat while
                    # blocked in a barrier: they arm off this field
                    resp.setdefault("evict_after", self._evict_after)
                _send_msg(conn, resp, rraw)
        except OSError:
            pass
        finally:
            with self._conn_lock:
                self._conns.discard(conn)
            conn.close()

    def serve_forever(self) -> None:
        """Accept loop; returns after a shutdown message (the reference
        blocks inside the listen_and_serv op the same way)."""
        try:
            self._sock.settimeout(0.2)
        except OSError:
            return  # stop() closed the socket before the loop began
        try:
            while not self._shutdown.is_set():
                try:
                    conn, _ = self._sock.accept()
                except socket.timeout:
                    continue
                except OSError:
                    break  # the listening socket was closed by stop()
                t = threading.Thread(target=self._serve_conn,
                                     args=(conn,), daemon=True)
                t.start()
                if len(self._threads) > 64:
                    self._threads = [x for x in self._threads
                                     if x.is_alive()]
                self._threads.append(t)
        finally:
            try:
                self._sock.close()
            except OSError:
                pass

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever,
                             name="ps-accept", daemon=True)
        t.start()
        self._threads.append(t)
        return t

    def stop(self, join_timeout: float = 5.0) -> None:
        """Tear the server down now: wake blocked rounds, close the
        listening socket, sever live connections, join the threads.
        Idempotent; safe from any thread."""
        self._shutdown.set()
        with self._lock:
            self._cond.notify_all()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._conn_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        me = threading.current_thread()
        deadline = time.time() + join_timeout
        for t in list(self._threads):
            if t is me or not t.is_alive():
                continue
            t.join(timeout=max(0.0, deadline - time.time()))


class _RetryableRPC(Exception):
    """Transport-level failure worth a reconnect-and-reissue."""


class _RPCTimeout(_RetryableRPC):
    pass


class _RPCConnLost(_RetryableRPC):
    pass


class PSClient:
    """One persistent connection a (endpoint, trainer). Every call
    retries with bounded exponential backoff and jitter on a timeout, EOF
    or lost connection (``PADDLE_PS_RPC_RETRIES``, default 3); the
    ``(cid, round, seq)`` token makes the resend of a send_grad or a
    barrier safe. A comma-separated endpoint list (a primary and its
    backups, for failover) raises ``NotImplementedError``."""

    _clients: Dict[tuple, "PSClient"] = {}
    _lock = threading.Lock()

    def __init__(self, endpoint: str, trainer_id: Optional[int] = 0,
                 timeout: Optional[float] = None,
                 auto_heartbeat: bool = True,
                 rpc_deadline: Optional[float] = None,
                 max_retries: Optional[int] = None):
        eps = [e.strip() for e in str(endpoint).split(",") if e.strip()]
        if not eps:
            raise ValueError("PSClient needs at least one endpoint")
        if len(eps) > 1:
            _refuse("failover over a primary and its backups (%s)"
                    % ",".join(eps))
        self._endpoint = eps[0]
        self._trainer_id = trainer_id
        self._auto_heartbeat = bool(auto_heartbeat)
        self._timeout = timeout if timeout is not None else float(
            os.environ.get("PADDLE_PS_CONNECT_TIMEOUT", "15"))
        # the per-attempt read deadline exceeds the server's round
        # bound, so only a dead or hung server trips it
        self._rpc_deadline = rpc_deadline if rpc_deadline is not None \
            else float(os.environ.get("PADDLE_PS_RPC_DEADLINE",
                                      str(_ROUND_TIMEOUT + 30.0)))
        self._max_retries = max_retries if max_retries is not None \
            else int(os.environ.get("PADDLE_PS_RPC_RETRIES", "3"))
        self._backoff_base = float(
            os.environ.get("PADDLE_PS_RPC_BACKOFF_MS", "50")) / 1e3
        self._backoff_cap = float(
            os.environ.get("PADDLE_PS_RPC_BACKOFF_CAP_MS", "2000")) / 1e3
        self._io_lock = threading.Lock()
        self._seq = 0
        self._round = 0  # completed send_barriers (the token's round)
        self._cid = os.urandom(8).hex()
        self._trace_ctx = None
        self._trace_round = -1
        self._jitter = random.Random(int.from_bytes(os.urandom(4),
                                                    "little"))
        self._hb_thread: Optional[threading.Thread] = None
        self._hb_stop = threading.Event()
        self.evicted_peers: set = set()
        # raw bytes this client sent and received (headers included)
        self.bytes_sent = 0
        self.bytes_recv = 0
        self._sock = self._connect()

    @property
    def endpoint(self) -> str:
        return self._endpoint

    def _connect(self, timeout: Optional[float] = None) -> socket.socket:
        host, port = self._endpoint.rsplit(":", 1)
        if timeout is None:
            timeout = self._timeout
        deadline = time.time() + timeout
        last: Optional[OSError] = None
        while True:  # the pserver process may still be booting
            try:
                sock = socket.create_connection(
                    (host or "127.0.0.1", int(port)),
                    timeout=max(timeout, 1.0))
                sock.settimeout(self._rpc_deadline)
                return sock
            except OSError as e:
                last = e
                if time.time() > deadline:
                    raise RuntimeError(
                        "cannot reach pserver %s within %.0fs (%r) — is "
                        "the pserver program (listen_and_serv) running, "
                        "with PADDLE_PSERVER_RPC=1 for cross-process "
                        "mode?" % (self._endpoint, timeout, last))
                time.sleep(0.2)

    @classmethod
    def for_endpoint(cls, endpoint: str, trainer_id: int = 0):
        with cls._lock:
            key = (endpoint, trainer_id)
            c = cls._clients.get(key)
            if c is None:
                c = cls(endpoint, trainer_id)
                cls._clients[key] = c
                hb_ms = os.environ.get("PADDLE_PS_HEARTBEAT_MS")
                if hb_ms:
                    c.start_heartbeat(float(hb_ms) / 1e3)
            return c

    @classmethod
    def reset(cls):
        with cls._lock:
            for c in cls._clients.values():
                c.close()
            cls._clients.clear()

    @classmethod
    def traffic(cls) -> Dict[str, int]:
        """Bytes sent and received by the cached clients of this process."""
        with cls._lock:
            return {"sent": sum(c.bytes_sent for c in cls._clients.values()),
                    "recv": sum(c.bytes_recv
                                for c in cls._clients.values())}

    def close(self) -> None:
        self.stop_heartbeat()
        self._drop_sock()

    # -- background heartbeat ---------------------------------------------

    def start_heartbeat(self, interval_s: float = 1.0) -> None:
        """Ping the server every ``interval_s`` from a connection of its
        own, keeping this trainer alive in the server's monitor while the
        main connection blocks in a barrier; peers the server evicted
        land in ``evicted_peers``."""
        if self._hb_thread is not None and self._hb_thread.is_alive():
            return
        self._hb_stop.clear()

        def loop():
            hb = None
            while not self._hb_stop.wait(interval_s):
                try:
                    if hb is None:
                        hb = PSClient(self._endpoint,
                                      trainer_id=self._trainer_id,
                                      auto_heartbeat=False)
                    resp = hb.heartbeat_full()
                    evicted = {int(t) for t in resp.get("evicted", [])}
                    new = evicted - self.evicted_peers
                    self.evicted_peers |= evicted
                    for t in sorted(new):
                        print("[ps_rpc] pserver %s evicted trainer %d; "
                              "continuing with effective fanin %s"
                              % (self._endpoint, t,
                                 resp.get("effective_fanin")),
                              file=sys.stderr, flush=True)
                except Exception:
                    # best effort: a failed ping never kills the trainer
                    if hb is not None:
                        hb.close()
                    hb = None
            if hb is not None:
                hb.close()

        self._hb_thread = threading.Thread(
            target=loop, name="ps-heartbeat-%s" % self._trainer_id,
            daemon=True)
        self._hb_thread.start()

    def stop_heartbeat(self) -> None:
        self._hb_stop.set()

    # -- request path -----------------------------------------------------

    def _attempt(self, msg: dict, raw: bytes):
        """One send and seq-matched receive on the cached socket; raises
        a ``_RetryableRPC`` on a timeout, EOF or lost connection after
        dropping the socket (it may hold a late reply)."""
        if self._sock is None:
            self._sock = self._connect()
        kind = msg.get("kind", "?")
        quiet = kind in _FLIGHT_QUIET
        t0 = time.perf_counter()
        if not quiet:
            _flight.record("rpc.send", kind=kind, seq=msg.get("seq"),
                           cid=msg.get("cid"), round=msg.get("round"),
                           ep=self._endpoint)
        deadline = time.time() + self._rpc_deadline
        try:
            _send_msg(self._sock, msg, raw)
            self.bytes_sent += 16 + len(raw) + len(json.dumps(msg))
            while True:
                remaining = deadline - time.time()
                if remaining <= 0:
                    raise socket.timeout("rpc deadline")
                self._sock.settimeout(remaining)
                got = _recv_msg(self._sock)
                if got is None:
                    raise _RPCConnLost(
                        "pserver %s closed the connection"
                        % self._endpoint)
                resp, resp_raw = got
                self.bytes_recv += 16 + len(resp_raw) + len(
                    json.dumps(resp))
                rseq = resp.get("seq") if isinstance(resp, dict) else None
                if rseq is not None and rseq != msg["seq"]:
                    continue  # a stale reply of a duplicated frame
                _histogram("rpc.latency_ms", method=kind).observe(
                    (time.perf_counter() - t0) * 1e3)
                if msg.get("trace_id"):
                    _dtrace.record_span(
                        "rpc.client." + kind, t0, cat="rpc",
                        trace_id=msg["trace_id"],
                        parent_span=msg.get("parent_span"),
                        endpoint=self._endpoint, seq=msg.get("seq"))
                if not quiet:
                    _flight.record("rpc.recv", kind=kind,
                                   seq=msg.get("seq"),
                                   ok=bool(resp.get("ok"))
                                   if isinstance(resp, dict) else None)
                return resp, resp_raw
        except socket.timeout:
            self._drop_sock()
            _counter("rpc.timeouts", method=kind).inc()
            if not quiet:
                _flight.record("rpc.timeout", kind=kind,
                               seq=msg.get("seq"), ep=self._endpoint)
            raise _RPCTimeout(
                "pserver %s did not reply within the %.0fs RPC deadline "
                "(kind=%s)" % (self._endpoint, self._rpc_deadline,
                               msg.get("kind"))) from None
        except _RPCConnLost:
            self._drop_sock()
            if not quiet:
                _flight.record("rpc.conn_lost", kind=kind,
                               seq=msg.get("seq"), ep=self._endpoint)
            raise
        except OSError as e:
            self._drop_sock()
            if not quiet:
                _flight.record("rpc.conn_lost", kind=kind,
                               seq=msg.get("seq"), ep=self._endpoint)
            raise _RPCConnLost("pserver %s connection failed: %s"
                               % (self._endpoint, e)) from e

    def _drop_sock(self) -> None:
        try:
            if self._sock is not None:
                self._sock.close()
        except OSError:
            pass
        self._sock = None

    def _stamp_trace(self, msg: dict) -> None:
        """Propagate the trace context on the rpc header: an ambient
        context wins, else one trace a sync round. A no-op while spans
        are disarmed."""
        from ..observability import tracing as _tracing

        if not _tracing.active():
            return
        ctx = _dtrace.current()
        if ctx is None:
            if self._trace_ctx is None \
                    or self._trace_round != self._round:
                self._trace_ctx = _dtrace.TraceContext.new()
                self._trace_round = self._round
            ctx = self._trace_ctx
        _dtrace.inject(msg, ctx)

    def _call(self, msg: dict, raw: bytes = b""):
        if self._trainer_id is not None:
            msg.setdefault("trainer_id", self._trainer_id)
        with self._io_lock:
            self._seq += 1
            msg["seq"] = self._seq
            msg["cid"] = self._cid
            msg["round"] = self._round
            msg["fo"] = 0
            self._stamp_trace(msg)
            resp, resp_raw = self._issue(msg, raw)
        ea = resp.get("evict_after") if isinstance(resp, dict) else None
        if ea and self._auto_heartbeat and (
                self._hb_thread is None or not self._hb_thread.is_alive()):
            # the server evicts silent trainers: keep this one alive
            # while its main socket blocks in a barrier
            self.start_heartbeat(max(0.05, float(ea) / 4.0))
        if not resp.get("ok"):
            raise RuntimeError("pserver error: %s" % resp.get("error"))
        return resp, resp_raw

    def _issue(self, msg: dict, raw: bytes):
        """Bounded retry on the endpoint (io-locked by caller)."""
        kind = msg.get("kind", "?")
        attempts = 0
        delay = self._backoff_base
        while True:
            try:
                return self._attempt(msg, raw)
            except _RetryableRPC as e:
                attempts += 1
                if attempts > self._max_retries:
                    raise RuntimeError(
                        "%s — gave up after %d attempt(s); the server is "
                        "dead or hung (raise PADDLE_PS_RPC_DEADLINE / "
                        "PADDLE_PS_RPC_RETRIES if rounds legitimately "
                        "run longer)" % (e, attempts)) from e
                _counter("rpc.retries", method=kind).inc()
                time.sleep(delay * (0.5 + self._jitter.random()))
                delay = min(delay * 2.0, self._backoff_cap)

    def send_grad(self, name: str, value, round: Optional[int] = None
                  ) -> None:
        """``round`` (optional) is the training round this grad belongs
        to (``tr`` on the wire): a server that already applied it drops
        the re-send."""
        arr = np.ascontiguousarray(host_array(value))
        msg = {"kind": "send_grad", "name": name,
               "array": _array_header(arr)}
        if round is not None:
            msg["tr"] = int(round)
        self._call(msg, arr.tobytes())

    def send_barrier(self, round: Optional[int] = None) -> None:
        self.barrier_prepare(round=round)
        self._round += 1

    def barrier_prepare(self, round: Optional[int] = None) -> dict:
        """Phase 1 of the sharded client's two-phase round barrier: the
        barrier rpc alone (``barrier_commit`` advances the round)."""
        msg = {"kind": "send_barrier"}
        if round is not None:
            msg["tr"] = int(round)
        resp, _ = self._call(msg)
        return resp

    def barrier_commit(self) -> None:
        """Phase 2: every shard acked its barrier; advance the round."""
        self._round += 1

    def get_param(self, name: str) -> np.ndarray:
        resp, raw = self._call({"kind": "get_param", "name": name})
        return _array_from(resp["array"], raw)

    def fetch_barrier(self) -> None:
        self._call({"kind": "fetch_barrier"})

    def pull_sparse(self, name: str, row_ids) -> np.ndarray:
        """Value rows for LOCAL row ids of this server's table slice."""
        ids = np.ascontiguousarray(np.asarray(row_ids, dtype=np.int64))
        resp, raw = self._call({"kind": "pull_sparse", "name": name,
                                "array": _array_header(ids)},
                               ids.tobytes())
        return _array_from(resp["array"], raw)

    def push_sparse(self, name: str, rows, values, param: str = "",
                    global_height: Optional[int] = None) -> None:
        """Push (local row ids, grad rows) to this server's slice; the
        server runs its optimize block at once. ``param`` names the table
        var (the SelectedRows height); ``global_height`` is the whole
        table's, for the server's ``ps.table_rows`` gauge."""
        rows = np.ascontiguousarray(np.asarray(rows, dtype=np.int64))
        vals = np.ascontiguousarray(host_array(values))
        msg = {"kind": "push_sparse", "name": name,
               "param": param,
               "rows": _array_header(rows),
               "array": _array_header(vals)}
        if global_height:
            msg["gh"] = int(global_height)
        self._call(msg, rows.tobytes() + vals.tobytes())

    def checkpoint(self, dirname: str) -> None:
        """Ask the server to snapshot its vars (checkpoint_notify)."""
        self._call({"kind": "checkpoint", "dir": dirname})

    def heartbeat(self) -> Dict[int, float]:
        resp, _ = self._call({"kind": "heartbeat"})
        return {int(k): v for k, v in resp["status"].items()}

    def heartbeat_full(self) -> dict:
        """The whole heartbeat response: per-trainer ages plus
        ``evicted`` / ``fanin`` / ``effective_fanin``."""
        resp, _ = self._call({"kind": "heartbeat"})
        return resp

    def shutdown_server(self) -> None:
        self._call({"kind": "shutdown"})

    # -- the survivability half: refused by name --------------------------

    def seed_round(self, n: int) -> None:
        _refuse("durable rounds and the cold restart (seed_round)")

    def replicate(self, *args, **kw) -> dict:
        _refuse("replication to backups (replicate)")

    def repl_status(self) -> dict:
        _refuse("replication to backups (repl_status)")

    def migrate(self, *args, **kw) -> dict:
        _refuse("live migration (migrate)")

    def migrate_range(self, *args, **kw) -> dict:
        _refuse("range migration (migrate_range)")


def PSWitness(*args, **kw):
    """The external quorum witness: not ported yet."""
    _refuse("PSWitness")
