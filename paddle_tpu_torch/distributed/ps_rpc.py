"""Socket RPC for the parameter server.

The port of ``paddle_tpu/distributed/ps_rpc.py``. The wire is the JAX
package's, frame for frame, and every kind below answers a client or a
peer of either package.

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

Fault tolerance: every frame passes through ``fault.py``'s injector;
the client retries each rpc with bounded exponential backoff after a
timeout, EOF or lost connection, with a ``(cid, round, seq)`` token the
server executes once; a server armed with ``evict_after`` evicts a
trainer whose heartbeats stop, shrinking the fanin, and re-admits it
when it trains again. A training round (``tr``) the server already
applied answers ``stale_round`` (``ps.stale_rounds``).

Survivability:

- **replication**: ``PADDLE_PSERVER_ENDPOINTS`` names a primary and its
  backups. The primary streams every applied round to each live backup
  and waits for the acks before the round reads as complete. A round
  ships a delta of what changed (row slices of ``push_sparse`` tables,
  flat chunk slices of dense vars, by chunk digests of
  ``PADDLE_PS_DIGEST_CHUNK_MB``, re-hashing only what was dirtied under
  ``PADDLE_PS_INCR_DIGEST``), with a full anchor every
  ``PADDLE_PS_ANCHOR_EVERY`` rounds; a backup without the delta's base
  answers ``repl_gap`` and is re-anchored. Counters
  ``ps.replication_bytes{mode=}``, ``ps.delta_rounds``,
  ``ps.anchor_rounds``, ``ps.replication_lag_rounds{backup=}``. An async
  primary ships a synthetic round every ``PADDLE_PS_ASYNC_REPL_EVERY``
  ops and tags each ack with ``pending_round`` / ``durable_round``.
- **failover**: ``PSClient`` takes a comma-separated chain. When its
  retries on an endpoint are spent by transport failures, or the
  endpoint answers ``not_primary``, it moves on, replays its log of
  non-idempotent rpcs with their original tokens (the replicated
  watermark makes a replay of a folded rpc a no-op) and reissues the
  rpc it was in. ``ps.failovers{cause=}``, ``ps.promotions``.
- **leases and the quorum**: the primary renews a lease with its group
  (and the ``PSWitness`` endpoints of ``PADDLE_PS_WITNESSES``) every
  ``PADDLE_PS_LEASE_MS``/3; a backup promotes only when its lease view
  expired, a majority of the group granted its epoch (a refused connect
  counts as a tombstone, a timeout as nothing) and, with witnesses, one
  witness granted. Epochs fence a stale primary; a primary of a group of
  3 or more that cannot renew with a majority for a lease steps down.
  Every lease deadline and election timer reads ``fault.clock_skew()``.
  ``PADDLE_PS_LEASE_MS=0`` is the instant promotion by a failed-over
  client.
- **rejoin**: a relaunched server (``PADDLE_PS_REJOIN=1``) catches up
  from the active server's snapshot (``join_backup``) before it serves
  as a backup (``ps.catchup_ms``).
- **durable rounds**: with ``durable_dir`` the primary writes each
  round's replication frame to a ``checkpoint.RoundStore`` before the
  barrier reply, and logs each async op; ``PADDLE_PS_RESTORE=1`` (and
  ``PADDLE_PS_RESTORE_ROUND``, the job's cut) restores from it at boot.
- **migrations**: ``migrate`` moves a dense var, ``migrate_range`` a
  row range of a sparse table, to another shard group inside a round
  apply (install, soft commit, replicate, commit); trainers adopt the
  bumped shard map at the barrier ack or through ``wrong_shard``
  redirects (``WrongShard``).

On the card a server's executor holds its state as CUDA tensors; every
array crossing the wire, the disk or a digest is copied between host and
device at ``host_array`` / ``device_tensor``, which count the copies
(``copy_counts``). Digests hash the host copy's little-endian
contiguous bytes, the bytes the JAX package hashes, so a primary of
either package plans the same deltas from the same state.
"""
from __future__ import annotations

import base64
import hashlib
import json
import os
import random
import signal
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

__all__ = ["PSServer", "PSClient", "PSWitness", "HeartBeatMonitor",
           "WrongShard", "snapshot_scope_to_dir", "copy_counts",
           "reset_copy_counts", "host_array", "device_tensor",
           "gather_rows", "write_array", "selected_rows"]

_ROUND_TIMEOUT = float(os.environ.get("PADDLE_PS_ROUND_TIMEOUT", "120"))

# kinds whose per-frame flight events would flood the bounded ring
# (a heartbeater ticks every few hundred ms for the whole job, lease
# renewals every lease/3) — they still get latency histograms and
# trace spans, just no black-box line
_FLIGHT_QUIET = ("heartbeat", "repl_status", "lease_renew")


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


# a raw section above this is sent after its header instead of copied
# into one frame with it (a replication round moves hundreds of MB)
_SPLIT_SEND_BYTES = 1 << 20


def _send_msg(sock: socket.socket, msg: dict,
              raw: bytes = b"") -> None:
    header = json.dumps(msg).encode("utf-8")
    head = (struct.pack("<Q", len(header)) + header
            + struct.pack("<Q", len(raw)))
    inj = _fault.get_injector()
    if inj is not None:
        inj.on_send(sock, head + raw)  # may drop/dup/sever per the plan
    elif len(raw) > _SPLIT_SEND_BYTES:
        sock.sendall(head)
        sock.sendall(raw)
    else:
        sock.sendall(head + raw)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytearray]:
    """``n`` bytes read into one buffer (no copy of what arrived)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], min(1 << 20, n - got))
        if not k:
            return None
        got += k
    return buf


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


# -- chunk-level digests ------
#
# A whole-var digest makes a GB embedding touched on ONE row ship the
# whole var whenever the touched-row set is unknown (promotion cleared
# it, a dense block updated it). Chunk digests bound that cost: every
# dense var is hashed as fixed-size chunks of its FLAT element stream
# (PADDLE_PS_DIGEST_CHUNK_MB, default 1 MiB; a var smaller than one
# chunk degenerates to the whole-var digest), a delta round ships only
# the chunks whose digest moved, and — with PADDLE_PS_INCR_DIGEST=1,
# the default — only the rows/chunks DIRTIED since the last ship are
# re-hashed at all. The soundness of the skip rests on knowing what a
# block wrote: a program block is asked (its ops' outputs,
# ``PSServer._block_writes``: a transpiled Fluid block names its Adam
# state ``w_moment1_0``, not ``w@...``), a callable block keeps the
# family contract (it touches only ``w`` and its ``@``-suffixed
# companions, as the pslib row-local sparse blocks do); every ANCHOR
# re-hashes everything from scratch, so a contract violation is bounded
# to at most anchor_every rounds and caught by the bit-for-bit drills.
# PADDLE_PS_INCR_DIGEST=0 restores hash-everything-every-round.


def _digest_chunk_bytes() -> int:
    return max(1, int(float(os.environ.get(
        "PADDLE_PS_DIGEST_CHUNK_MB", "1")) * (1 << 20)))


def _incr_digest_enabled() -> bool:
    return os.environ.get("PADDLE_PS_INCR_DIGEST", "1") != "0"


def _chunk_elems_for(arr: np.ndarray) -> int:
    itemsize = max(1, int(arr.dtype.itemsize))
    return max(1, _digest_chunk_bytes() // itemsize)


def _chunk_hash(flat: np.ndarray, ci: int, ce: int) -> str:
    """blake2b of one chunk's little-endian bytes (the JAX package's
    digest), hashed in place: ``flat`` is a contiguous view."""
    return hashlib.blake2b(np.ascontiguousarray(flat[ci * ce:(ci + 1) * ce]),
                           digest_size=16).hexdigest()


def _chunk_digests(flat: np.ndarray, ce: int) -> List[str]:
    n = max(1, -(-int(flat.size) // ce))  # >= 1 chunk even for empty
    return [_chunk_hash(flat, i, ce) for i in range(n)]


def _chunks_for_rows(rows, arr: np.ndarray, ce: int) -> set:
    """Chunk indices of the FLAT stream touched by the given row ids —
    a row whose byte range straddles a chunk boundary dirties BOTH
    chunks (the straddle edge case the tests pin)."""
    rowsize = int(np.prod(arr.shape[1:])) if arr.ndim > 1 else 1
    nchunks = max(1, -(-int(arr.size) // ce))
    out = set()
    for r in rows:
        lo = int(r) * rowsize
        hi = lo + rowsize - 1
        for ci in range(lo // ce, min(hi // ce, nchunks - 1) + 1):
            out.add(ci)
    return out


def _lease_deadline_in(lease_s: float) -> float:
    """A lease deadline ``lease_s`` from now on this process's lease
    clock: every lease and witness deadline is set through
    ``fault.clock_skew()``, so a ``clock_jitter`` drill skews them all."""
    return time.monotonic() + lease_s + _fault.clock_skew()


def _bare_rpc(endpoint: str, msg: dict, timeout: float = 1.0) -> dict:
    """One connect + frame exchange with none of PSClient's retry /
    dedup / failover machinery — the lease-and-vote control plane,
    where a failure IS the signal. ``ConnectionRefusedError``
    propagates distinctly: a refused connect means no listener owns
    the endpoint (positive evidence of process death on the drill
    topology, counted as a tombstone by elections), while a timeout —
    what a partition produces — is no evidence at all. Frames still
    route through the fault injector, so partitions drill this path
    too. Patchable by tests to simulate link states in-process."""
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
    """Serialize every tensor var in ``scope`` into ``dirname`` in the
    reference tensor-stream format (shared by the server-side
    'checkpoint' RPC kind and the emulated checkpoint_notify path).

    checkpoint_notify fans out over SEVERAL pservers that share one
    dir — each contributes its shard's vars concurrently — so the
    write is a MERGE: every file lands via tmp+fsync+rename (never a
    torn file) and the sha256 manifest is rewritten over the whole dir
    after this server's files. A whole-dir rename would let racing
    shards clobber each other. Scope of the guarantee: the manifest
    certifies integrity of the files PRESENT (no torn/corrupt file
    loads as garbage); whether every EXPECTED server contributed is
    the notifier's concern — it fans out the RPCs and sees each
    server's ack or error.

    ``names_map=True`` additionally writes ``__vars__.json``
    (file name -> original var name) so a DEDICATED snapshot — the
    ``join_backup`` catch-up path — can restore vars whose names were
    munged for the filesystem. Never set it for SHARED multi-server
    dirs: concurrent shards would clobber each other's map."""
    from ..checkpoint import SCOPE_VARS_NAME, atomic_write_bytes, \
        makedirs_durable, write_manifest
    from ..core import proto_format

    # durable mkdir: a fresh snapshot dir's dirent must
    # survive a host crash, not just process death
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
    """Per-trainer last-ping tracking (heart_beat_monitor.h:54)."""

    def __init__(self, stale_seconds: float = 60.0):
        self._last: Dict[int, float] = {}
        self._stale = stale_seconds
        self._lock = threading.Lock()

    def ping(self, trainer_id: int) -> None:
        with self._lock:
            self._last[int(trainer_id)] = time.time()

    def register(self, trainer_ids) -> None:
        """Start the staleness clock for expected trainers that have
        not pinged yet — a rank that dies BEFORE its first rpc must
        still become evictable, or survivors would wait out the full
        round timeout on a trainer the monitor never heard of."""
        now = time.time()
        with self._lock:
            for t in trainer_ids:
                self._last.setdefault(int(t), now)

    def forget(self, trainer_id: int) -> None:
        """Drop a trainer's entry (post-eviction: a stale entry would
        re-report the same trainer forever; re-admission re-pings)."""
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
    """Sync-mode PS endpoint implementing the RunSyncLoop round
    protocol; async mode applies each grad immediately (RunAsyncLoop).

    ``evict_after`` (seconds; env ``PADDLE_PS_EVICT_AFTER``, 0 =
    disabled) arms the heartbeat monitor: a trainer silent that long is
    evicted — its slot leaves the effective fanin so the surviving
    trainers' barriers complete, and the heartbeat response carries the
    eviction so survivors can log-and-continue.

    ``endpoints`` (env ``PADDLE_PSERVER_ENDPOINTS``) is the ordered
    primary + backups list this server belongs to; index 0 starts as
    the active primary, the rest as replication backups that refuse
    the trainer dataplane until a genuinely failed-over client
    promotes them. ``rejoin=True`` (env ``PADDLE_PS_REJOIN``, set by
    the launch supervisor on a server relaunch) starts the server as
    an un-caught-up backup that first pulls a manifest-verified
    snapshot from the active server."""

    _DEDUPE_CAP = 512  # distinct live client nonces remembered

    # rpcs that belong to trainers (gated on primary role); everything
    # else — heartbeat, replication, catch-up, shutdown — any role
    # answers
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
        host, port = endpoint.rsplit(":", 1)
        # endpoint-pair partition rules address server processes by
        # their advertised endpoint; first server in wins (one server
        # per process everywhere but in-process unit tests)
        if _fault.get_identity() is None:
            _fault.set_identity(endpoint)
        self._executor = executor
        self._scope = scope
        self._grad_to_block = grad_to_block
        self._fanin = max(int(fanin), 1)
        self._sync = bool(sync_mode)
        # -- replication topology -----------------------------------------
        if endpoints is None:
            endpoints = _endpoints_from_env()
        self._endpoints = [e.strip() for e in (endpoints or [])
                           if e.strip()]
        self._own_endpoint = endpoint
        try:
            self._index = self._endpoints.index(endpoint)
        except ValueError:
            self._index = 0
            self._endpoints = [endpoint]
        if rejoin is None:
            rejoin = os.environ.get("PADDLE_PS_REJOIN") == "1"
        self._rejoin = bool(rejoin)
        self._active = (self._index == 0 and not self._rejoin)
        self._promoted = False
        self._caught_up = not self._rejoin
        self._applied_round = 0
        # cid -> highest seq whose effect is folded into the replicated
        # state this server holds: a failover replay at-or-below it is
        # acknowledged without re-executing (exactly-once across the
        # promotion)
        self._repl_watermark: Dict[str, int] = {}
        # the watermark AS OF THE LAST APPLIED ROUND — the only thing
        # ever shipped to backups. The live ``_last_seq`` also covers
        # rpcs buffered in the CURRENT unapplied round (a join_backup
        # can land mid-round); shipping those would make a promoted
        # backup falsely skip their replay and lose the round.
        self._applied_watermark: Dict[str, int] = {}
        self._repl_clients: Dict[str, "PSClient"] = {}
        self._repl_dead: set = set()
        self._repl_deadline = float(
            os.environ.get("PADDLE_PS_REPL_DEADLINE", "10"))
        self._repl_connect = float(
            os.environ.get("PADDLE_PS_REPL_CONNECT_TIMEOUT", "3"))
        # -- delta replication -----------------------------
        # per-var digest STATE of what was last shipped to the stream
        # ({"chunks": [...], "chunk_elems":, "nelems":, "dtype":} —
        # chunk-level); empty => next ship is a full anchor
        # (fresh primary, fresh promotion)
        self._shipped_digests: Dict[str, dict] = {}
        # param var -> set of rows touched by push_sparse since the
        # last ship: lets a delta round ship row SLICES of a sparse
        # table (sound because pslib sparse optimize blocks are
        # row-local); a dense round touching the var's FAMILY
        # escalates it to _dirty_dense — full-var diff wins there
        self._dirty_rows: Dict[str, set] = {}
        # vars whose family a dense round touched since the last ship:
        # re-hashed fully at the next plan. Vars in NEITHER dirty set
        # skip hashing entirely under PADDLE_PS_INCR_DIGEST=1 (their
        # shipped digests carry over — the incremental-digest win)
        self._dirty_dense: set = set()
        self._incr_digest = _incr_digest_enabled()
        if anchor_every is None:
            anchor_every = int(os.environ.get("PADDLE_PS_ANCHOR_EVERY",
                                              "8"))
        self._anchor_every = int(anchor_every)
        self._async_ops = 0
        self._async_repl_every = int(
            os.environ.get("PADDLE_PS_ASYNC_REPL_EVERY", "32"))
        # highest round at least one backup has ACKED — what async
        # clients may prune their replay logs up to
        self._durable_round = 0
        # -- lease + quorum promotion ---------------------------
        if shard is None:
            shard = int(os.environ.get("PADDLE_PSERVER_SHARD", "0"))
        self._shard = str(int(shard))
        self._shard_index = int(shard)
        # -- external quorum witnesses -------------------------
        # extra vote/renewal endpoints OUTSIDE the replication group.
        # Witnesses are a pure SAFETY gate: they never join the quorum
        # arithmetic (a candidate + a witness must not be able to
        # out-vote a busy-but-alive primary whose handlers are briefly
        # starved — quorum stays group-only), but with witnesses
        # configured an election ADDITIONALLY needs at least one live
        # witness GRANT (positive evidence the primary stopped
        # renewing), closing the corner where N-1 forged
        # connection-REFUSALs alone could elect a backup under a live
        # primary. A REFUSED witness is itself a tombstone (a dead
        # witness must not freeze promotion forever); a TIMED-OUT one
        # keeps the requirement (a partition must not relax it).
        if witnesses is None:
            witnesses = [e.strip() for e in os.environ.get(
                "PADDLE_PS_WITNESSES", "").split(",") if e.strip()]
        self._witnesses = list(witnesses or [])
        # -- live shard migration ------------------------------
        # shard-map overrides this group knows about: var base name ->
        # {"shard": owner index, "version": map version, "committed":
        # bool, "to_endpoints": donor-side recipient chain}; version 0
        # = the pure hash map. Replicated to backups with every round.
        self._shard_map_version = 0
        self._map_overrides: Dict[str, dict] = {}
        # donor side: the migration requested but not yet executed
        # (runs at the next round apply, inside the barrier)
        self._pending_migration: Optional[dict] = None
        # recipient side: installed-but-uncommitted var blobs
        self._staged_in: Dict[str, dict] = {}
        # vars hard-committed AWAY from this group: masked from
        # replication/anchors (the scope copy may linger — routing
        # answers wrong_shard before scope is ever consulted)
        self._dropped: set = set()
        self._mig_clients: Dict[str, "PSClient"] = {}
        # -- row-range live migration --------------------------
        # per-table ROW-RANGE overrides: table base name -> list of
        # {"lo","hi" (GLOBAL row ids), "shard" (new owner),
        # "local_base" (recipient-LOCAL id of global lo), "version",
        # "committed"; donor side additionally "src_lo"/"src_hi" (the
        # donor-LOCAL window that moved) + "to_endpoints"}. Rides the
        # replication stream like _map_overrides.
        self._range_overrides: Dict[str, List[dict]] = {}
        # donor side: the row-range migration requested but not yet
        # executed (runs at the next round apply, inside the barrier)
        self._pending_range_migration: Optional[dict] = None
        # recipient side: installed-but-uncommitted row-range stages,
        # keyed by table name (a re-install replaces the orphan)
        self._staged_ranges: Dict[str, dict] = {}
        # grad name -> optimize block builder for vars migrating IN
        # (a migration ships state, never code; the factory rebuilds
        # the block from the shared program definition)
        self._block_factory = block_factory
        if lease_ms is None:
            lease_ms = float(os.environ.get("PADDLE_PS_LEASE_MS",
                                            "1500"))
        self._lease_s = float(lease_ms) / 1e3
        self._epoch = 0           # the epoch this server serves at
        self._seen_epoch = 0      # highest epoch heard from any primary
        self._promised_epoch = 0  # highest epoch this voter granted
        self._promised_to = None  # who holds that promise (votedFor)
        # boot grace: a backup must never elect before the primary had
        # one full lease to introduce itself (clock-jitter chaos skews
        # this view too, like every other lease read)
        self._lease_deadline = _lease_deadline_in(self._lease_s)
        self._lease_expired_counted = False
        self._last_majority_ack = time.monotonic()
        self._election_lock = threading.Lock()
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
        # var name -> {trainer_id: grad}: keyed (not appended) so a
        # relaunched trainer RE-SENDING the round it died in REPLACES
        # its dead incarnation's contribution instead of double
        # counting it, and summed in sorted-tid order so the applied
        # total is bit-deterministic regardless of arrival order
        self._pending: Dict[str, Dict[int, np.ndarray]] = {}
        self._send_barriers = 0
        self._fetch_barriers = 0
        self._round_complete = True   # params servable before round 1
        self._fetches_pending = False  # True between apply and last fetch
        # per-client (token, response) cache: the client resends after a
        # reconnect; without dedupe a response lost AFTER server-side
        # processing would double-apply a grad/barrier in the round.
        # Keyed by the client's random nonce (NOT trainer_id: the
        # background heartbeater is a second connection with the same
        # trainer_id, and sharing one slot would let its traffic evict
        # the main client's in-flight entry mid-retry).
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
        # -- whole-job durable rounds --------------------------
        # With a durable dir armed, the primary TEES every applied
        # round's replication frame to disk (same delta/anchor blobs
        # the backups get) so a CORRELATED loss — every member of the
        # group, or the whole job — can cold-restart from a
        # round-consistent cut. Restore runs here, before any serving
        # thread exists, when the launcher exported
        # PADDLE_PS_RESTORE=1 (never on a live-failover rejoin: the
        # replication stream outranks disk for a process that has a
        # living group to catch up from).
        if durable_dir is None:
            durable_dir = os.environ.get("PADDLE_PS_DURABLE_DIR") or None
        self._durable_store = None
        if durable_dir:
            from ..checkpoint import RoundStore

            self._durable_store = RoundStore(durable_dir,
                                             self._shard_index)
        self._restored_round = 0
        if (self._durable_store is not None and not self._rejoin
                and os.environ.get("PADDLE_PS_RESTORE") == "1"):
            self._restore_from_disk()
        if self._evict_after > 0:
            t = threading.Thread(target=self._evict_loop,
                                 name="ps-evict-monitor", daemon=True)
            t.start()
            self._threads.append(t)
        if self._rejoin:
            t = threading.Thread(target=self._catchup_loop,
                                 name="ps-catchup", daemon=True)
            t.start()
            self._threads.append(t)
        if len(self._endpoints) > 1 and self._lease_s > 0:
            t = threading.Thread(target=self._lease_loop,
                                 name="ps-lease", daemon=True)
            t.start()
            self._threads.append(t)

    # -- round protocol ---------------------------------------------------

    def _effective_fanin(self) -> int:
        return max(1, self._fanin - len(self._evicted))

    def _stale_train_round_locked(self, msg: dict) -> bool:
        """True when the rpc names a TRAINING round (``tr``, stamped
        by workers that track one) this server already applied — the
        re-send of a relaunched trainer re-running a round that
        sailed without it (eviction shrank the fanin, or its dead
        incarnation's barrier already closed it). Distinct from the
        ``(cid, round, seq)`` dedup token, which a fresh incarnation
        cannot reproduce."""
        tr = msg.get("tr")
        stale = tr is not None and int(tr) <= self._applied_round
        if stale:
            _counter("ps.stale_rounds").inc()
            _flight.record("ps.stale_round", kind=msg.get("kind"),
                           tr=int(tr), applied=self._applied_round,
                           trainer=msg.get("trainer_id"))
        return stale

    def _apply_round(self):
        """All trainers' grads in (locked by caller): sum per var, run
        its optimize block, replicate the applied round to every live
        backup (acks REQUIRED before the round reads as complete — a
        promoted backup must never be behind a state any trainer has
        observed), then open params for reading."""
        nxt = self._applied_round + 1
        # begin/applied flight pair: a primary SIGKILLed mid-apply
        # leaves "ps.round_apply" with no matching "ps.round_applied"
        # in its last periodic dump — the postmortem's smoking gun
        _flight.record("ps.round_apply", round=nxt,
                       vars=len(self._pending))
        t_apply = time.monotonic()
        with _dtrace.child_span("ps.apply_round", cat="ps", round=nxt):
            # a dense round touches, by the family-locality contract,
            # its grad's base var and every @-companion of it: mark
            # those FAMILIES dense-dirty (full re-hash + full-var /
            # chunk diff at the next ship) and escalate any row-slice
            # tracking they had — row tracking is only sound between
            # dense touches of that family
            self._mark_families_dirty_locked(list(self._pending))
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
                    # per-TABLE apply timing: the hot-shard steerer
                    # needs to name the hot table, not just the group
                    _histogram("ps.apply_ms", shard=self._shard,
                               table=name.split("@", 1)[0]).observe(
                        (time.monotonic() - t_blk) * 1e3)
            self._pending.clear()
            self._send_barriers = 0
            self._applied_round += 1
            # safe point for a watermark snapshot: every processed
            # send-kind seq is now folded into the scope (trainers
            # cannot have sent next-round traffic — their barriers
            # haven't returned yet)
            self._applied_watermark = self._watermark_locked()
            # live migration rides the same barrier: the range is
            # frozen HERE (no trainer can observe the round until the
            # install + the replication below both finished)
            self._step_migration_locked()
            self._step_range_migration_locked()
            self._replicate_locked()
            self._commit_migrations_locked()
        # per-shard apply timing (ROADMAP hot-shard detector input):
        # always-on like every ps.* family, labeled by shard so the
        # merged dump shows which shard's optimize blocks run hot —
        # the steering daemon's migration signal lands here first.
        # table="_round" is the whole-round series; real tables get
        # their own series at the block run / sparse push.
        _histogram("ps.apply_ms", shard=self._shard,
                   table="_round").observe(
            (time.monotonic() - t_apply) * 1e3)
        _flight.record("ps.round_applied", round=self._applied_round)
        self._round_complete = True
        self._fetches_pending = True
        self._cond.notify_all()

    def _family_index(self):
        """base name -> [scope vars in that family], one O(V) pass —
        the apply marks G families against it instead of scanning the
        scope per grad (O(V+G), not O(V*G), under the server lock)."""
        fams: Dict[str, list] = {}
        for vn in list(self._scope.local_var_names()):
            fams.setdefault(vn.split("@", 1)[0], []).append(vn)
        return fams

    def _block_writes(self, gname: str):
        """The vars ``gname``'s optimize block writes, when the block is a
        program block (its ops' outputs); None for a callable block, which
        keeps the family contract. A transpiled Fluid block breaks that
        contract: its optimizer state is named ``w_moment1_0``, not
        ``w@...``, so only the ops can say what a block touched."""
        ops = getattr(self._grad_to_block.get(gname), "ops", None)
        if ops is None:
            return None
        return {n for op in ops for n in op.output_arg_names}

    def _row_local(self, gname: str) -> bool:
        """Whether a sparse push through ``gname``'s block changes only the
        pushed rows: a callable block by the pslib contract, a program
        block only when every op is ``sgd`` (Fluid's Adam on a sparse
        grad densifies it and moves every row its moments hold)."""
        ops = getattr(self._grad_to_block.get(gname), "ops", None)
        return ops is None or all(op.type == "sgd" for op in ops)

    def _mark_families_dirty_locked(self, names) -> None:
        """A dense update ran these grads' blocks: every var a block wrote
        (a callable block: the base var and every ``@``-companion) must be
        re-hashed at the next ship, and any row-slice tracking for them is
        no longer sound."""
        fams = None
        for name in names:
            touched = self._block_writes(name)
            if touched is None:
                if fams is None:
                    fams = self._family_index()
                touched = fams.get(name.split("@", 1)[0], ())
            else:
                touched = touched | {name}
            for vn in touched:
                self._dirty_dense.add(vn)
                self._dirty_rows.pop(vn, None)

    def _family_names_locked(self, name: str) -> List[str]:
        """The vars that move with ``name`` in a migration: its
        ``@``-companions and, for a program block, every var its optimize
        block writes (a Fluid param's moments and beta powers)."""
        fam = list(self._family_index().get(name, [name]))
        here = set(self._scope.local_var_names())
        for vn in sorted(self._block_writes(name + "@GRAD") or ()):
            if vn not in fam and vn in here:
                fam.append(vn)
        return fam

    def _mark_pushed_rows_locked(self, gname: str, pname: str,
                                 rows) -> None:
        """A sparse push through ``gname``'s block: the pushed rows of
        ``pname`` when the block is row-local, else what the block wrote."""
        if self._row_local(gname):
            self._dirty_rows.setdefault(pname, set()).update(
                int(r) for r in rows)
        else:
            self._mark_families_dirty_locked([gname])

    # -- replication (primary -> backups) ---------------------------------

    def _repl_targets(self) -> List[str]:
        return [ep for ep in self._endpoints
                if ep != self._own_endpoint and ep not in self._repl_dead]

    def _repl_client(self, ep: str) -> "PSClient":
        c = self._repl_clients.get(ep)
        if c is None:
            c = PSClient(ep, trainer_id=None, auto_heartbeat=False,
                         timeout=self._repl_connect,
                         rpc_deadline=self._repl_deadline,
                         max_retries=int(os.environ.get(
                             "PADDLE_PS_REPL_RETRIES", "3")))
            self._repl_clients[ep] = c
        return c

    def _scope_arrays(self) -> List[tuple]:
        """[(name, contiguous array)] for every tensor var in scope —
        minus vars hard-committed away by a migration (their scope
        copy may linger; the stream must stop carrying them)."""
        out = []
        for name in list(self._scope.local_var_names()):
            if name in self._dropped:
                continue
            val = self._executor._read_var(self._scope, name)
            if val is None or not hasattr(val, "shape"):
                continue
            out.append((name, np.ascontiguousarray(host_array(val))))
        return out

    @staticmethod
    def _blobs_for(items) -> tuple:
        """(headers, raw) for [(name, array, extra-or-None)] — an
        ``extra`` of ``{"rows": [...]}`` is a row SLICE of the named
        table (local row ids), ``{"chunk": [start, stop]}`` a FLAT
        element range of it (chunk-digest delta); without either the
        array replaces the whole var."""
        headers, chunks = [], []
        for name, arr, extra in items:
            h = _array_header(arr)
            h["name"] = name
            if extra:
                h.update(extra)
            headers.append(h)
            # one copy, into the joined blob
            chunks.append(np.ascontiguousarray(arr).reshape(-1).view(
                np.uint8))
        return headers, b"".join(chunks)

    def _scope_blobs(self):
        """Full-blob (headers, raw) for every tensor var — the anchor
        payload and the ``repl_gap`` re-anchor fallback."""
        return self._blobs_for(
            [(n, a, None) for n, a in self._scope_arrays()])

    def _watermark_locked(self) -> Dict[str, int]:
        """Per-cid seq watermark covering every rpc folded into the
        state being replicated (own processed seqs plus any watermark
        this server itself inherited through a promotion)."""
        with self._dedupe_lock:
            wm = dict(self._last_seq)
        for cid, s in self._repl_watermark.items():
            if int(wm.get(cid, 0)) < int(s):
                wm[cid] = int(s)
        return wm

    def _replication_plan(self, arrays) -> tuple:
        """(mode, items, digests) for the round about to ship: a FULL
        anchor when nothing was ever shipped or the anchor interval
        divides the round (every var fully re-hashed — the digest
        state RESETS at anchors, bounding any incremental-skip drift);
        otherwise a DELTA of only the vars whose chunk digests moved —
        as row slices where push_sparse recorded which rows changed
        and the slice beats the var, as flat CHUNK slices where only
        some chunks of a big dense var moved, else whole vars. Under
        ``PADDLE_PS_INCR_DIGEST=1`` vars in neither dirty set skip
        hashing entirely and row-dirty tables re-hash only the touched
        chunks (``ps.digest_vars{mode=}`` counts both paths;
        ``ps.digest_ms`` accumulates the hashing bill)."""
        t0 = time.perf_counter()
        prev = self._shipped_digests
        anchor = (not prev
                  or (self._anchor_every > 0 and self._applied_round
                      % self._anchor_every == 0))
        incr = self._incr_digest and not anchor
        digests: Dict[str, dict] = {}
        items = []
        for n, a in arrays:
            flat = a.reshape(-1)
            ps = prev.get(n)
            ce = _chunk_elems_for(a)
            compat = (ps is not None
                      and ps.get("chunk_elems") == ce
                      and ps.get("nelems") == int(flat.size)
                      and ps.get("dtype") == str(a.dtype))
            touched = n in self._dirty_dense or n in self._dirty_rows
            if incr and compat and not touched:
                # untouched since the last ship: the shipped digests
                # carry over UNHASHED — the incremental-digest win
                digests[n] = ps
                _counter("ps.digest_vars", mode="skipped").inc()
                continue
            rows = self._dirty_rows.get(n)
            if (incr and compat and rows is not None
                    and n not in self._dirty_dense):
                # row-dirty only: re-hash just the chunks those rows
                # touch, carry the rest over
                chunks = list(ps["chunks"])
                for ci in sorted(_chunks_for_rows(rows, a, ce)):
                    chunks[ci] = _chunk_hash(flat, ci, ce)
                state = dict(ps)
                state["chunks"] = chunks
                _counter("ps.digest_vars", mode="rows").inc()
            else:
                state = {"chunks": _chunk_digests(flat, ce),
                         "chunk_elems": ce, "nelems": int(flat.size),
                         "dtype": str(a.dtype)}
                _counter("ps.digest_vars", mode="hashed").inc()
            digests[n] = state
            if anchor:
                continue  # the anchor ships every var below anyway
            if compat and ps["chunks"] == state["chunks"]:
                continue  # digest says unchanged
            if (rows and n not in self._dirty_dense
                    and getattr(a, "ndim", 0) >= 1
                    and len(rows) < int(a.shape[0])):
                # rows re-dirtied AFTER a dense touch in the same
                # window (e.g. a push right after a range-move zeroed
                # its slice) must not shrink the ship to the slice —
                # the dense change would silently never reach backups
                rs = np.asarray(sorted(rows), dtype=np.int64)
                items.append((n, np.ascontiguousarray(a[rs]),
                              {"rows": rs.tolist()}))
            elif compat and len(state["chunks"]) > 1:
                changed = [i for i, (x, y) in
                           enumerate(zip(ps["chunks"],
                                         state["chunks"])) if x != y]
                if not changed:
                    continue
                # contiguous runs of changed chunks -> flat slices
                runs = [[changed[0], changed[0]]]
                for ci in changed[1:]:
                    if ci == runs[-1][1] + 1:
                        runs[-1][1] = ci
                    else:
                        runs.append([ci, ci])
                for lo, hi in runs:
                    s, e = lo * ce, min((hi + 1) * ce, int(flat.size))
                    items.append((n, np.ascontiguousarray(flat[s:e]),
                                  {"chunk": [s, e]}))
            else:
                items.append((n, a, None))
        if anchor:
            items = [(n, a, None) for n, a in arrays]
        _counter("ps.digest_ms").inc(
            (time.perf_counter() - t0) * 1e3)
        return ("full" if anchor else "delta"), items, digests

    def _replicate_locked(self) -> None:
        """Stream the just-applied round to every live backup and wait
        for each ack (locked by caller — the round stays incomplete,
        and unfetchable, until the backups hold it). Ships a DELTA of
        what changed (full anchor every ``_anchor_every`` rounds); a
        backup answering ``repl_gap`` (freshly rejoined / behind the
        delta's base) is re-anchored with a full blob on the spot. A
        backup that fails the short replication deadline is dropped
        from the stream (its lag gauge freezes; a relaunch re-enters
        via join_backup); one that answers ``fenced`` outranks us — a
        higher-epoch primary exists — and this server demotes."""
        if not self._active_role():
            return
        targets = self._repl_targets()
        if not targets and self._durable_store is None:
            # no stream to diff against: keep dirty tracking bounded
            # and digests empty so a first backup gets a clean anchor
            self._dirty_rows.clear()
            self._dirty_dense.clear()
            return
        t_rep = time.monotonic()
        arrays = self._scope_arrays()
        mode, items, digests = self._replication_plan(arrays)
        headers, raw = self._blobs_for(items)
        full_cache = (headers, raw) if mode == "full" else None
        wm = self._applied_watermark
        base = self._applied_round - 1
        extra = self._repl_extra_locked()
        # durable tee BEFORE shipping: the frame must be on
        # disk before any barrier reply can make trainers observe the
        # round, so a whole-job kill always finds every shard's disk
        # at-or-past any round a trainer checkpointed. Same blobs as
        # the wire — per-round durable bytes ride the delta path.
        if self._durable_store is not None:
            self._persist_round_locked(mode, headers, raw, wm, base,
                                       extra)
        acked = 0
        for ep in targets:
            _gauge("ps.replication_lag_rounds", backup=ep).set(1)
            try:
                resp = self._repl_client(ep).replicate(
                    self._applied_round, headers, raw, wm, mode=mode,
                    base_round=base, epoch=self._epoch, extra=extra)
                if resp.get("fenced"):
                    self._demote_locked(int(resp.get("epoch", 0)),
                                        "fenced by %s during "
                                        "replication" % ep)
                    return
                if resp.get("repl_gap"):
                    if full_cache is None:
                        full_cache = self._blobs_for(
                            [(n, a, None) for n, a in arrays])
                    fh, fraw = full_cache
                    self._repl_client(ep).replicate(
                        self._applied_round, fh, fraw, wm,
                        mode="full", base_round=base,
                        epoch=self._epoch, extra=extra)
                    _counter("ps.replication_bytes",
                             mode="full").inc(len(fraw))
                    _flight.record("ps.reanchor", backup=ep,
                                   round=self._applied_round)
                else:
                    _counter("ps.replication_bytes",
                             mode=mode).inc(len(raw))
                _gauge("ps.replication_lag_rounds", backup=ep).set(0)
                acked += 1
            except (RuntimeError, OSError) as e:
                self._repl_dead.add(ep)
                _flight.record("ps.backup_dropped", backup=ep,
                               round=self._applied_round)
                try:
                    self._repl_clients.pop(ep).close()
                except (KeyError, OSError):
                    pass
                print("[ps_rpc] dropping backup %s from the replication"
                      " stream at round %d: %s"
                      % (ep, self._applied_round, e),
                      file=sys.stderr, flush=True)
        _counter("ps.anchor_rounds" if mode == "full"
                 else "ps.delta_rounds").inc()
        # the round's whole replication bill: plan (hashing), durable
        # write and the acked ships
        _histogram("ps.replicate_ms", mode=mode).observe(
            (time.monotonic() - t_rep) * 1e3)
        if acked:
            self._durable_round = self._applied_round
        self._shipped_digests = digests
        self._dirty_rows.clear()
        self._dirty_dense.clear()

    # -- whole-job durable rounds ------------------------------
    #
    # Live replication survives PARTIAL failures; these methods make
    # the group survive a CORRELATED one. Every applied round's
    # replication frame (headers + raw blob + watermark + shard-map /
    # migration extras + fencing epoch) is persisted atomically under
    # ``<durable_dir>/shard-<k>/round-<n>/`` by the active primary,
    # and a cold-booting server replays the newest anchor chain with
    # the SAME splice semantics a backup applies — so a restored shard
    # is bit-for-bit the state any trainer could have observed at that
    # round. The launcher computes the job-wide cut (the newest round
    # present on EVERY shard) and pins it via PADDLE_PS_RESTORE_ROUND;
    # a shard never restores past it, so a mixed cut cannot happen.

    def _persist_round_locked(self, mode, headers, raw, wm, base,
                              extra) -> None:
        """Tee the just-applied round's frame to disk (locked by
        caller, BEFORE the barrier reply). A persist failure is loud
        but non-fatal: the job keeps training on live replication and
        the operator sees ``ps.durable_errors`` grow."""
        t0 = time.monotonic()
        try:
            self._durable_store.put_round(
                self._applied_round, headers, raw, wm, mode=mode,
                base_round=(base if mode == "delta" else None),
                epoch=self._epoch, extra=extra)
            # ops folded into this frame are covered by it now
            self._durable_store.clear_ops_through(self._applied_round)
            _histogram("ps.durable_ms", mode=mode).observe(
                (time.monotonic() - t0) * 1e3)
        except OSError as e:
            _counter("ps.durable_errors").inc()
            print("[ps_rpc] durable persist of round %d failed: %s"
                  % (self._applied_round, e), file=sys.stderr,
                  flush=True)
            return
        # disk is at least as durable as a backup ack: async clients
        # may prune replay-log entries folded into this frame
        self._durable_round = self._applied_round
        _flight.record("ps.round_durable", round=self._applied_round,
                       mode=mode, shard=self._shard)

    def _restore_from_disk(self) -> None:
        """Cold-restart resume (boot-time, before any serving thread):
        load the target round's anchor chain, re-arm the fencing epoch
        PAST the dead incarnation so its stragglers are refused, and
        replay the async op tail exactly-once against the restored
        watermark. Every group member restores (a backup that booted
        at the cut applies the primary's next delta without a
        re-anchor); only the active primary bumps its serving epoch."""
        from ..checkpoint import CheckpointCorrupt

        store = self._durable_store
        rounds = store.restorable_rounds()
        if not rounds:
            return
        tgt_env = os.environ.get("PADDLE_PS_RESTORE_ROUND", "")
        target = int(tgt_env) if tgt_env else rounds[-1]
        if target not in set(rounds):
            eligible = [r for r in rounds if r <= target]
            if not eligible:
                raise CheckpointCorrupt(
                    "shard %s cannot reach the job restore cut %d: "
                    "restorable rounds are %s"
                    % (self._shard, target, rounds))
            target = eligible[-1]
        t0 = time.monotonic()
        with self._lock:
            store.load_round(target, self._apply_restore_frame)
            meta = store.meta(target) or {}
            stored_epoch = int(meta.get("epoch", 0))
            # fence out the DEAD incarnation: any straggler still
            # speaking its epoch is refused by every restored member
            self._seen_epoch = max(self._seen_epoch, stored_epoch + 1)
            if self._active:
                self._epoch = max(self._epoch, stored_epoch + 1)
            self._applied_round = target
            self._durable_round = target
            self._restored_round = target
            self._applied_watermark = dict(self._repl_watermark)
            self._caught_up = True
            self._round_complete = True
            replayed = 0
            for e in store.pending_ops(after_round=target):
                replayed += self._replay_logged_op_locked(e)
        ms = (time.monotonic() - t0) * 1e3
        _histogram("checkpoint.restore_ms").observe(ms)
        _flight.record("ps.restore", round=target,
                       epoch=stored_epoch + 1,
                       shard=self._shard_index,
                       ops_replayed=replayed, ms=ms)
        print("[ps_rpc] %s restored shard %s at round %d "
              "(epoch fence %d, %d async ops replayed, %.0fms)"
              % (self._own_endpoint, self._shard, target,
                 stored_epoch + 1, replayed, ms),
              file=sys.stderr, flush=True)

    def _apply_restore_frame(self, meta: dict, raw: bytes) -> None:
        """Apply one durable frame — the disk twin of the 'replicate'
        handler: splice row/chunk deltas (or whole vars) into scope
        and adopt the shard-map / migration state the frame carried."""
        self._splice_vars_locked(meta.get("vars", []), raw)
        ex = meta.get("repl_extra") or {}
        sm = ex.get("shard_map")
        if sm and int(sm.get("version", 0)) >= self._shard_map_version:
            self._shard_map_version = int(sm["version"])
        for n2, ov in (ex.get("map_overrides") or {}).items():
            cur = self._map_overrides.get(n2)
            if cur is None or int(cur.get("version", 0)) \
                    <= int(ov.get("version", 0)):
                self._map_overrides[n2] = dict(ov)
        for n2 in ex.get("dropped", []) or []:
            if n2 not in self._dropped:
                self._dropped.add(n2)
                try:
                    if hasattr(self._scope, "__delitem__") \
                            and n2 in self._scope.local_var_names():
                        del self._scope[n2]
                except (KeyError, TypeError):
                    pass
        pm = ex.get("pending_migration")
        # like the stream: the newest frame is the truth — an intent
        # that stopped riding it was executed or rolled back upstream
        self._pending_migration = dict(pm) if pm else None
        ro = ex.get("range_overrides")
        if ro:
            self._range_overrides = {
                t: [dict(r) for r in rs] for t, rs in ro.items()}
        prm = ex.get("pending_range_migration")
        self._pending_range_migration = dict(prm) if prm else None
        for cid, s in (meta.get("watermark") or {}).items():
            if int(self._repl_watermark.get(cid, 0)) < int(s):
                self._repl_watermark[cid] = int(s)

    def _splice_vars_locked(self, headers, raw) -> None:
        """Apply one replication frame's vars (the ``replicate`` kind and
        a durable frame alike): a row SLICE of a table (``rows``) or a
        FLAT element range of a var (``chunk``) is spliced into the
        resident copy, which is copied once a frame however many pieces
        of it the frame holds; any other var replaces the resident one."""
        view = memoryview(raw)
        work: Dict[str, np.ndarray] = {}
        off = 0
        for h in headers:
            n = int(np.dtype(h["dtype"]).itemsize
                    * int(np.prod(h["shape"]) if h["shape"] else 1))
            arr = _array_from(h, view[off:off + n])
            off += n
            name = h["name"]
            rows, chunk = h.get("rows"), h.get("chunk")
            if rows is None and chunk is None:
                work.pop(name, None)
                write_array(self._executor, self._scope, name, arr)
                continue
            tbl = work.get(name)
            if tbl is None:
                tbl = work[name] = np.array(self._read_host(name),
                                            copy=True)
            if rows is not None:
                tbl[np.asarray(rows, dtype=np.int64)] = arr
            else:
                tbl.reshape(-1)[int(chunk[0]):int(chunk[1])] = \
                    arr.reshape(-1)
        for name, tbl in work.items():
            write_array(self._executor, self._scope, name, tbl)

    def _log_async_op_locked(self, msg: dict, raw: bytes,
                             kind: str = "push_sparse") -> None:
        """Durably log one acked async op (geo/async mode): between
        synthetic-round frames the op exists ONLY in this process, so
        the ack must not outlive the bytes. The entry carries the op's
        dedup token and the round that will fold it; the tail is
        truncated when that frame lands and replayed — exactly-once
        against the frame watermark — on cold restart."""
        entry = {"round": self._applied_round + 1,
                 "kind": kind,
                 "cid": msg.get("cid"),
                 "seq": int(msg.get("seq") or 0),
                 "name": msg.get("name"),
                 "param": msg.get("param", ""),
                 "array": msg["array"],
                 "gh": msg.get("gh"),
                 "raw": base64.b64encode(raw).decode("ascii")}
        if kind == "push_sparse":
            entry["rows"] = msg["rows"]
        try:
            self._durable_store.append_op(entry)
        except OSError as e:
            _counter("ps.durable_errors").inc()
            print("[ps_rpc] async op-log append failed: %s" % e,
                  file=sys.stderr, flush=True)

    def _replay_logged_op_locked(self, e: dict) -> int:
        """Re-apply one logged async op at restore; returns 1 when
        applied, 0 when the restored frame watermark already covers
        its (cid, seq) — the op was folded into the frame (or a newer
        log entry superseded it) and re-applying would double-count."""
        cid = str(e.get("cid") or "")
        seq = int(e.get("seq") or 0)
        if cid and seq \
                and seq <= int(self._repl_watermark.get(cid, 0)):
            return 0
        raw = base64.b64decode(e.get("raw", ""))
        if e.get("kind") == "send_grad":
            # dense async grad: whole-var write + its optimize block
            arr = _array_from(e["array"], raw)
            write_array(self._executor, self._scope, e["name"], arr)
            sub = self._grad_to_block.get(e["name"])
            if sub is not None:
                self._executor.run_block(sub, self._scope)
            self._mark_families_dirty_locked([e["name"]])
        else:
            rh, vh = e["rows"], e["array"]
            nrows_bytes = int(np.dtype(rh["dtype"]).itemsize
                              * int(np.prod(rh["shape"])))
            rows = np.frombuffer(raw[:nrows_bytes],
                                 dtype=rh["dtype"]).reshape(-1)
            vals = _array_from(vh, raw[nrows_bytes:])
            pname = e.get("param", "")
            tbl = (self._executor._read_var(self._scope, pname)
                   if pname else None)
            height = (int(tbl.shape[0]) if tbl is not None
                      else int(rows.max()) + 1)
            self._executor._write_var(
                self._scope, e["name"],
                selected_rows(self._executor, rows, vals, height))
            sub = self._grad_to_block.get(e["name"])
            if sub is not None:
                self._executor.run_block(sub, self._scope)
            if pname:
                self._mark_pushed_rows_locked(e["name"], pname, rows)
        if cid and seq:
            if seq > int(self._repl_watermark.get(cid, 0)):
                self._repl_watermark[cid] = seq
            with self._dedupe_lock:
                if seq > int(self._last_seq.get(cid, 0)):
                    self._last_seq[cid] = seq
        self._async_ops += 1
        return 1

    # -- live shard migration ----------------------------------
    #
    # A key range (a dense var; its @-companions follow) moves from
    # this group (the DONOR) to another (the RECIPIENT) under the
    # two-phase round barrier, with zero lost or double-applied
    # rounds. The whole protocol runs inside ONE round apply, while
    # every trainer is still blocked in its round-N barrier rpc:
    #
    #   1. INSTALL — the donor freezes the var at the just-applied
    #      round and ships it (with its dedup watermark) to the
    #      recipient's active primary, which STAGES it (not servable).
    #   2. SOFT COMMIT — the donor bumps its shard-map version and
    #      records the override {var -> recipient shard}; the var
    #      STAYS in the donor's scope and replication stream until the
    #      recipient durably owns it.
    #   3. REPLICATE — the round ships to the donor's backups WITH the
    #      override (committed=False) + any pending intent, so a
    #      promoted donor backup either never heard of the migration
    #      (-> clean ROLLBACK: the map never bumped anywhere a trainer
    #      can see) or inherits the obligation to finish it.
    #   4. COMMIT — the recipient moves the staged var into its scope,
    #      rebuilds its optimize block via the block_factory, ships it
    #      to ITS backups, and acks; the donor then HARD-commits
    #      (drops the var from its stream, ships `dropped` next
    #      round). Re-sent every round until acked — idempotent.
    #
    # The epoch fence closes every kill window: a donor killed before
    # step 3 rolls back (its promoted backup holds the var, version
    # unbumped, the recipient's staged orphan is superseded by any
    # retry); a donor killed after step 3 completes via its promoted
    # backup re-driving step 4; a recipient killed mid-install fails
    # the install (donor retries next round, bounded, else rollback).
    # Trainers adopt the new map atomically at the round barrier
    # (responses carry it) or lazily via `wrong_shard` redirects whose
    # tokens are NEVER recorded as executed — replays with ORIGINAL
    # tokens stay exactly-once across the version bump because the
    # install carries the donor's folded-seq watermark.

    def _repl_extra_locked(self) -> dict:
        """Shard-map / migration fields riding every replicate rpc."""
        ex = {}
        if self._shard_map_version:
            ex["shard_map"] = self._shard_map_payload_locked()
            ex["map_overrides"] = {
                n: dict(ov) for n, ov in self._map_overrides.items()}
        if self._dropped:
            ex["dropped"] = sorted(self._dropped)
        if self._pending_migration is not None:
            pm = self._pending_migration
            ex["pending_migration"] = {
                "name": pm["name"], "to_shard": pm["to_shard"],
                "to_endpoints": pm["to_endpoints"]}
        if self._range_overrides:
            # full server-side dicts (src window + recipient chain
            # included): a promoted backup must be able to re-drive
            # an uncommitted range commit, or zero the right slice
            ex["range_overrides"] = {
                t: [dict(r) for r in rs]
                for t, rs in self._range_overrides.items()}
        if self._pending_range_migration is not None:
            pm = self._pending_range_migration
            ex["pending_range_migration"] = {
                "name": pm["name"], "lo": pm["lo"], "hi": pm["hi"],
                "src_lo": pm["src_lo"], "src_hi": pm["src_hi"],
                "to_shard": pm["to_shard"],
                "to_endpoints": pm["to_endpoints"]}
        return ex

    def _shard_map_payload_locked(self) -> dict:
        """The client-facing shard map: version + var -> shard ints,
        plus per-table row-range ownership as
        ``{table: [[global_lo, global_hi, shard, local_base], ...]}``."""
        payload = {"version": self._shard_map_version,
                   "overrides": {n: int(ov["shard"])
                                 for n, ov in self._map_overrides.items()}}
        if self._range_overrides:
            payload["ranges"] = {
                t: [[int(r["lo"]), int(r["hi"]), int(r["shard"]),
                     int(r["local_base"])] for r in rs]
                for t, rs in self._range_overrides.items()}
        return payload

    def _mig_client(self, chain: str) -> "PSClient":
        c = self._mig_clients.get(chain)
        if c is None:
            c = PSClient(chain, trainer_id=None, auto_heartbeat=False,
                         timeout=self._repl_connect,
                         rpc_deadline=self._repl_deadline,
                         max_retries=int(os.environ.get(
                             "PADDLE_PS_REPL_RETRIES", "3")))
            self._mig_clients[chain] = c
        return c

    def _step_migration_locked(self) -> None:
        """Donor side, called inside the round apply: execute the
        pending migration (install + soft commit). Transport failures
        retry at the next round's barrier, bounded — then roll back."""
        pm = self._pending_migration
        if pm is None or not self._active_role():
            return
        name = pm["name"]
        val = self._executor._read_var(self._scope, name)
        if val is None or name in self._dropped:
            self._pending_migration = None
            return
        ver = self._shard_map_version + 1
        _flight.record("ps.migration_begin", var=name,
                       to_shard=pm["to_shard"], version=ver,
                       round=self._applied_round)
        try:
            self._install_migration_locked(name, int(pm["to_shard"]),
                                           pm["to_endpoints"], ver)
        except (RuntimeError, OSError) as e:
            pm["attempts"] = int(pm.get("attempts", 0)) + 1
            _counter("ps.migrations", outcome="install_retry").inc()
            if pm["attempts"] >= 3:
                self._pending_migration = None
                _counter("ps.migrations", outcome="rollback").inc()
                _flight.record("ps.migration_rollback", var=name,
                               why="install failed: %s" % e)
                print("[ps_rpc] migration of %r to shard %s ROLLED "
                      "BACK after %d install failures (%s)"
                      % (name, pm["to_shard"], pm["attempts"], e),
                      file=sys.stderr, flush=True)
            return
        if os.environ.get("PADDLE_PS_CHAOS_DIE_AFTER_INSTALL") \
                == self._own_endpoint:
            # chaos-drill hook: the donor primary dies in the WORST
            # spot — range installed on the recipient, nothing
            # committed or replicated. The drill proves this rolls
            # back (or completes via a retriggered migration) with
            # params bit-for-bit.
            print("[ps_rpc] CHAOS: donor %s dying after migrate "
                  "install" % self._own_endpoint, file=sys.stderr,
                  flush=True)
            os.kill(os.getpid(), signal.SIGKILL)
        # soft commit: route the var away; keep its state in our
        # stream until the recipient durably owns it (hard commit)
        self._pending_migration = None
        self._shard_map_version = ver
        self._map_overrides[name] = {
            "shard": int(pm["to_shard"]), "version": ver,
            "committed": False, "to_endpoints": pm["to_endpoints"]}
        _counter("ps.migrations", outcome="installed").inc()
        _flight.record("ps.migration_installed", var=name,
                       version=ver, round=self._applied_round)

    def _install_migration_locked(self, name: str, to_shard: int,
                                  to_endpoints: str, ver: int) -> None:
        """Ship ``name``'s WHOLE FAMILY (base var + every @-companion
        in scope — momentum/adam state moves with its param, grads are
        transient but harmless) to the recipient's active primary for
        staging. Raises on transport/app failure — the caller owns the
        retry/rollback policy."""
        items = []
        for vn in self._family_names_locked(name):
            v = self._executor._read_var(self._scope, vn)
            if v is None or not hasattr(v, "shape"):
                continue
            items.append((vn, np.ascontiguousarray(host_array(v)),
                          None))
        if not items:
            raise RuntimeError("no tensor state for %r" % name)
        headers, raw = self._blobs_for(items)
        # kind=var vs kind=range: a regression back to whole-var
        # moves of a sparse table shows up as var bytes where range
        # bytes should be
        _counter("ps.migration_bytes", kind="var").inc(len(raw))
        self._mig_client(to_endpoints)._call({
            "kind": "migrate_install", "name": name,
            "mig_version": ver, "mig_round": self._applied_round,
            "to_shard": int(to_shard),
            "watermark": dict(self._applied_watermark),
            "has_block": (name + "@GRAD") in self._grad_to_block,
            "vars": headers}, raw)

    def _step_range_migration_locked(self) -> None:
        """Donor side of a ROW-RANGE migration, called
        inside the round apply: ship the dirty-row-tracked slice
        ``[src_lo, src_hi)`` of one sparse table to the recipient and
        soft-commit the per-range ownership split. Rides the whole-var
        protocol verbatim: install (staged, not servable) -> soft
        commit (map version bump; the rows stay in the donor's stream)
        -> the caller's replication ships the override to the donor's
        backups -> _commit_migrations_locked drives the replicated
        commit home. Transport failures retry at the next round's
        barrier, bounded — then roll back with no override anywhere a
        trainer can see."""
        pm = self._pending_range_migration
        if pm is None or not self._active_role():
            return
        name = pm["name"]
        tbl = self._executor._read_var(self._scope, name)
        if tbl is None:
            self._pending_range_migration = None
            return
        ver = self._shard_map_version + 1
        _flight.record("ps.range_migration_begin", var=name,
                       lo=int(pm["lo"]), hi=int(pm["hi"]),
                       to_shard=pm["to_shard"], version=ver,
                       round=self._applied_round)
        try:
            local_base = self._install_range_locked(pm, ver)
        except (RuntimeError, OSError) as e:
            pm["attempts"] = int(pm.get("attempts", 0)) + 1
            _counter("ps.migrations", outcome="install_retry").inc()
            if pm["attempts"] >= 3:
                self._pending_range_migration = None
                _counter("ps.migrations", outcome="rollback").inc()
                _flight.record("ps.range_migration_rollback", var=name,
                               why="install failed: %s" % e)
                print("[ps_rpc] range migration of %r[%s,%s) to shard "
                      "%s ROLLED BACK after %d install failures (%s)"
                      % (name, pm["lo"], pm["hi"], pm["to_shard"],
                         pm["attempts"], e),
                      file=sys.stderr, flush=True)
            return
        if os.environ.get("PADDLE_PS_CHAOS_DIE_AFTER_INSTALL") \
                == self._own_endpoint:
            # chaos-drill hook (shared with the whole-var path): the
            # donor primary dies in the WORST spot — rows staged on
            # the recipient, nothing committed or replicated
            print("[ps_rpc] CHAOS: donor %s dying after range "
                  "install" % self._own_endpoint, file=sys.stderr,
                  flush=True)
            os.kill(os.getpid(), signal.SIGKILL)
        # soft commit: route the window away; keep its rows in our
        # stream (unzeroed) until the recipient durably owns them
        self._pending_range_migration = None
        self._shard_map_version = ver
        rs = self._range_overrides.setdefault(name, [])
        rs[:] = [r for r in rs
                 if not (int(r["lo"]) == int(pm["lo"])
                         and int(r["hi"]) == int(pm["hi"]))]
        rs.append({"lo": int(pm["lo"]), "hi": int(pm["hi"]),
                   "shard": int(pm["to_shard"]),
                   "local_base": int(local_base),
                   "src_lo": int(pm["src_lo"]),
                   "src_hi": int(pm["src_hi"]),
                   "version": ver, "committed": False,
                   "to_endpoints": pm["to_endpoints"]})
        _counter("ps.migrations", outcome="installed").inc()
        _flight.record("ps.range_migration_installed", var=name,
                       lo=int(pm["lo"]), hi=int(pm["hi"]),
                       version=ver, round=self._applied_round)

    def _install_range_locked(self, pm: dict, ver: int) -> int:
        """Ship rows ``[src_lo, src_hi)`` of the table — and the same
        window of every @-companion sharing its row axis — to the
        recipient's active primary for staging. Returns the
        recipient-LOCAL base id the staged rows will land at (its
        table height at stage time). Raises on transport/app failure —
        the caller owns the retry/rollback policy."""
        name = pm["name"]
        s, e = int(pm["src_lo"]), int(pm["src_hi"])
        items = []
        found_base = False
        for vn in self._family_names_locked(name):
            v = self._executor._read_var(self._scope, vn)
            if v is None or not hasattr(v, "shape"):
                continue
            a = host_array(v)
            if a.ndim < 1 or int(a.shape[0]) < e:
                continue  # companions off the row axis stay put
            if vn == name:
                found_base = True
            items.append((vn, np.ascontiguousarray(a[s:e]), None))
        if not found_base:
            raise RuntimeError("no sliceable rows [%d,%d) of %r"
                               % (s, e, name))
        headers, raw = self._blobs_for(items)
        _counter("ps.migration_bytes", kind="range").inc(len(raw))
        resp, _ = self._mig_client(pm["to_endpoints"])._call({
            "kind": "migrate_range_install", "name": name,
            "mig_version": ver, "mig_round": self._applied_round,
            "lo": int(pm["lo"]), "hi": int(pm["hi"]),
            "to_shard": int(pm["to_shard"]),
            "watermark": dict(self._applied_watermark),
            "has_block": (name + "@GRAD") in self._grad_to_block,
            "vars": headers}, raw)
        return int(resp.get("local_base", 0))

    def _zero_range_locked(self, name: str, s: int, e: int) -> None:
        """Hard commit of a row-range move: ZERO the moved donor-local
        slice (a deterministic tombstone — shrinking the array would
        re-base every other local id this shard's clients hold) on the
        base table and every companion sharing its row axis, and mark
        them dense-dirty so the tombstone replicates."""
        for vn in self._family_names_locked(name):
            v = self._executor._read_var(self._scope, vn)
            if v is None or not hasattr(v, "shape"):
                continue
            a = host_array(v)
            if a.ndim < 1 or int(a.shape[0]) < e:
                continue
            a = np.array(a, copy=True)
            a[s:e] = 0
            write_array(self._executor, self._scope, vn, a)
            self._dirty_dense.add(vn)
            self._dirty_rows.pop(vn, None)

    def _commit_migrations_locked(self) -> None:
        """Donor side (original or promoted): drive every uncommitted
        outbound migration to its commit — re-sent each round until
        the recipient acks (idempotent), then hard-commit locally. A
        recipient that LOST its stage (its primary died between
        install and commit; staging is memory-only) is re-installed
        first — the donor still holds the var, which is exactly why
        the hard commit waits for the ack."""
        if not self._active_role():
            return
        for name, rs in list(self._range_overrides.items()):
            for ov in rs:
                if ov.get("committed") or "to_endpoints" not in ov:
                    continue
                try:
                    self._mig_client(ov["to_endpoints"])._call({
                        "kind": "migrate_range_commit", "name": name,
                        "mig_version": int(ov["version"]),
                        "lo": int(ov["lo"]), "hi": int(ov["hi"]),
                        "to_shard": int(ov["shard"])})
                except (RuntimeError, OSError) as e:
                    _counter("ps.migrations",
                             outcome="commit_retry").inc()
                    print("[ps_rpc] migrate_range_commit of %r[%s,%s) "
                          "failed (%s) — re-installing and retrying "
                          "next round" % (name, ov["lo"], ov["hi"], e),
                          file=sys.stderr, flush=True)
                    try:
                        # stage gone (recipient primary died) or its
                        # local base drifted: re-stage with a fresh
                        # base — the rows are still here, unzeroed
                        ov["local_base"] = self._install_range_locked(
                            {"name": name, "lo": ov["lo"],
                             "hi": ov["hi"], "src_lo": ov["src_lo"],
                             "src_hi": ov["src_hi"],
                             "to_shard": ov["shard"],
                             "to_endpoints": ov["to_endpoints"]},
                            int(ov["version"]))
                    except (RuntimeError, OSError):
                        pass  # next round retries the whole sequence
                    continue
                ov["committed"] = True
                self._zero_range_locked(name, int(ov["src_lo"]),
                                        int(ov["src_hi"]))
                _counter("ps.migrations", outcome="committed").inc()
                _flight.record("ps.range_migration_committed",
                               var=name, lo=int(ov["lo"]),
                               hi=int(ov["hi"]),
                               version=int(ov["version"]),
                               round=self._applied_round)
        for name, ov in list(self._map_overrides.items()):
            if ov.get("committed") or "to_endpoints" not in ov:
                continue
            try:
                self._mig_client(ov["to_endpoints"])._call({
                    "kind": "migrate_commit", "name": name,
                    "mig_version": int(ov["version"]),
                    "to_shard": int(ov["shard"])})
            except (RuntimeError, OSError) as e:
                _counter("ps.migrations", outcome="commit_retry").inc()
                print("[ps_rpc] migrate_commit of %r failed (%s) — "
                      "re-installing and retrying next round"
                      % (name, e), file=sys.stderr, flush=True)
                try:
                    # the stage may be GONE (the recipient primary
                    # that held it died; a promoted backup has no
                    # memory of it): put it back — this primary still
                    # holds the state, which is exactly why the hard
                    # commit waits for the ack
                    self._install_migration_locked(
                        name, int(ov["shard"]), ov["to_endpoints"],
                        int(ov["version"]))
                except (RuntimeError, OSError):
                    pass  # next round retries the whole sequence
                continue
            ov["committed"] = True
            self._drop_var_locked(name)
            _counter("ps.migrations", outcome="committed").inc()
            _flight.record("ps.migration_committed", var=name,
                           version=int(ov["version"]),
                           round=self._applied_round)

    def _drop_var_locked(self, name: str) -> None:
        """Hard commit: mask the migrated-out var (and its whole
        family — grads/optimizer state moved with it conceptually)
        from this group's stream; delete where the scope allows."""
        for vn in self._family_names_locked(name):
            self._dropped.add(vn)
            self._shipped_digests.pop(vn, None)
            self._dirty_rows.pop(vn, None)
            self._dirty_dense.discard(vn)
            try:
                if hasattr(self._scope, "__delitem__"):
                    del self._scope[vn]
            except (KeyError, TypeError):
                pass

    def _can_build_block(self, gname: str) -> bool:
        """Whether a var migrating in can get ``gname``'s optimize block:
        this server has it, or its ``block_factory`` builds it. A refusal
        here fails the install, and the donor rolls the migration back,
        rather than adopting a var nothing would optimize."""
        if gname in self._grad_to_block:
            return True
        return (self._block_factory is not None
                and self._block_factory(gname) is not None)

    def _commit_staged_locked(self, name: str) -> None:
        """Recipient side: a staged var becomes servable — into the
        scope, optimize block rebuilt, watermark merged (replays of
        rpcs already folded into the shipped state answer `replayed`
        here too — exactly-once across the shard-map bump), map
        bumped, and the var pushed to THIS group's backups before the
        donor ever gets the ack."""
        st = self._staged_in.pop(name)
        for vn, arr in st["arrays"].items():
            write_array(self._executor, self._scope, vn, arr)
            self._dropped.discard(vn)
            self._shipped_digests.pop(vn, None)
        gname = name + "@GRAD"
        if gname not in self._grad_to_block \
                and self._block_factory is not None:
            blk = self._block_factory(gname)
            if blk is not None:
                self._grad_to_block[gname] = blk
        for cid, s in (st.get("watermark") or {}).items():
            if int(self._repl_watermark.get(cid, 0)) < int(s):
                self._repl_watermark[cid] = int(s)
        ver = int(st["version"])
        self._shard_map_version = max(self._shard_map_version, ver)
        self._map_overrides[name] = {"shard": int(st["to_shard"]),
                                     "version": ver, "committed": True}
        self._replicate_vars_locked(sorted(st["arrays"]))
        _counter("ps.migrations", outcome="adopted").inc()
        _flight.record("ps.migration_commit", var=name, version=ver,
                       round=self._applied_round)

    def _commit_staged_range_locked(self, name: str) -> None:
        """Recipient side of a row-range move: the staged rows become
        servable — APPENDED to the resident table (at the local base
        promised in the install ack) and to every companion that
        shipped with them, optimize block rebuilt, watermark merged,
        map bumped with the committed range ownership, and the grown
        family pushed to THIS group's backups before the donor ever
        gets the ack."""
        st = self._staged_ranges.pop(name)
        for vn, arr in st["arrays"].items():
            cur = self._executor._read_var(self._scope, vn)
            if cur is not None and hasattr(cur, "shape") \
                    and len(cur.shape) == arr.ndim:
                grown = np.concatenate([host_array(cur), arr], axis=0)
            else:
                grown = arr
            write_array(self._executor, self._scope, vn,
                        np.ascontiguousarray(grown))
            self._dropped.discard(vn)
            self._shipped_digests.pop(vn, None)
            self._dirty_dense.add(vn)
        gname = name + "@GRAD"
        if gname not in self._grad_to_block \
                and self._block_factory is not None:
            blk = self._block_factory(gname)
            if blk is not None:
                self._grad_to_block[gname] = blk
        for cid, s in (st.get("watermark") or {}).items():
            if int(self._repl_watermark.get(cid, 0)) < int(s):
                self._repl_watermark[cid] = int(s)
        ver = int(st["version"])
        self._shard_map_version = max(self._shard_map_version, ver)
        rs = self._range_overrides.setdefault(name, [])
        rs[:] = [r for r in rs
                 if not (int(r["lo"]) == int(st["lo"])
                         and int(r["hi"]) == int(st["hi"]))]
        rs.append({"lo": int(st["lo"]), "hi": int(st["hi"]),
                   "shard": int(st["to_shard"]),
                   "local_base": int(st["local_base"]),
                   "version": ver, "committed": True})
        _gauge("ps.table_rows", shard=self._shard, table=name).set(
            int(st["local_base"]) + int(st["hi"]) - int(st["lo"]))
        self._replicate_vars_locked(sorted(st["arrays"]))
        _counter("ps.migrations", outcome="adopted").inc()
        _flight.record("ps.range_migration_adopted", var=name,
                       lo=int(st["lo"]), hi=int(st["hi"]),
                       version=ver, round=self._applied_round)

    def _range_redirect_locked(self, table: str, rows, mv: int):
        """Sparse-dataplane routing for row-range migrations: commit a
        staged range whose appended region a map-proving client is
        addressing (backstop for a donor that died between its bump
        and the commit), then answer ``wrong_shard`` when ANY
        requested local row falls in a window migrated away — all or
        nothing, so the client re-splits the whole request against the
        adopted map and every row executes exactly once. Returns the
        redirect response dict, or None to proceed."""
        st = self._staged_ranges.get(table)
        if st is not None and mv >= int(st["version"]):
            tbl = self._executor._read_var(self._scope, table)
            height = (int(tbl.shape[0])
                      if tbl is not None and hasattr(tbl, "shape")
                      else 0)
            if height == int(st["local_base"]) \
                    and any(int(r) >= height for r in rows):
                # the client PROVED the donor's map bump (its adopted
                # version rides the rpc) and is addressing the staged
                # rows' landing zone: commit
                self._commit_staged_range_locked(table)
        for r in self._range_overrides.get(table, ()):
            if int(r["shard"]) == self._shard_index:
                continue
            s, e = int(r.get("src_lo", -1)), int(r.get("src_hi", -1))
            if s < 0:
                continue
            if any(s <= int(x) < e for x in rows):
                return {"ok": False, "wrong_shard": True,
                        "name": table,
                        "shard_map": self._shard_map_payload_locked(),
                        "error": "rows [%d,%d) of %r migrated to "
                        "shard %s (map v%d)"
                        % (s, e, table, r["shard"],
                           self._shard_map_version)}
        return None

    def _replicate_vars_locked(self, names) -> None:
        """Push the named vars (plus the shard-map state) to this
        group's backups right now — the recipient's primary must not
        be the only holder of a freshly adopted family for even a
        round. Any failure schedules a full re-anchor at the next
        round instead of risking divergence."""
        items = []
        for name in names:
            val = self._executor._read_var(self._scope, name)
            if val is None or not hasattr(val, "shape"):
                continue
            items.append((name,
                          np.ascontiguousarray(host_array(val)),
                          None))
        if not items:
            return
        headers, raw = self._blobs_for(items)
        extra = self._repl_extra_locked()
        for ep in self._repl_targets():
            try:
                resp = self._repl_client(ep).replicate(
                    self._applied_round, headers, raw,
                    dict(self._applied_watermark), mode="delta",
                    base_round=self._applied_round,
                    epoch=self._epoch, extra=extra)
                if resp.get("repl_gap") or resp.get("fenced"):
                    self._shipped_digests = {}
            except (RuntimeError, OSError):
                self._shipped_digests = {}  # anchor next round

    def _async_tick_locked(self) -> dict:
        """Async-mode (RunAsyncLoop) durability bookkeeping, locked by
        caller: count the applied op, ship a synthetic replication
        round every ``PADDLE_PS_ASYNC_REPL_EVERY`` ops, and tell the
        client which round will carry this op — ``pending_round`` tags
        its replay-log entry, ``durable_round`` prunes every entry
        whose round is now replicated. That round-gating makes a
        failover mid-async-push exactly-once like the sync path
       ."""
        # a lone server normally has nobody to make rounds durable
        # WITH — but an armed durable dir IS a durability target
        #: synthetic rounds tick so the disk frames (and
        # the op-log truncation riding them) keep advancing
        if self._sync or not self._active_role() \
                or (len(self._endpoints) <= 1
                    and self._durable_store is None):
            return {}
        self._async_ops += 1
        pending = self._applied_round + 1
        if (self._async_repl_every > 0
                and self._async_ops % self._async_repl_every == 0):
            self._applied_round += 1
            self._applied_watermark = self._watermark_locked()
            self._replicate_locked()
            pending = self._applied_round
        # durable = the last round at least one backup ACKED (not the
        # last round we merely tried to ship): a ship that reached
        # nobody must not let the client prune ops that exist only on
        # this primary. Replication is state-based, so a LATER
        # successful ship retroactively makes every earlier round
        # durable — the monotonic _durable_round encodes exactly that.
        return {"durable_round": self._durable_round,
                "pending_round": pending}

    def _active_role(self) -> bool:
        return self._active or self._promoted

    def _promote_locked(self, kind: str) -> None:
        """A genuinely failed-over client reached this backup: become
        the primary (deterministic — clients walk the endpoint list in
        order, so the lowest-index live endpoint wins) and start
        streaming to the remaining backups."""
        self._promoted = True
        self._repl_dead.discard(self._own_endpoint)
        # the state this server holds = the replicated rounds; its
        # folded-seq watermark is exactly the inherited one, and its
        # first ship as a primary must be a full ANCHOR (it never
        # shipped anything, and the other backups' bases are unknown)
        self._applied_watermark = dict(self._repl_watermark)
        self._shipped_digests = {}
        # nothing is replicated BEYOND this server yet: async clients
        # must hold their replay logs until its first acked ship
        self._durable_round = 0
        _counter("ps.promotions").inc()
        _flight.record("ps.promotion", round=self._applied_round,
                       index=self._index, endpoint=self._own_endpoint,
                       rpc=kind, epoch=self._epoch)
        print("[ps_rpc] endpoint %s (index %d) promoted to primary at "
              "round %d epoch %d (trigger: %s)"
              % (self._own_endpoint, self._index, self._applied_round,
                 self._epoch, kind), file=sys.stderr, flush=True)

    # -- lease + quorum -----------

    def _lease_mode(self) -> bool:
        return self._lease_s > 0 and len(self._endpoints) > 1

    def _lease_expired_locked(self) -> bool:
        return time.monotonic() > self._lease_deadline

    def _refresh_lease_locked(self, epoch: int) -> None:
        """A renewal / replication / snapshot from an equal-or-newer
        primary: its lease holds for another period. The deadline is
        read through the ``clock_jitter`` chaos hook — a drilled
        process's lease view wanders like a real skewed clock would,
        and the quorum math must still never split the brain."""
        self._seen_epoch = max(self._seen_epoch, int(epoch))
        self._lease_deadline = _lease_deadline_in(self._lease_s)
        self._lease_expired_counted = False

    def _demote_locked(self, new_epoch: int, why: str) -> None:
        """Step down: a higher-epoch primary exists (fencing) or this
        primary lost its renewal majority long enough that one could.
        Better a loud redirect than a second writable primary."""
        if not self._active_role():
            return
        self._active = False
        self._promoted = False
        self._seen_epoch = max(self._seen_epoch, int(new_epoch))
        self._lease_deadline = _lease_deadline_in(self._lease_s)
        self._cond.notify_all()
        _flight.record("ps.demotion", endpoint=self._own_endpoint,
                       epoch=self._epoch, seen_epoch=self._seen_epoch,
                       why=why)
        print("[ps_rpc] endpoint %s DEMOTED at round %d (epoch %d): %s"
              % (self._own_endpoint, self._applied_round, self._epoch,
                 why), file=sys.stderr, flush=True)

    def _lease_loop(self) -> None:
        """One background loop per multi-endpoint server: the active
        primary renews its lease with every group peer; a caught-up
        backup whose lease view expired stands for election. Control-
        plane failures are signals, never fatal. The tick period is
        perturbed by the ``clock_jitter`` chaos hook — a skewed
        process renews early/late like a real drifting clock."""
        base_period = max(self._lease_s / 3.0, 0.05)
        while not self._shutdown.wait(
                max(0.02, base_period + _fault.clock_skew() / 3.0)):
            try:
                if self._active_role():
                    self._renew_lease()
                elif self._caught_up:
                    self._maybe_elect("lease-expiry")
            except Exception as e:  # noqa: BLE001 — the lease loop
                # must survive anything the drills throw at the wire
                print("[ps_rpc] lease loop error on %s: %s: %s"
                      % (self._own_endpoint, type(e).__name__, e),
                      file=sys.stderr, flush=True)

    def _renew_lease(self) -> None:
        """Primary side: one renewal sweep over the group. A refused
        peer is dead (tombstone — it cannot grant a rival's quorum
        either); a fenced reply means a newer epoch rules and this
        server demotes; in groups of >= 3, a full lease without a
        renewal MAJORITY demotes too — behind that partition a rival
        quorum may exist. With 2 endpoints no rival quorum can form
        without this server's own vote, so it serves on."""
        with self._lock:
            epoch, rnd = self._epoch, self._applied_round
        # witnesses receive renewals too (their per-shard lease views
        # must stay fresh, or they would rubber-stamp elections under
        # a live primary) but the renewal MAJORITY is group-only,
        # mirroring the election quorum
        n = len(self._endpoints)
        grants = 1  # self
        for ep in list(self._endpoints) + list(self._witnesses):
            if ep == self._own_endpoint or self._shutdown.is_set():
                continue
            witness = ep in self._witnesses
            try:
                resp = _bare_rpc(
                    ep, {"kind": "lease_renew", "epoch": epoch,
                         "round": rnd, "frm": self._own_endpoint,
                         "shard": self._shard,
                         "lease_ms": self._lease_s * 1e3},
                    timeout=max(self._lease_s / 3.0, 0.2))
            except ConnectionRefusedError:
                if not witness:
                    grants += 1  # dead listener: tombstone
                continue
            except (OSError, ValueError):
                continue  # partition/timeout: no evidence either way
            if resp.get("fenced"):
                with self._lock:
                    self._demote_locked(int(resp.get("epoch", 0)),
                                        "fenced by %s during lease "
                                        "renewal" % ep)
                return
            if resp.get("ok"):
                if not witness:
                    grants += 1
                    _counter("ps.lease_renewals").inc()
                # witness acks count their own ps.witness_renewals
        now = time.monotonic()
        if grants * 2 > n:
            self._last_majority_ack = now
        elif n >= 3 and now - self._last_majority_ack > self._lease_s:
            with self._lock:
                self._demote_locked(
                    self._epoch, "no renewal majority for %.1fs "
                    "(%d/%d reachable)" % (now - self._last_majority_ack,
                                           grants, n))

    def _maybe_elect(self, trigger: str) -> bool:
        """Quorum election (backup side). Returns True when this
        server is (or just became) the active primary. Prerequisites:
        caught up, lease view expired (+ an index-staggered grace so
        the lowest surviving index wins clean races). The epoch bump
        needs strictly more than half the endpoint GROUP: self +
        granted votes + refused-connect tombstones. Any voter holding
        a newer round than this candidate vetoes — better no primary
        than a stale one."""
        if not self._lease_mode():
            return self._active_role()
        with self._lock:
            if self._active_role():
                return True
            if not self._caught_up:
                return False
            stagger = max(0, self._index - 1) * self._lease_s / 4.0
            if time.monotonic() <= self._lease_deadline + stagger:
                return False
            if not self._lease_expired_counted:
                self._lease_expired_counted = True
                _counter("ps.lease_expiries", shard=self._shard).inc()
                _flight.record("ps.lease_expired",
                               endpoint=self._own_endpoint,
                               shard=self._shard,
                               round=self._applied_round)
        with self._election_lock:
            with self._lock:
                if self._active_role():
                    return True
                if time.monotonic() <= self._lease_deadline:
                    return False  # a renewal landed while we queued
                target = max(self._epoch, self._seen_epoch,
                             self._promised_epoch) + 1
                my_round = self._applied_round
            grants, tombstones, denials = 1, 0, 0
            w_grants, w_tombstones = 0, 0
            stale = vetoed = False
            for ep in list(self._endpoints) + list(self._witnesses):
                if ep == self._own_endpoint or self._shutdown.is_set():
                    continue
                witness = ep in self._witnesses
                try:
                    resp = _bare_rpc(
                        ep, {"kind": "vote", "epoch": target,
                             "cand_round": my_round,
                             "shard": self._shard,
                             "lease_ms": self._lease_s * 1e3,
                             "candidate": self._own_endpoint},
                        timeout=max(self._lease_s / 3.0, 0.3))
                except ConnectionRefusedError:
                    if witness:
                        w_tombstones += 1  # dead witness: its veto
                        # power dies with it (positive evidence)
                    else:
                        tombstones += 1
                    continue
                except (OSError, ValueError):
                    continue  # unreachable: silence is not assent
                if int(resp.get("round", -1)) > my_round:
                    stale = True
                if resp.get("granted"):
                    if witness:
                        w_grants += 1
                    else:
                        grants += 1
                else:
                    denials += 1
                    if resp.get("active"):
                        # a REACHABLE, still-active primary denied:
                        # it is demonstrably alive — this candidate's
                        # lease view is merely late (a delayed
                        # renewal sweep, a jittered clock). Deposing
                        # it would be pure churn: VETO. Promotion
                        # needs the primary unreachable (timeout),
                        # dead (refused), or demoted — never outvoted
                        # while it answers.
                        vetoed = True
            # quorum is GROUP-ONLY: witnesses gate below but never
            # provide margin (a busy primary whose vote handler is
            # starved for a moment must not be out-votable by
            # candidate+witness — the invariant that a 2-group
            # backup can never promote without the primary's death
            # evidence stays intact)
            n = len(self._endpoints)
            quorum = (grants + tombstones) * 2 > n
            # witnesses configured => the election ALSO needs positive
            # evidence: at least one live witness granting (its lease
            # view of this shard expired — the primary really stopped
            # renewing), unless every witness is itself a tombstone.
            # Forged connection-REFUSALs alone can no longer elect a
            # backup under a live primary.
            w_ok = (not self._witnesses or w_grants >= 1
                    or w_tombstones >= len(self._witnesses))
            won = quorum and not stale and w_ok and not vetoed
            _flight.record("ps.election", endpoint=self._own_endpoint,
                           epoch=target, grants=grants,
                           tombstones=tombstones, denials=denials,
                           witness_grants=w_grants,
                           witness_tombstones=w_tombstones,
                           stale=stale, vetoed=vetoed, won=won,
                           trigger=trigger)
            if not won:
                if vetoed:
                    with self._lock:
                        # the primary lives: stop standing until its
                        # next renewal actually fails to arrive
                        self._refresh_lease_locked(self._seen_epoch)
                print("[ps_rpc] endpoint %s lost election for epoch %d"
                      " (%d grants + %d tombstones of %d, denials=%d, "
                      "witness grants=%d/%d, stale=%s, vetoed=%s; "
                      "trigger=%s) — staying a backup"
                      % (self._own_endpoint, target, grants, tombstones,
                         n, denials, w_grants, len(self._witnesses),
                         stale, vetoed, trigger),
                      file=sys.stderr, flush=True)
                return False
            with self._lock:
                if not self._active_role():
                    self._epoch = target
                    self._seen_epoch = max(self._seen_epoch, target)
                    self._promote_locked(trigger)
                return True

    # -- rejoin catch-up (relaunched server -> backup) --------------------

    def _catchup_loop(self) -> None:
        """Probe the endpoint list for the active server, pull a
        manifest-verified snapshot (join_backup also splices this
        server back into the replication stream, atomically with the
        snapshot), load it, and open for replication traffic."""
        import shutil
        import tempfile

        t0 = time.monotonic()
        while not self._shutdown.is_set():
            for ep in self._endpoints:
                if ep == self._own_endpoint or self._shutdown.is_set():
                    continue
                probe = None
                d = None
                try:
                    probe = PSClient(ep, trainer_id=None,
                                     auto_heartbeat=False, timeout=2.0,
                                     rpc_deadline=30.0, max_retries=0)
                    st, _ = probe._call({"kind": "repl_status"})
                    if not st.get("active"):
                        continue
                    d = tempfile.mkdtemp(prefix="ps_catchup_")
                    resp, _ = probe._call({
                        "kind": "join_backup", "dir": d,
                        "endpoint": self._own_endpoint})
                    from ..checkpoint import load_scope_snapshot

                    with self._lock:
                        # replication may already have raced past the
                        # snapshot (we were spliced into the stream the
                        # instant it was taken) — newer full blobs win
                        if self._applied_round <= int(resp["round"]):
                            load_scope_snapshot(self._executor,
                                                self._scope, d)
                            self._applied_round = int(resp["round"])
                        for cid, s in (resp.get("watermark")
                                       or {}).items():
                            if int(self._repl_watermark.get(cid, 0)) \
                                    < int(s):
                                self._repl_watermark[cid] = int(s)
                        # shard-map / migration state: a rejoiner must
                        # not re-serve (or re-anchor) vars the group
                        # migrated away while it was down
                        sm = resp.get("shard_map")
                        if sm:
                            self._shard_map_version = max(
                                self._shard_map_version,
                                int(sm.get("version", 0)))
                        for n2, ov in (resp.get("map_overrides")
                                       or {}).items():
                            self._map_overrides[n2] = dict(ov)
                        for n2 in resp.get("dropped", []) or []:
                            self._dropped.add(n2)
                            try:
                                if hasattr(self._scope, "__delitem__") \
                                        and n2 in \
                                        self._scope.local_var_names():
                                    del self._scope[n2]
                            except (KeyError, TypeError):
                                pass
                        # adopt the active primary's epoch + a fresh
                        # lease: a just-rejoined backup must not stand
                        # for election before the primary's first
                        # renewal reaches it
                        self._refresh_lease_locked(
                            int(resp.get("epoch", 0)))
                        self._pending.clear()
                        self._send_barriers = 0
                        self._fetch_barriers = 0
                        self._round_complete = True
                        self._fetches_pending = False
                        self._caught_up = True
                    _histogram("ps.catchup_ms").observe(
                        (time.monotonic() - t0) * 1e3)
                    _counter("ps.catchup_bytes").inc(sum(
                        os.path.getsize(os.path.join(d, fn))
                        for fn in os.listdir(d)))
                    _flight.record("ps.rejoin",
                                   round=self._applied_round, via=ep)
                    print("[ps_rpc] endpoint %s rejoined as backup at "
                          "round %d (caught up from %s in %.0f ms)"
                          % (self._own_endpoint, self._applied_round,
                             ep, (time.monotonic() - t0) * 1e3),
                          file=sys.stderr, flush=True)
                    return
                except (RuntimeError, OSError, KeyError, ValueError) \
                        as e:
                    print("[ps_rpc] rejoin catch-up attempt via %s "
                          "failed (will retry): %s" % (ep, e),
                          file=sys.stderr, flush=True)
                    continue
                finally:
                    if probe is not None:
                        probe.close()
                    if d is not None:
                        # failed attempts must not leave a snapshot
                        # dir per 0.5s retry during a long outage
                        shutil.rmtree(d, ignore_errors=True)
            self._shutdown.wait(0.5)

    def _wait_for(self, predicate, what: str):
        """Bounded condition wait (locked by caller); surfaces stale
        trainers instead of hanging forever when a rank died."""
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
        """Remove a dead trainer from the round math (locked by
        caller): shrink the effective fanin and re-check both barriers
        — the survivors may already have everyone-still-alive's
        contributions in, in which case the round completes NOW."""
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
        if kind in self._DATAPLANE and not self._active_role():
            # backup role. Lease mode (the default): promotion is
            # gated on lease expiry + a quorum election — a client
            # merely REACHING a backup proves nothing (it may be the
            # wrong side of a partition). Legacy mode
            # (PADDLE_PS_LEASE_MS=0): only a client that genuinely
            # failed over (fo >= 1 — it watched the previous endpoint
            # die) may promote. In both: an un-caught-up rejoiner
            # redirects unconditionally, and a backup that fell off
            # the stream is never promoted by a client that OBSERVED a
            # newer round than it holds — better no primary (loud
            # failure) than a stale one (silent param regression).
            with self._lock:
                lease_mode = self._lease_mode()
                reject = (not self._caught_up
                          or int(msg.get("round", 0))
                          > self._applied_round
                          or (not lease_mode
                              and int(msg.get("fo", 0)) < 1))
                expired = lease_mode and self._lease_expired_locked()
            if not reject:
                if lease_mode:
                    # election takes its own locks (it rpcs the group)
                    if not self._maybe_elect("dataplane:" + kind):
                        resp = {
                            "ok": False, "not_primary": True,
                            "error": "endpoint %s is a backup (index "
                            "%d) awaiting lease expiry/quorum"
                            % (self._own_endpoint, self._index)}
                        if expired or int(msg.get("fo", 0)) >= 1:
                            # a failed-over client should WAIT here
                            # (its old primary is dead to it) instead
                            # of burning failover budget on redirects
                            with self._lock:
                                left = (self._lease_deadline
                                        - time.monotonic()) * 1e3
                            resp["lease_wait_ms"] = max(
                                min(left, 1000.0),
                                self._lease_s * 250.0)
                        return resp, b""
                else:
                    with self._lock:
                        if not self._active_role():
                            self._promote_locked(kind)
            else:
                return {"ok": False, "not_primary": True,
                        "error": "endpoint %s is a backup (index "
                        "%d, caught_up=%s, round %d vs client "
                        "round %s), not the primary"
                        % (self._own_endpoint, self._index,
                           self._caught_up, self._applied_round,
                           msg.get("round"))}, b""
        if kind in self._DATAPLANE and self._active_role():
            # even an ACTIVE primary must refuse a client that has
            # OBSERVED a newer round than it holds: a backup that fell
            # off the replication stream and later won a tombstone
            # election (its only voter being the dead primary) would
            # otherwise silently regress params. Better no primary —
            # loud failure — than a stale one.
            with self._lock:
                if int(msg.get("round", 0)) > self._applied_round:
                    return {"ok": False, "not_primary": True,
                            "error": "endpoint %s is at round %d but "
                            "the client observed round %s — refusing "
                            "to serve stale params"
                            % (self._own_endpoint, self._applied_round,
                               msg.get("round"))}, b""
        if kind in ("send_grad", "get_param") and self._active_role():
            # live-migration routing: a var migrated AWAY
            # redirects (the token is un-recorded — the rpc executes
            # exactly once, at the real owner); a var staged IN whose
            # dataplane traffic arrives proves the donor's map bump
            # reached a trainer, so the stage self-commits (backstop
            # for a donor that died between its bump and the commit)
            base = str(msg.get("name", "")).split("@", 1)[0]
            if base:
                with self._lock:
                    st = self._staged_in.get(base)
                    if st is not None and int(msg.get("mv", -1)) \
                            >= int(st["version"]):
                        # the client PROVED the donor's map bump (its
                        # adopted map version rides the rpc): commit.
                        # A version-0 hash-routed client proves
                        # nothing — a var migrating BACK toward its
                        # hash-home must not be committed by a client
                        # that never saw the bump.
                        self._commit_staged_locked(base)
                    ov = self._map_overrides.get(base)
                    if ov is not None \
                            and int(ov["shard"]) != self._shard_index:
                        return {"ok": False, "wrong_shard": True,
                                "name": base,
                                "shard_map":
                                    self._shard_map_payload_locked(),
                                "error": "var %r migrated to shard %s "
                                "(map v%d)" % (base, ov["shard"],
                                               self._shard_map_version)
                                }, b""
        if "trainer_id" in msg:
            tid = int(msg["trainer_id"])
            if self._evict_after > 0 and not self._clock_started:
                # first sign of life from ANY trainer arms the clock
                # for every expected rank (0..fanin-1) — not at server
                # construction, or slow worker startup (interpreter +
                # torch import) would read as death before round 1
                self._clock_started = True
                self.monitor.register(range(self._fanin))
            self.monitor.ping(tid)
            # an evicted trainer that TRAINS again (a supervised
            # relaunch) rejoins the round math; a mere heartbeat from a
            # zombie must not grow the fanin back
            if tid in self._evicted and kind in (
                    "send_grad", "send_barrier", "get_param",
                    "fetch_barrier", "pull_sparse", "push_sparse"):
                self._readmit(tid)
        if kind == "send_grad":
            arr = _array_from(msg["array"], raw)
            extra = {}
            with self._lock:
                if self._sync:
                    if self._stale_train_round_locked(msg):
                        # the TRAINING round this grad belongs to was
                        # already applied here (eviction sailed it, or
                        # a relaunched trainer is re-running a round
                        # whose barrier its dead incarnation already
                        # closed): folding it into the NEXT round
                        # would double-apply — drop it, tell the
                        # client, keep exactly-once
                        return {"ok": True, "stale_round": True,
                                "round": self._applied_round}, b""
                    self._pending.setdefault(
                        msg["name"], {})[int(msg.get("trainer_id",
                                                     0))] = arr
                else:  # async: apply immediately (RunAsyncLoop)
                    write_array(self._executor, self._scope, msg["name"],
                                arr)
                    sub = self._grad_to_block.get(msg["name"])
                    if sub is not None:
                        self._executor.run_block(sub, self._scope)
                    # a dense async update touches its grad's FAMILY
                    # through its block: full diff takes over there
                    self._mark_families_dirty_locked([msg["name"]])
                    if (self._durable_store is not None
                            and self._active_role()):
                        self._log_async_op_locked(msg, raw,
                                                  kind="send_grad")
                    extra = self._async_tick_locked()
            return dict({"ok": True}, **extra), b""
        if kind == "send_barrier":
            with self._lock:
                if self._sync and self._stale_train_round_locked(msg):
                    # this barrier's round already applied: counting
                    # it would pre-pay the NEXT round's fanin and
                    # apply it early with a trainer missing
                    resp = {"ok": True, "stale_round": True,
                            "round": self._applied_round}
                    if self._shard_map_version:
                        resp["shard_map"] = \
                            self._shard_map_payload_locked()
                    return resp, b""
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
                if self._shard_map_version:
                    # the barrier IS the atomic map-adoption point:
                    # every trainer's round-N ack carries the map that
                    # round N's apply may just have bumped
                    resp["shard_map"] = self._shard_map_payload_locked()
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
                # only count toward an OPEN fetch window: a failover
                # replay of an already-satisfied barrier (the round it
                # closed arrived here via replication) must not
                # pre-pay the NEXT round's fetch count, or a later
                # round would unlatch with a trainer still mid-fetch
                if self._fetches_pending:
                    self._fetch_barriers += 1
                    if self._fetch_barriers >= self._effective_fanin():
                        self._fetch_barriers = 0
                        self._fetches_pending = False
                        self._cond.notify_all()
            return {"ok": True}, b""
        if kind == "pull_sparse":
            # sparse table pull (pslib PullSparseVarsSync,
            # fleet_wrapper.h:84): LOCAL row ids in, value rows out.
            # Deliberately NOT gated on the dense sync round: a pull
            # happens at FORWARD time, and waiting for _round_complete
            # here would deadlock two sync trainers (A's barrier waits
            # for B while B's pull waits for the round A opened) —
            # sparse tables are round-free in pslib, like the push.
            ids = _array_from(msg["array"], raw).reshape(-1)
            with self._lock:
                base = str(msg["name"]).split("@", 1)[0]
                redir = self._range_redirect_locked(
                    base, ids, int(msg.get("mv", -1)))
                if redir is not None:
                    return redir, b""
                tbl = self._executor._read_var(self._scope, msg["name"])
                if tbl is not None:
                    vals = gather_rows(tbl, ids)
            if tbl is None:
                return {"ok": False,
                        "error": "no table %r" % msg["name"]}, b""
            return {"ok": True, "array": _array_header(vals)}, \
                vals.tobytes()
        if kind == "push_sparse":
            # sparse grad push applied IMMEDIATELY (pslib
            # PushSparseVarsAsync semantics — downpour workers don't
            # gate sparse updates on the dense sync round). raw =
            # rows bytes + values bytes; rows are LOCAL to this shard.
            rh, vh = msg["rows"], msg["array"]
            nrows_bytes = int(np.dtype(rh["dtype"]).itemsize
                              * int(np.prod(rh["shape"])))
            rows = np.frombuffer(raw[:nrows_bytes],
                                 dtype=rh["dtype"]).reshape(-1)
            vals = _array_from(vh, raw[nrows_bytes:])
            extra = {}
            with self._lock:
                pname = msg.get("param", "")
                if pname:
                    redir = self._range_redirect_locked(
                        pname, rows, int(msg.get("mv", -1)))
                    if redir is not None:
                        return redir, b""
                tbl = self._executor._read_var(self._scope, pname)
                height = (int(tbl.shape[0])
                          if tbl is not None else int(rows.max()) + 1)
                self._executor._write_var(
                    self._scope, msg["name"],
                    selected_rows(self._executor, rows, vals, height))
                sub = self._grad_to_block.get(msg["name"])
                t_blk = time.monotonic()
                if sub is not None:
                    self._executor.run_block(sub, self._scope)
                if pname:
                    # a row-local block (pslib's) touched exactly the
                    # pushed rows, so the next delta round can ship a row
                    # SLICE of the table instead of the whole thing
                    self._mark_pushed_rows_locked(msg["name"], pname, rows)
                    # hot-shard steering inputs: per-table
                    # apply time, dirty-row census, and a coarse
                    # row-heat histogram (8 buckets over the local
                    # height) the steerer derives split points from
                    _histogram("ps.apply_ms", shard=self._shard,
                               table=pname).observe(
                        (time.monotonic() - t_blk) * 1e3)
                    _gauge("ps.dirty_rows", shard=self._shard,
                           table=pname).set(
                        len(self._dirty_rows.get(pname, ())))
                    # GLOBAL height when the router stamped it (a
                    # range-sliced push), else this shard's own: the
                    # steerer sizes migrate_range plans from this
                    _gauge("ps.table_rows", shard=self._shard,
                           table=pname).set(
                        int(msg.get("gh") or height))
                    if height > 0 and rows.size:
                        buckets, hits = np.unique(np.minimum(
                            7, rows.astype(np.int64) * 8 // height),
                            return_counts=True)
                        for b, n in zip(buckets.tolist(), hits.tolist()):
                            _counter("ps.row_heat", shard=self._shard,
                                     table=pname, bucket=str(b)).inc(n)
                if (self._durable_store is not None and not self._sync
                        and self._active_role()):
                    # log BEFORE the tick: if the tick folds this op
                    # into a frame, clear_ops_through truncates the
                    # entry right back — the invariant is that every
                    # acked async op is durable somewhere (frame or
                    # tail) the moment the ack leaves
                    self._log_async_op_locked(msg, raw)
                extra = self._async_tick_locked()
            return dict({"ok": True}, **extra), b""
        if kind == "checkpoint":
            # checkpoint_notify_op.cc: snapshot every servable var into
            # the requested directory (reference tensor-stream format)
            with self._lock:
                snapshot_scope_to_dir(self._executor, self._scope,
                                      msg.get("dir", ""))
            return {"ok": True}, b""
        if kind == "replicate":
            # primary -> backup round stream: post-round blobs (full
            # anchor or changed-vars/rows delta) + the dedup watermark,
            # applied atomically with a round-state reset so a
            # promotion right after is a clean round start. The rpc
            # doubles as a lease renewal (it proves the primary
            # lives); a lower-epoch sender is fenced.
            if self._active_role():
                return {"ok": False, "error":
                        "replicate sent to the active primary %s"
                        % self._own_endpoint}, b""
            mode = msg.get("repl_mode", "full")
            with self._lock:
                epoch = int(msg.get("epoch", 0))
                if epoch < self._seen_epoch:
                    # ok=True: the rpc worked — the VERDICT is fenced,
                    # and the stale primary must read it, not retry.
                    # Loud in the flight ring: after a cold restart
                    # this is the dead incarnation's straggler being
                    # refused by the disk-restored epoch
                    _counter("ps.fence_refused").inc()
                    _flight.record("ps.fence_refused",
                                   kind="replicate", epoch=epoch,
                                   seen=self._seen_epoch,
                                   shard=self._shard)
                    return {"ok": True, "fenced": True,
                            "epoch": self._seen_epoch}, b""
                self._refresh_lease_locked(epoch)
                if mode == "delta" and (
                        not self._caught_up
                        or int(msg.get("repl_base_round", -1))
                        != self._applied_round):
                    # can't apply a delta we don't have the base for
                    # (freshly rejoined / missed rounds): ask for a
                    # full re-anchor instead of silently diverging
                    return {"ok": True, "repl_gap": True,
                            "round": self._applied_round}, b""
                self._splice_vars_locked(msg.get("vars", []), raw)
                # shard-map / migration state rides the stream: a
                # promoted backup must know what moved (or is moving)
                # away, or it would serve — or lose — a migrated var
                sm = msg.get("shard_map")
                if sm and int(sm.get("version", 0)) \
                        >= self._shard_map_version:
                    self._shard_map_version = int(sm["version"])
                mo = msg.get("map_overrides")
                if mo:
                    for n2, ov in mo.items():
                        cur = self._map_overrides.get(n2)
                        if cur is None or int(cur.get("version", 0)) \
                                <= int(ov.get("version", 0)):
                            self._map_overrides[n2] = dict(ov)
                for n2 in msg.get("dropped", []) or []:
                    if n2 not in self._dropped:
                        self._dropped.add(n2)
                        self._shipped_digests.pop(n2, None)
                        try:
                            if hasattr(self._scope, "__delitem__") \
                                    and n2 in self._scope.local_var_names():
                                del self._scope[n2]
                        except (KeyError, TypeError):
                            pass
                pm = msg.get("pending_migration")
                if pm:
                    # inherit the intent: a promoted backup re-drives
                    # the migration instead of silently dropping it
                    self._pending_migration = dict(pm)
                elif not self._active_role():
                    # the stream is the truth: an intent that stopped
                    # riding it was executed or rolled back upstream
                    self._pending_migration = None
                ro = msg.get("range_overrides")
                if ro:
                    # row-range ownership: adopted wholesale
                    # — the stream is the truth, and the full dicts
                    # (src window + recipient chain) let a promoted
                    # backup re-drive an uncommitted range commit
                    self._range_overrides = {
                        t: [dict(r) for r in rs] for t, rs in ro.items()}
                prm = msg.get("pending_range_migration")
                if prm:
                    self._pending_range_migration = dict(prm)
                elif not self._active_role():
                    self._pending_range_migration = None
                # NB "round" is the dedup-token key _call stamps on
                # every message — the payload round travels separately
                self._applied_round = int(msg["repl_round"])
                for cid, s in (msg.get("watermark") or {}).items():
                    if int(self._repl_watermark.get(cid, 0)) < int(s):
                        self._repl_watermark[cid] = int(s)
                self._pending.clear()
                self._send_barriers = 0
                self._fetch_barriers = 0
                self._round_complete = True
                self._fetches_pending = False
                self._caught_up = True
            _flight.record("ps.replicated", round=self._applied_round,
                           mode=mode)
            return {"ok": True, "round": self._applied_round}, b""
        if kind == "migrate_begin":
            # control plane, donor side: record the intent; the
            # transfer itself runs inside the NEXT round apply (the
            # freeze point every trainer is barrier-blocked behind)
            if not self._active_role():
                return {"ok": False, "not_primary": True,
                        "error": "migrate_begin sent to non-active "
                        "endpoint %s" % self._own_endpoint}, b""
            name = str(msg.get("name", "")).split("@", 1)[0]
            with self._lock:
                ov = self._map_overrides.get(name)
                if ov is not None \
                        and int(ov["shard"]) != self._shard_index:
                    return {"ok": True, "already_migrated": True,
                            "shard_map":
                                self._shard_map_payload_locked()}, b""
                if self._executor._read_var(self._scope, name) is None:
                    return {"ok": False, "error":
                            "no var %r to migrate" % name}, b""
                pm = self._pending_migration
                if pm is not None and pm.get("name") != name:
                    # one in-flight migration per group: silently
                    # replacing an acked intent would strand its
                    # caller — refuse loudly, retry after the barrier
                    return {"ok": False, "error":
                            "migration of %r already pending on %s — "
                            "retry after the next round barrier"
                            % (pm.get("name"),
                               self._own_endpoint)}, b""
                self._pending_migration = {
                    "name": name, "to_shard": int(msg["to_shard"]),
                    "to_endpoints": str(msg["to_endpoints"])}
            _flight.record("ps.migration_requested", var=name,
                           to_shard=int(msg["to_shard"]))
            return {"ok": True, "pending": True}, b""
        if kind == "migrate_install":
            # recipient side: STAGE the inbound range (not servable
            # until the donor's commit — or a dataplane touch that
            # proves the donor's map bump reached a trainer)
            if not self._active_role():
                return {"ok": False, "not_primary": True,
                        "error": "migrate_install sent to non-active "
                        "endpoint %s" % self._own_endpoint}, b""
            if msg.get("has_block") and not self._can_build_block(
                    str(msg.get("name", "")) + "@GRAD"):
                return {"ok": False, "error":
                        "recipient %s has no block_factory to rebuild "
                        "the optimize block for %r"
                        % (self._own_endpoint, msg.get("name"))}, b""
            name = str(msg["name"])
            arrays: Dict[str, np.ndarray] = {}
            off = 0
            for h in msg.get("vars", []):
                n = int(np.dtype(h["dtype"]).itemsize
                        * int(np.prod(h["shape"]) if h["shape"]
                              else 1))
                arrays[h["name"]] = _array_from(h, raw[off:off + n])
                off += n
            if name not in arrays:
                return {"ok": False, "error":
                        "migrate_install payload lacks the base var "
                        "%r" % name}, b""
            ver = int(msg["mig_version"])
            with self._lock:
                cur = self._map_overrides.get(name)
                if cur is not None and cur.get("committed") \
                        and int(cur.get("version", 0)) >= ver:
                    return {"ok": True, "already_committed": True}, b""
                self._staged_in[name] = {
                    "version": ver, "arrays": arrays,
                    "to_shard": int(msg["to_shard"]),
                    "round": int(msg.get("mig_round", 0)),
                    "watermark": dict(msg.get("watermark") or {})}
            _flight.record("ps.migration_install", var=name,
                           version=ver,
                           round=int(msg.get("mig_round", 0)))
            return {"ok": True, "staged": True}, b""
        if kind == "migrate_commit":
            if not self._active_role():
                return {"ok": False, "not_primary": True,
                        "error": "migrate_commit sent to non-active "
                        "endpoint %s" % self._own_endpoint}, b""
            name = str(msg["name"])
            ver = int(msg["mig_version"])
            with self._lock:
                cur = self._map_overrides.get(name)
                if cur is not None \
                        and int(cur.get("version", 0)) >= ver \
                        and cur.get("committed"):
                    return {"ok": True, "already_committed": True}, b""
                st = self._staged_in.get(name)
                if st is None or int(st["version"]) != ver:
                    return {"ok": False, "error":
                            "no staged migration of %r at version %d "
                            "on %s" % (name, ver,
                                       self._own_endpoint)}, b""
                self._commit_staged_locked(name)
            return {"ok": True}, b""
        if kind == "migrate_range_begin":
            # control plane, donor side: record the intent
            # to move rows [lo, hi) (global; src_lo/src_hi donor-local)
            # of one sparse table; the transfer itself runs inside the
            # NEXT round apply, behind the barrier every trainer is
            # blocked in
            if not self._active_role():
                return {"ok": False, "not_primary": True,
                        "error": "migrate_range_begin sent to "
                        "non-active endpoint %s"
                        % self._own_endpoint}, b""
            name = str(msg.get("name", "")).split("@", 1)[0]
            lo, hi = int(msg["lo"]), int(msg["hi"])
            src_lo, src_hi = int(msg["src_lo"]), int(msg["src_hi"])
            if hi <= lo or src_hi - src_lo != hi - lo or src_lo < 0:
                return {"ok": False, "error":
                        "bad range [%d,%d) (src [%d,%d)) for %r"
                        % (lo, hi, src_lo, src_hi, name)}, b""
            with self._lock:
                for r in self._range_overrides.get(name, ()):
                    if int(r["shard"]) != self._shard_index \
                            and not (hi <= int(r["lo"])
                                     or int(r["hi"]) <= lo):
                        return {"ok": True, "already_migrated": True,
                                "shard_map":
                                    self._shard_map_payload_locked()
                                }, b""
                tbl = self._executor._read_var(self._scope, name)
                if tbl is None or not hasattr(tbl, "shape") \
                        or int(tbl.shape[0]) < src_hi:
                    return {"ok": False, "error":
                            "no table %r holding local rows [%d,%d)"
                            % (name, src_lo, src_hi)}, b""
                if self._pending_migration is not None \
                        or self._pending_range_migration is not None:
                    # one in-flight migration per group, same refusal
                    # discipline as the whole-var path
                    return {"ok": False, "error":
                            "a migration is already pending on %s — "
                            "retry after the next round barrier"
                            % self._own_endpoint}, b""
                self._pending_range_migration = {
                    "name": name, "lo": lo, "hi": hi,
                    "src_lo": src_lo, "src_hi": src_hi,
                    "to_shard": int(msg["to_shard"]),
                    "to_endpoints": str(msg["to_endpoints"])}
            _flight.record("ps.range_migration_requested", var=name,
                           lo=lo, hi=hi, to_shard=int(msg["to_shard"]))
            return {"ok": True, "pending": True}, b""
        if kind == "migrate_range_install":
            # recipient side: STAGE the inbound rows (not servable
            # until the donor's replicated commit — or a dataplane
            # touch proving the donor's map bump reached a trainer).
            # The ack names the LOCAL base id the rows will land at.
            if not self._active_role():
                return {"ok": False, "not_primary": True,
                        "error": "migrate_range_install sent to "
                        "non-active endpoint %s"
                        % self._own_endpoint}, b""
            if msg.get("has_block") and not self._can_build_block(
                    str(msg.get("name", "")) + "@GRAD"):
                return {"ok": False, "error":
                        "recipient %s has no block_factory to rebuild "
                        "the optimize block for %r"
                        % (self._own_endpoint, msg.get("name"))}, b""
            name = str(msg["name"])
            arrays: Dict[str, np.ndarray] = {}
            off = 0
            for h in msg.get("vars", []):
                n = int(np.dtype(h["dtype"]).itemsize
                        * int(np.prod(h["shape"]) if h["shape"]
                              else 1))
                arrays[h["name"]] = _array_from(h, raw[off:off + n])
                off += n
            if name not in arrays:
                return {"ok": False, "error":
                        "migrate_range_install payload lacks the base "
                        "table %r" % name}, b""
            ver = int(msg["mig_version"])
            lo, hi = int(msg["lo"]), int(msg["hi"])
            with self._lock:
                for r in self._range_overrides.get(name, ()):
                    if (int(r["lo"]) == lo and int(r["hi"]) == hi
                            and r.get("committed")
                            and int(r.get("version", 0)) >= ver
                            and int(r["shard"]) == self._shard_index):
                        return {"ok": True, "already_committed": True,
                                "local_base": int(r["local_base"])
                                }, b""
                tbl = self._executor._read_var(self._scope, name)
                local_base = (int(tbl.shape[0])
                              if tbl is not None
                              and hasattr(tbl, "shape") else 0)
                self._staged_ranges[name] = {
                    "version": ver, "arrays": arrays,
                    "lo": lo, "hi": hi,
                    "to_shard": int(msg["to_shard"]),
                    "local_base": local_base,
                    "round": int(msg.get("mig_round", 0)),
                    "watermark": dict(msg.get("watermark") or {})}
            _flight.record("ps.range_migration_install", var=name,
                           lo=lo, hi=hi, version=ver,
                           round=int(msg.get("mig_round", 0)))
            return {"ok": True, "staged": True,
                    "local_base": local_base}, b""
        if kind == "migrate_range_commit":
            if not self._active_role():
                return {"ok": False, "not_primary": True,
                        "error": "migrate_range_commit sent to "
                        "non-active endpoint %s"
                        % self._own_endpoint}, b""
            name = str(msg["name"])
            ver = int(msg["mig_version"])
            lo, hi = int(msg["lo"]), int(msg["hi"])
            with self._lock:
                for r in self._range_overrides.get(name, ()):
                    if (int(r["lo"]) == lo and int(r["hi"]) == hi
                            and r.get("committed")
                            and int(r.get("version", 0)) >= ver):
                        return {"ok": True,
                                "already_committed": True}, b""
                st = self._staged_ranges.get(name)
                if st is None or int(st["version"]) != ver:
                    return {"ok": False, "error":
                            "no staged range of %r at version %d on %s"
                            % (name, ver, self._own_endpoint)}, b""
                tbl = self._executor._read_var(self._scope, name)
                height = (int(tbl.shape[0])
                          if tbl is not None
                          and hasattr(tbl, "shape") else 0)
                if height != int(st["local_base"]):
                    # the landing zone drifted since the stage (a
                    # concurrent migration grew the table): refuse —
                    # the donor re-installs against the fresh base
                    self._staged_ranges.pop(name, None)
                    return {"ok": False, "error":
                            "staged local base %d of %r no longer "
                            "matches table height %d — re-install"
                            % (int(st["local_base"]), name,
                               height)}, b""
                self._commit_staged_range_locked(name)
            return {"ok": True}, b""
        if kind == "lease_renew":
            with self._lock:
                epoch = int(msg.get("epoch", 0))
                if epoch < self._seen_epoch or (
                        self._active_role() and epoch < self._epoch):
                    _counter("ps.fence_refused").inc()
                    _flight.record("ps.fence_refused",
                                   kind="lease_renew", epoch=epoch,
                                   seen=max(self._seen_epoch,
                                            self._epoch),
                                   shard=self._shard)
                    return {"ok": False, "fenced": True,
                            "epoch": max(self._seen_epoch,
                                         self._epoch)}, b""
                if self._active_role() and epoch > self._epoch:
                    # a legitimately elected higher-epoch primary is
                    # renewing at us: we are the stale one
                    self._demote_locked(epoch, "renewal from higher-"
                                        "epoch primary %s"
                                        % msg.get("frm"))
                self._refresh_lease_locked(epoch)
                return {"ok": True, "round": self._applied_round,
                        "epoch": self._seen_epoch}, b""
        if kind == "vote":
            with self._lock:
                epoch = int(msg.get("epoch", 0))
                cand_round = int(msg.get("cand_round", -1))
                cand = msg.get("candidate")
                # Raft votedFor semantics: the SAME candidate may
                # re-collect a promise at the SAME epoch — an injected
                # fault (or real packet loss) eating the grant reply
                # must not burn the epoch and livelock every retry
                fresh = epoch > max(self._promised_epoch,
                                    self._seen_epoch, self._epoch)
                re_grant = (epoch == self._promised_epoch
                            and cand is not None
                            and cand == self._promised_to
                            and epoch > max(self._seen_epoch,
                                            self._epoch))
                granted = (self._lease_mode()
                           and not self._active_role()
                           and self._lease_expired_locked()
                           and (fresh or re_grant)
                           and cand_round >= self._applied_round)
                if granted:
                    self._promised_epoch = epoch
                    self._promised_to = cand
                resp = {"ok": True, "granted": granted,
                        "round": self._applied_round,
                        "epoch": self._seen_epoch,
                        "active": self._active_role()}
            _flight.record("ps.vote", candidate=msg.get("candidate"),
                           epoch=int(msg.get("epoch", 0)),
                           granted=bool(resp["granted"]),
                           voter=self._own_endpoint)
            return resp, b""
        if kind == "repl_status":
            with self._lock:
                return {"ok": True, "active": self._active_role(),
                        "caught_up": self._caught_up,
                        "round": self._applied_round,
                        "index": self._index,
                        "epoch": self._epoch,
                        "seen_epoch": self._seen_epoch,
                        "lease_expired": (self._lease_mode()
                                          and self._lease_expired_locked()
                                          )}, b""
        if kind == "join_backup":
            # a relaunched server catching up: snapshot the scope into
            # its directory AND splice it back into the replication
            # stream in the same locked step, so every round applied
            # after the snapshot reaches it
            if not self._active_role():
                return {"ok": False, "error":
                        "join_backup sent to non-active endpoint %s"
                        % self._own_endpoint}, b""
            ep = msg.get("endpoint", "")
            with self._lock:
                snapshot_scope_to_dir(self._executor, self._scope,
                                      msg.get("dir", ""),
                                      names_map=True)
                # NOT the live _last_seq: a mid-round join must ship
                # the watermark of the state in the snapshot, or the
                # pending round's replays would be falsely skipped
                wm = dict(self._applied_watermark)
                if ep:
                    self._repl_dead.discard(ep)
                resp = {"ok": True, "round": self._applied_round,
                        "watermark": wm, "epoch": self._epoch}
                resp.update(self._repl_extra_locked())
                return resp, b""
        if kind == "heartbeat":
            with self._lock:
                evicted = sorted(self._evicted)
                eff = self._effective_fanin()
                smap = self._shard_map_payload_locked()
            return {"ok": True,
                    "status": {str(k): v
                               for k, v in
                               self.monitor.status().items()},
                    "evicted": evicted,
                    "fanin": self._fanin,
                    "effective_fanin": eff,
                    "active": self._active_role(),
                    "round": self._applied_round,
                    # process-wide counters, surfaced so an external
                    # probe (tests, the CI smoke) can assert on
                    # recovery without reaching into this process
                    "evictions": _counter("ps.evictions").value,
                    "readmissions": _counter("ps.readmissions").value,
                    "promotions": _counter("ps.promotions").value,
                    "shard_map": smap,
                    }, b""
        if kind == "shutdown":
            self._shutdown.set()
            with self._lock:
                self._cond.notify_all()
            return {"ok": True}, b""
        return {"ok": False, "error": "unknown kind %r" % kind}, b""

    def _traced_handle(self, msg: dict, raw: bytes):
        """Flight-record the incoming rpc token and run the handler
        under the client's propagated trace context (when the header
        carries one): the server span parents to the client's round /
        request span, and anything the handler does downstream — the
        optimize apply, a replication rpc to a backup — joins the same
        cross-process trace via the thread-local current context."""
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
        """Dedupe + handle one request. The client resends after a
        reconnect; a resend may arrive (a) after the original completed
        — return the cached response — or (b) while the original is
        STILL EXECUTING (it blocked in a barrier wait): wait on its
        completion event instead of running the handler twice, which
        would double-count a barrier / double-apply a grad. A resend of
        a request OLDER than the client's latest (a duplicated frame
        surfacing late) is answered with a stale marker and NEVER
        re-executed — the client discards the reply by seq anyway."""
        seq = msg.get("seq") if isinstance(msg, dict) else None
        cid = msg.get("cid") if isinstance(msg, dict) else None
        if seq is None or cid is None:
            return self._traced_handle(msg, raw)
        if (msg.get("kind") in ("send_grad", "send_barrier",
                                "push_sparse")
                and seq <= int(self._repl_watermark.get(cid, 0))):
            # failover replay of an rpc whose effect is already folded
            # into the replicated state this server holds (the
            # watermark travelled with the round stream / snapshot):
            # acknowledge without re-executing — exactly-once across
            # the promotion
            return {"ok": True, "replayed": True}, b""
        # the dedup token: the client's per-incarnation random nonce
        # (its trainer_id stand-in that survives nothing), the sync
        # round it believes it is in, and its per-connection sequence
        key = (msg.get("round", 0), seq)
        with self._dedupe_lock:
            cached = self._dedupe.get(cid)
            if cached is not None and cached[0] == key:
                ev = cached[1]
            elif seq <= self._last_seq.get(cid, 0):
                # duplicate of an ALREADY-SUPERSEDED request (a dup'd
                # frame surfacing after newer traffic): executing it
                # again would double-apply; its original response is
                # gone, so answer with a stale marker. (A legitimate
                # retry whose completed entry was LRU-pruned — >512
                # live cids between response loss and resend — also
                # lands here and fails loudly: exactly-once is kept at
                # the price of that narrow hard-fail; raise _DEDUPE_CAP
                # if a deployment actually churns that many clients.)
                return {"ok": False, "stale": True,
                        "error": "stale duplicate (seq %s <= %s)"
                        % (seq, self._last_seq.get(cid, 0))}, b""
            else:
                # dict insertion order doubles as the LRU order:
                # re-insert on every update so the oldest entry is
                # the longest-idle client
                prev_seq = int(self._last_seq.pop(cid, 0))
                self._last_seq[cid] = int(seq)
                ev = threading.Event()
                self._dedupe[cid] = [key, ev, None, b"", time.time()]
                if len(self._dedupe) > self._DEDUPE_CAP:
                    self._prune_dedupe_locked()
                cached = None
        if cached is not None:  # duplicate: original owns the handler
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
        if isinstance(resp, dict) and (resp.get("not_primary")
                                       or resp.get("wrong_shard")):
            # a redirect is NOT an execution: un-record the token so a
            # client's lease-wait retry (or its re-route of the SAME
            # rpc to the migrated var's real owner) re-runs the
            # handler exactly once — a cached redirect would poison
            # every retry of that token forever
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
        """Cap the per-client caches: drop the least-recently-used
        completed RESPONSE entries (heartbeater clients come and go; an
        unbounded dict would grow with every incarnation). The tiny
        ``_last_seq`` watermark is kept much longer — pruning it with
        the response would re-open the stale-duplicate double-apply
        window for a still-live client — and is itself LRU-capped far
        above the response cache, where only long-dead clients fall
        off the end."""
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
                # catch ANY handler error (malformed message, bad dtype,
                # missing keys) and reply — a dead connection thread
                # would leave the client blocked until its own timeout
                try:
                    resp, rraw = self._dispatch(msg, raw)
                except Exception as e:
                    resp, rraw = {"ok": False, "error": "%s: %s"
                                  % (type(e).__name__, e)}, b""
                if isinstance(msg, dict) and msg.get("seq") is not None:
                    # echo the token: the retrying client matches
                    # responses by seq and discards strays from dup'd
                    # frames
                    resp.setdefault("seq", msg.get("seq"))
                    resp.setdefault("cid", msg.get("cid"))
                if self._evict_after > 0:
                    # advertise the eviction deadline: clients of an
                    # eviction-armed server MUST heartbeat while their
                    # main socket is blocked in a barrier, or a healthy
                    # straggler round would read as death — the client
                    # auto-arms its heartbeater off this field
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
                    break  # listening socket closed by stop()
                t = threading.Thread(target=self._serve_conn,
                                     args=(conn,), daemon=True)
                t.start()
                if len(self._threads) > 64:
                    # churning heartbeat clients reconnect forever;
                    # finished handler threads must not pile up
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
        """Tear the server down NOW: wake blocked rounds, close the
        listening socket (the bound port is released even while a
        client is mid-frame), sever live connections, and join the
        worker threads. Idempotent; safe from any thread."""
        self._shutdown.set()
        with self._lock:
            self._cond.notify_all()
        try:
            self._sock.close()
        except OSError:
            pass
        for c in (list(self._repl_clients.values())
                  + list(self._mig_clients.values())):
            try:
                c.close()
            except OSError:
                pass
        self._repl_clients.clear()
        self._mig_clients.clear()
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


class _NotPrimary(_RetryableRPC):
    """The endpoint answered ``not_primary`` — advance along the
    endpoint list instead of burning the retry budget."""


class WrongShard(RuntimeError):
    """The endpoint answered ``wrong_shard`` — the named var was
    MIGRATED to another shard group. Carries the server's
    shard map so the sharded router updates its routing and reissues
    the rpc (with a fresh token, at the real owner — the redirecting
    server un-recorded the original, so the rpc still executes
    exactly once)."""

    def __init__(self, what: str, shard_map: Optional[dict] = None,
                 name: Optional[str] = None):
        super().__init__(what)
        self.shard_map = shard_map or {}
        self.name = name


class PSClient:
    """One persistent connection per (endpoint, trainer) —
    grpc_client.cc keeps channels the same way. Every call retries
    with bounded exponential backoff + jitter on timeout/EOF/conn loss
    (``PADDLE_PS_RPC_RETRIES``, default 3); the ``(cid, round, seq)``
    dedup token makes the resend of a non-idempotent rpc
    (send_grad/barriers) safe — the server executes it exactly once.

    ``endpoint`` may be a comma-separated primary + backups list
    (``PADDLE_PSERVER_ENDPOINTS``): when the retry budget on the
    current endpoint is exhausted by TRANSPORT failures, the client
    fails over to the next endpoint, replays its round log of
    non-idempotent rpcs with their original dedup tokens, and reissues
    the in-flight rpc (see the module docstring)."""

    _clients: Dict[tuple, "PSClient"] = {}
    _lock = threading.Lock()

    def __init__(self, endpoint: str, trainer_id: Optional[int] = 0,
                 timeout: Optional[float] = None,
                 auto_heartbeat: bool = True,
                 rpc_deadline: Optional[float] = None,
                 max_retries: Optional[int] = None):
        self._endpoints = [e.strip() for e in str(endpoint).split(",")
                           if e.strip()]
        if not self._endpoints:
            raise ValueError("PSClient needs at least one endpoint")
        self._ep_idx = 0
        self._trainer_id = trainer_id
        # auto-arm the background heartbeater when the server turns
        # out to be eviction-armed (its responses advertise
        # evict_after). Off for the heartbeater's own inner client.
        self._auto_heartbeat = bool(auto_heartbeat)
        self._timeout = timeout if timeout is not None else float(
            os.environ.get("PADDLE_PS_CONNECT_TIMEOUT", "15"))
        # per-ATTEMPT read deadline: must exceed the server round
        # timeout so only a dead/hung server trips it
        self._rpc_deadline = rpc_deadline if rpc_deadline is not None \
            else float(os.environ.get("PADDLE_PS_RPC_DEADLINE",
                                      str(_ROUND_TIMEOUT + 30.0)))
        self._max_retries = max_retries if max_retries is not None \
            else int(os.environ.get("PADDLE_PS_RPC_RETRIES", "3"))
        # failover budget: total endpoint advances per CALL (0 when
        # there is nowhere to go)
        self._max_failovers = int(os.environ.get(
            "PADDLE_PS_FAILOVER_MAX",
            str(2 * max(0, len(self._endpoints) - 1))))
        self._failover_count = 0  # the "fo" epoch carried on every rpc
        # non-idempotent rpcs in flight, with their stamped dedup
        # tokens — replayed verbatim on a failover. Entries are
        # [msg, raw, pending_round]: SYNC entries clear when the
        # round's barrier commits (the round is then applied AND
        # replicated on every shard the caller barriers); ASYNC
        # entries are round-gated — the server's ack tags each op with
        # the replication round that will carry it (pending_round) and
        # reports the last replicated round (durable_round), and an
        # entry is pruned only once its round is durable, making a
        # failover mid-async-push exactly-once
        self._replay_log: List[list] = []
        # sharded mode: the ShardedPSClient owns phase 2 of the round
        # barrier — this shard's log survives until EVERY shard acked
        self._defer_barrier_commit = False
        # total seconds per call a client will wait at a mid-promotion
        # backup (lease_wait_ms hints) before treating it as one more
        # failover hop
        self._lease_wait_s = float(
            os.environ.get("PADDLE_PS_LEASE_WAIT_S", "20"))
        self._replay_cap = int(
            os.environ.get("PADDLE_PS_REPLAY_LOG_CAP", "1024"))
        self._replay_overflowed = False
        self._backoff_base = float(
            os.environ.get("PADDLE_PS_RPC_BACKOFF_MS", "50")) / 1e3
        self._backoff_cap = float(
            os.environ.get("PADDLE_PS_RPC_BACKOFF_CAP_MS", "2000")) / 1e3
        # a failover probes endpoints that may be dead: use a short
        # connect window, not the boot-tolerant default
        self._failover_connect = float(os.environ.get(
            "PADDLE_PS_FAILOVER_CONNECT_TIMEOUT",
            str(min(self._timeout, 5.0))))
        # the sharded router's adopted map version, stamped (``mv``)
        # on every rpc so a recipient can tell a map-bump-proving
        # client from a hash-routed stale one
        self._map_version_hint: Optional[int] = None
        self._io_lock = threading.Lock()
        self._seq = 0  # per-client sequence: lets the server dedupe the
        # reconnect-resend in _call (send_grad/barriers are not
        # idempotent without it). The random client nonce scopes seq so
        # a RESTARTED trainer's fresh seq=1 never matches a stale cache
        # entry from its previous incarnation.
        self._round = 0  # completed send_barriers (the dedup token's
        # round component: (cid, round, seq))
        self._cid = os.urandom(8).hex()
        # one TraceContext per sync round (regenerated when _round
        # advances): every rpc/retry/failover of the round rides one
        # cross-process trace. Only populated while spans are armed.
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
        try:
            self._sock = self._connect()
        except RuntimeError:
            if len(self._endpoints) == 1:
                raise
            # the primary may be down with a backup alive (a trainer
            # relaunched mid-failover): defer to the first _call,
            # whose failover path walks the rest of the list
            self._sock = None

    @property
    def _endpoint(self) -> str:
        return self._endpoints[self._ep_idx]

    @property
    def endpoint(self) -> str:
        """The endpoint currently in use (moves on failover)."""
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
                # reads get a DEADLINE above the server's round bound:
                # a functioning server always replies within
                # _ROUND_TIMEOUT (slow barriers get an error reply), so
                # a longer client deadline only fires when the server
                # is dead/hung mid-round — failing fast (then retrying
                # boundedly) instead of hanging the trainer's sync send
                # loop forever (grpc_client.cc deadline+retry).
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
        try:
            if self._sock is not None:
                self._sock.close()
        except OSError:
            pass
        self._sock = None

    # -- background heartbeat (keeps this trainer alive in the server's
    # monitor while the MAIN connection is blocked in a barrier) ---------

    def start_heartbeat(self, interval_s: float = 1.0) -> None:
        """Ping the server every ``interval_s`` from a dedicated
        connection; surfaces peer evictions (``evicted_peers``) with a
        log line so a surviving trainer knows why its barrier suddenly
        completed. Env ``PADDLE_PS_HEARTBEAT_MS`` auto-arms this for
        ``for_endpoint`` clients."""
        if self._hb_thread is not None and self._hb_thread.is_alive():
            return
        self._hb_stop.clear()

        def loop():
            hb = None
            hb_ep = None
            while not self._hb_stop.wait(interval_s):
                try:
                    if hb is not None and hb_ep != self._endpoint:
                        # the main client failed over: heartbeats must
                        # follow it — pinging the abandoned endpoint
                        # keeps nobody alive anywhere
                        hb.close()
                        hb = None
                    if hb is None:
                        hb_ep = self._endpoint
                        hb = PSClient(hb_ep,
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
                    # best-effort: a failed ping must never kill the
                    # trainer; the next tick retries (fresh connection)
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
        """One send + seq-matched receive on the cached socket; raises
        a _RetryableRPC on timeout/EOF/conn loss after dropping the
        socket (it may hold a late/partial reply — reusing it would
        desync framing or hand the NEXT call the OLD response)."""
        if self._sock is None:
            self._sock = self._connect()
        kind = msg.get("kind", "?")
        quiet = kind in _FLIGHT_QUIET
        t0 = time.perf_counter()
        if not quiet:
            _flight.record("rpc.send", kind=kind, seq=msg.get("seq"),
                           cid=msg.get("cid"), round=msg.get("round"),
                           fo=msg.get("fo"), ep=self._endpoint)
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
                    continue  # stale reply from a dup'd earlier frame
                # per-ATTEMPT reply latency (retries observe
                # separately): the axis rpc.retries lacks — a rising
                # retry rate with healthy latencies means a mis-set
                # per-attempt deadline, not a slow server
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
        """Propagate trace context on the rpc header (Dapper-style: it
        rides the existing JSON frame; old-frame peers ignore the extra
        fields). An ambient context — a serving request span, a
        server-side handler issuing replication — wins; otherwise the
        client keeps one trace per sync round so every rpc, retry, and
        failover of the round lands in a single cross-process trace.
        No-op (no id generation) while the span layer is disarmed."""
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
            msg["fo"] = self._failover_count
            if self._map_version_hint is not None:
                msg["mv"] = int(self._map_version_hint)
            self._stamp_trace(msg)
            entry = None
            if (len(self._endpoints) > 1 and msg["kind"] in
                    ("send_grad", "send_barrier", "push_sparse")):
                entry = [dict(msg), bytes(raw), None]
                self._replay_log.append(entry)
                if len(self._replay_log) > self._replay_cap:
                    self._replay_log.pop(0)
                    if not self._replay_overflowed:
                        self._replay_overflowed = True
                        print("[ps_rpc] replay log exceeded %d entries"
                              " despite round-gated pruning; oldest"
                              " rpcs age out — a failover replay will"
                              " be PARTIAL (raise"
                              " PADDLE_PS_REPLAY_LOG_CAP, or lower the"
                              " server's PADDLE_PS_ASYNC_REPL_EVERY)"
                              % self._replay_cap,
                              file=sys.stderr, flush=True)
            resp, resp_raw = self._issue(msg, raw)
            if isinstance(resp, dict) and resp.get("wrong_shard"):
                # the var migrated: this rpc never executed here, and
                # it never will — drop its replay entry and hand the
                # server's map to the sharded router for the re-route
                if entry is not None:
                    try:
                        self._replay_log.remove(entry)
                    except ValueError:
                        pass
                raise WrongShard(
                    "pserver %s no longer owns %r: %s"
                    % (self._endpoint, resp.get("name"),
                       resp.get("error")),
                    shard_map=resp.get("shard_map"),
                    name=resp.get("name"))
            if entry is not None and isinstance(resp, dict) \
                    and resp.get("pending_round") is not None:
                # async ack: the op rides this replication round
                entry[2] = int(resp["pending_round"])
            if isinstance(resp, dict) \
                    and resp.get("durable_round") is not None:
                # rounds <= durable_round are replicated: their ops
                # survive the primary and never need replaying
                dr = int(resp["durable_round"])
                self._replay_log = [
                    e for e in self._replay_log
                    if e[2] is None or e[2] > dr]
            if (msg["kind"] == "send_barrier" and resp.get("ok")
                    and not self._defer_barrier_commit):
                # the barrier returned => the round is applied AND
                # replicated: its effects survive a primary death, so
                # nothing before this point ever needs replaying
                self._replay_log.clear()
        ea = resp.get("evict_after") if isinstance(resp, dict) else None
        if ea and self._auto_heartbeat and (
                self._hb_thread is None or not self._hb_thread.is_alive()):
            # the server evicts silent trainers: keep this one alive
            # while its main socket blocks in a barrier, even when the
            # operator forgot PADDLE_PS_HEARTBEAT_MS
            self.start_heartbeat(max(0.05, float(ea) / 4.0))
        if not resp.get("ok"):
            raise RuntimeError("pserver error: %s" % resp.get("error"))
        return resp, resp_raw

    def _issue(self, msg: dict, raw: bytes):
        """Bounded retry on the current endpoint; on exhaustion (or a
        ``not_primary`` redirect) advance along the endpoint list,
        replay the round log, and reissue — bounded by the failover
        budget. io-locked by caller."""
        kind = msg.get("kind", "?")
        attempts = 0
        failovers = 0
        delay = self._backoff_base
        wait_budget = self._lease_wait_s
        last_err: Optional[Exception] = None
        while True:
            try:
                resp, resp_raw = self._attempt(msg, raw)
                if isinstance(resp, dict) and resp.get("not_primary"):
                    e = _NotPrimary(
                        "pserver %s is not the primary (%s)"
                        % (self._endpoint, resp.get("error")))
                    e.wait_ms = resp.get("lease_wait_ms")
                    raise e
                return resp, resp_raw
            except _NotPrimary as e:
                wait_ms = getattr(e, "wait_ms", None)
                if wait_ms and wait_budget > 0:
                    # the backup is mid-promotion (waiting out the
                    # dead primary's lease / gathering its quorum):
                    # hold HERE instead of burning failover budget on
                    # redirect loops — bounded by the wait budget
                    dt = min(float(wait_ms) / 1e3, 0.3)
                    wait_budget -= dt
                    time.sleep(dt)
                    attempts, delay = 0, self._backoff_base
                    continue
                # a redirect, not a transport failure: advance without
                # burning the retry budget
                last_err = e
                failovers += 1
                if failovers > self._max_failovers:
                    raise RuntimeError(
                        "%s — no endpoint in %s accepted the dataplane "
                        "after %d failover(s)"
                        % (e, self._endpoints, failovers - 1)) from e
                self._failover(e, msg, redirect=True)
                attempts, delay = 0, self._backoff_base
            except _RetryableRPC as e:
                attempts += 1
                last_err = e
                if attempts > self._max_retries:
                    failovers += 1
                    if failovers > self._max_failovers:
                        raise RuntimeError(
                            "%s — gave up after %d attempt(s); the "
                            "server is dead or hung (raise "
                            "PADDLE_PS_RPC_DEADLINE / "
                            "PADDLE_PS_RPC_RETRIES if rounds "
                            "legitimately run longer)"
                            % (e, attempts)) from e
                    self._failover(e, msg)
                    attempts, delay = 0, self._backoff_base
                    continue
                _counter("rpc.retries", method=kind).inc()
                # exponential backoff + jitter (grpc_client.cc
                # retry semantics); the dedup token makes the
                # reissue safe even for non-idempotent kinds
                time.sleep(delay * (0.5 + self._jitter.random()))
                delay = min(delay * 2.0, self._backoff_cap)
            except RuntimeError as e:
                # the RECONNECT inside a retry failed (server gone
                # or its backlog full of our own dead sockets)
                failovers += 1
                if failovers > self._max_failovers:
                    # keep the error that started the retrying — "why
                    # it failed" beats "why the retry failed"
                    if last_err is not None:
                        raise RuntimeError(
                            "%s (while reconnecting after: %s)"
                            % (e, last_err)) from e
                    raise
                self._failover(last_err if last_err is not None else e,
                               msg)
                attempts, delay = 0, self._backoff_base

    def _failover(self, cause: Exception, msg: dict,
                  redirect: bool = False) -> None:
        """Advance to the next endpoint that accepts a connection and
        the round-log replay (deterministic list order — the
        lowest-index live endpoint ends up promoted). Raises
        RuntimeError when no endpoint works."""
        n = len(self._endpoints)
        start = self._ep_idx
        self._failover_count += 1
        msg["fo"] = self._failover_count
        t0 = time.perf_counter()
        _flight.record("rpc.failover.begin",
                       frm=self._endpoints[start], fo=self._failover_count,
                       cause=type(cause).__name__,
                       redirect=bool(redirect))
        last: Exception = cause
        wait_budget = self._lease_wait_s
        k = 1
        while k < n:
            self._ep_idx = (start + k) % n
            self._drop_sock()
            try:
                self._sock = self._connect(
                    timeout=self._failover_connect)
                self._replay()
            except _NotPrimary as e:
                wait_ms = getattr(e, "wait_ms", None)
                if wait_ms and wait_budget > 0:
                    # the replay target is mid-promotion: wait it out
                    # on THIS endpoint instead of walking on (the rest
                    # of the list is the dead primary)
                    dt = min(float(wait_ms) / 1e3, 0.3)
                    wait_budget -= dt
                    time.sleep(dt)
                    continue
                last = e
                self._drop_sock()
                k += 1
                continue
            except (_RetryableRPC, RuntimeError, OSError) as e:
                last = e
                self._drop_sock()
                k += 1
                continue
            _counter("ps.failovers",
                     cause="redirect" if redirect else "transport").inc()
            _flight.record("rpc.failover", frm=self._endpoints[start],
                           to=self._endpoint, fo=self._failover_count,
                           replayed=len(self._replay_log))
            # the span the merged timeline shows the failover as:
            # parented into the round trace the failed
            # rpc belongs to, covering connect + replay
            _dtrace.record_span(
                "ps.failovers", t0, cat="rpc",
                trace_id=msg.get("trace_id"),
                parent_span=msg.get("parent_span"),
                cause="redirect" if redirect else "transport",
                frm=self._endpoints[start], to=self._endpoint)
            print("[ps_rpc] trainer %s failed over %s -> %s "
                  "(replayed %d rpc(s); after: %s)"
                  % (self._trainer_id,
                     self._endpoints[start], self._endpoint,
                     len(self._replay_log), cause),
                  file=sys.stderr, flush=True)
            return
        self._ep_idx = start
        _flight.record("rpc.failover.failed", frm=self._endpoints[start],
                       fo=self._failover_count)
        raise RuntimeError(
            "no reachable pserver among %s (last failover error: %s; "
            "failing over after: %s)" % (self._endpoints, last, cause))

    def _replay(self) -> None:
        """Reissue the round log on the endpoint just connected, with
        the ORIGINAL dedup tokens: rpcs the new primary already holds
        (via replication) are acknowledged as ``replayed`` without
        re-executing; the rest rebuild the in-flight round."""
        _flight.record("rpc.replay", n=len(self._replay_log),
                       ep=self._endpoint)
        for m, r, _pending in list(self._replay_log):
            m["fo"] = self._failover_count
            delay = self._backoff_base
            for attempt in range(self._max_retries + 1):
                try:
                    resp, _ = self._attempt(m, r)
                    break
                except _RetryableRPC:
                    # transient fault on an otherwise-healthy new
                    # endpoint (e.g. an injected drop): retry HERE —
                    # advancing past it would abandon a live primary
                    if attempt >= self._max_retries:
                        raise
                    _counter("rpc.retries",
                             method=m.get("kind", "?")).inc()
                    time.sleep(delay * (0.5 + self._jitter.random()))
                    delay = min(delay * 2.0, self._backoff_cap)
            if resp.get("not_primary"):
                e = _NotPrimary(
                    "pserver %s refused the failover replay"
                    % self._endpoint)
                e.wait_ms = resp.get("lease_wait_ms")
                raise e
            if not (resp.get("ok") or resp.get("replayed")
                    or resp.get("stale")):
                raise RuntimeError(
                    "pserver error during failover replay of %s: %s"
                    % (m.get("kind"), resp.get("error")))

    def send_grad(self, name: str, value, round: Optional[int] = None
                  ) -> None:
        """``round`` (optional) is the TRAINING round this grad
        belongs to — workers that track one stamp it (``tr`` on the
        wire) so a server that already applied that round (eviction
        sailed it without this trainer) drops the re-send instead of
        folding it into the NEXT round."""
        arr = np.ascontiguousarray(host_array(value))
        msg = {"kind": "send_grad", "name": name,
               "array": _array_header(arr)}
        if round is not None:
            msg["tr"] = int(round)
        self._call(msg, arr.tobytes())

    def seed_round(self, n: int) -> None:
        """Floor the completed-round counter: a trainer
        resuming after a whole-job cold restart seeds the job restore
        cut — the servers' applied round — so the server-side
        stale-primary guard starts from the restored state instead of
        zero. Callers must also fast-forward their training loop past
        the cut: seeding it and then RE-DRIVING older rounds would
        push this counter past the servers' applied round, which
        reads as 'refusing to serve stale params' on every pull."""
        self._round = max(self._round, int(n))

    def send_barrier(self, round: Optional[int] = None) -> None:
        self.barrier_prepare(round=round)
        self._round += 1

    def barrier_prepare(self, round: Optional[int] = None) -> dict:
        """Phase 1 of the two-phase round barrier: issue the barrier
        rpc. With ``_defer_barrier_commit`` set (sharded mode) the
        replay log SURVIVES this shard's ack — the round is durable
        only when every shard acked, so a sister shard's failover can
        still replay this round here (the dedup watermark makes that
        exactly-once). Single-group clients clear on ack as before.
        Returns the server's response — it may carry the current
        ``shard_map`` (the atomic adoption point for live migrations)
        and, with ``round`` stamped, ``stale_round`` when this
        training round already applied here."""
        msg = {"kind": "send_barrier"}
        if round is not None:
            msg["tr"] = int(round)
        resp, _ = self._call(msg)
        return resp

    def barrier_commit(self) -> None:
        """Phase 2 (sharded mode): every shard acked its barrier — the
        round is durable everywhere, drop the replay log and advance
        the round."""
        with self._io_lock:
            self._replay_log.clear()
        self._round += 1

    def get_param(self, name: str) -> np.ndarray:
        resp, raw = self._call({"kind": "get_param", "name": name})
        return _array_from(resp["array"], raw)

    def fetch_barrier(self) -> None:
        self._call({"kind": "fetch_barrier"})

    def pull_sparse(self, name: str, row_ids) -> np.ndarray:
        """Pull value rows for LOCAL row ids from this server's table
        shard (pslib PullSparseVarsSync counterpart)."""
        ids = np.ascontiguousarray(np.asarray(row_ids, dtype=np.int64))
        resp, raw = self._call({"kind": "pull_sparse", "name": name,
                                "array": _array_header(ids)},
                               ids.tobytes())
        return _array_from(resp["array"], raw)

    def push_sparse(self, name: str, rows, values, param: str = "",
                    global_height: Optional[int] = None) -> None:
        """Push (local row ids, grad rows) to this server's shard; the
        server applies its optimize block immediately (async, pslib
        PushSparseVarsAsync counterpart). ``param`` names the table var
        so the server can size the SelectedRows height.
        ``global_height`` is the table's GLOBAL height when the caller
        slices a range-partitioned table (the sharded router): the
        server's ``ps.table_rows`` gauge reports it so the hot-shard
        steerer sizes plans from the whole table, not this shard's
        slice."""
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

    def replicate(self, round_no: int, var_headers: List[dict],
                  raw: bytes, watermark: Dict[str, int],
                  mode: str = "full",
                  base_round: Optional[int] = None,
                  epoch: int = 0,
                  extra: Optional[dict] = None) -> dict:
        """Primary-side: ship one applied round (full anchor or
        changed-vars/rows/chunks delta + dedup watermark) to the
        backup this client points at; returns the backup's ack —
        which may carry ``repl_gap`` (re-anchor me) or ``fenced`` (a
        newer epoch rules; demote yourself). ``extra`` carries the
        shard-map / migration fields."""
        msg = {"kind": "replicate", "repl_round": int(round_no),
               "vars": var_headers, "watermark": watermark,
               "repl_mode": mode,
               "repl_base_round": (-1 if base_round is None
                                   else int(base_round)),
               "epoch": int(epoch)}
        if extra:
            msg.update(extra)
        resp, _ = self._call(msg, raw)
        return resp

    def repl_status(self) -> dict:
        """role/round probe: ``{"active":, "caught_up":, "round":}``."""
        resp, _ = self._call({"kind": "repl_status"})
        return resp

    def migrate(self, name: str, to_shard: int,
                to_endpoints: str) -> dict:
        """Ask THIS endpoint chain's primary (the donor) to migrate
        var ``name`` to the group at ``to_endpoints`` (shard index
        ``to_shard``). The transfer executes at the donor's next
        round barrier; the ack only records the intent."""
        resp, _ = self._call({"kind": "migrate_begin",
                              "name": name,
                              "to_shard": int(to_shard),
                              "to_endpoints": str(to_endpoints)})
        return resp

    def migrate_range(self, name: str, lo: int, hi: int,
                      src_lo: int, src_hi: int, to_shard: int,
                      to_endpoints: str) -> dict:
        """Ask THIS endpoint chain's primary (the donor) to migrate
        rows ``[lo, hi)`` (GLOBAL ids; ``src_lo``/``src_hi`` the
        donor-LOCAL window) of sparse table ``name`` to the group at
        ``to_endpoints``. The transfer executes at the donor's next
        round barrier; the ack only records the intent."""
        resp, _ = self._call({"kind": "migrate_range_begin",
                              "name": name,
                              "lo": int(lo), "hi": int(hi),
                              "src_lo": int(src_lo),
                              "src_hi": int(src_hi),
                              "to_shard": int(to_shard),
                              "to_endpoints": str(to_endpoints)})
        return resp

    def heartbeat(self) -> Dict[int, float]:
        resp, _ = self._call({"kind": "heartbeat"})
        return {int(k): v for k, v in resp["status"].items()}

    def heartbeat_full(self) -> dict:
        """Full heartbeat response: per-trainer ages plus ``evicted``
        / ``fanin`` / ``effective_fanin`` (the log-and-continue signal
        for survivors)."""
        resp, _ = self._call({"kind": "heartbeat"})
        return resp

    def shutdown_server(self) -> None:
        self._call({"kind": "shutdown"})


class PSWitness:
    """External quorum witness: a tiny vote-only endpoint
    OUTSIDE every replication group, named by ``PADDLE_PS_WITNESSES``
    (comma-separated) in each ``PSServer``'s environment. Primaries
    renew their lease with it exactly like with group peers (the
    renewal carries ``shard`` + ``lease_ms``, so ONE witness serves
    every shard of a job); a candidate's election additionally needs
    at least one live witness GRANT, and the witness grants only when
    its OWN per-shard lease view expired — positive evidence the
    primary stopped renewing, which a forged connection-REFUSED
    tombstone cannot fake. A shard the witness never heard a renewal
    for starts with a boot-grace lease (it must not rubber-stamp the
    first election it ever sees). Holds no parameter state; restart
    at will.

    Counters: ``ps.witness_votes{shard=}`` (every vote handled; the
    grant rides the flight line ``ps.witness_vote``) and
    ``ps.witness_renewals{shard=}``."""

    def __init__(self, endpoint: str):
        host, port = endpoint.rsplit(":", 1)
        self.endpoint = endpoint
        if _fault.get_identity() is None:
            _fault.set_identity(endpoint)
        # shard -> {"deadline", "lease_s", "seen_epoch", "promised"}
        self._state: Dict[str, dict] = {}
        self._lock = threading.Lock()
        self._shutdown = threading.Event()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host or "127.0.0.1", int(port)))
        self._sock.listen(16)
        self._threads: List[threading.Thread] = []

    def _shard_state_locked(self, shard: str, lease_ms) -> dict:
        st = self._state.get(shard)
        if st is None:
            lease_s = max(float(lease_ms or 1500.0) / 1e3, 0.05)
            st = {"deadline": _lease_deadline_in(lease_s),
                  "lease_s": lease_s, "seen_epoch": 0, "promised": 0}
            self._state[shard] = st
        return st

    def _handle(self, msg: dict, raw: bytes):
        kind = msg.get("kind")
        shard = str(msg.get("shard", "0"))
        if kind == "lease_renew":
            with self._lock:
                st = self._shard_state_locked(shard,
                                              msg.get("lease_ms"))
                epoch = int(msg.get("epoch", 0))
                if epoch < st["seen_epoch"]:
                    return {"ok": False, "fenced": True,
                            "epoch": st["seen_epoch"]}, b""
                st["seen_epoch"] = max(st["seen_epoch"], epoch)
                if msg.get("lease_ms"):
                    st["lease_s"] = max(
                        float(msg["lease_ms"]) / 1e3, 0.05)
                st["deadline"] = _lease_deadline_in(st["lease_s"])
            _counter("ps.witness_renewals", shard=shard).inc()
            return {"ok": True, "epoch": int(msg.get("epoch", 0))}, b""
        if kind == "vote":
            with self._lock:
                st = self._shard_state_locked(shard,
                                              msg.get("lease_ms"))
                epoch = int(msg.get("epoch", 0))
                cand = msg.get("candidate")
                # votedFor: the same candidate may re-collect a
                # promise whose grant reply was lost on the wire —
                # a burned epoch must not livelock its retries
                fresh = epoch > max(st["promised"], st["seen_epoch"])
                re_grant = (epoch == st["promised"]
                            and cand is not None
                            and cand == st.get("promised_to")
                            and epoch > st["seen_epoch"])
                granted = (time.monotonic() > st["deadline"]
                           and (fresh or re_grant))
                if granted:
                    st["promised"] = epoch
                    st["promised_to"] = cand
            _counter("ps.witness_votes", shard=shard).inc()
            _flight.record("ps.witness_vote", shard=shard,
                           candidate=msg.get("candidate"),
                           epoch=int(msg.get("epoch", 0)),
                           granted=granted, witness=self.endpoint)
            # round -1: a witness holds no rounds and never vetoes a
            # candidate's staleness — that is the group voters' job
            return {"ok": True, "granted": granted, "round": -1,
                    "witness": True}, b""
        if kind == "witness_status":
            with self._lock:
                return {"ok": True, "witness": True,
                        "shards": {s: {
                            "expired": time.monotonic() > st["deadline"],
                            "seen_epoch": st["seen_epoch"],
                            "promised": st["promised"]}
                            for s, st in self._state.items()}}, b""
        if kind == "shutdown":
            self._shutdown.set()
            return {"ok": True}, b""
        # anything else (a misrouted dataplane rpc): loud refusal
        return {"ok": False, "witness": True,
                "error": "witness %s only answers lease_renew/vote, "
                "got %r" % (self.endpoint, kind)}, b""

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._shutdown.is_set():
                got = _recv_msg(conn)
                if got is None:
                    return
                msg, raw = got
                try:
                    resp, rraw = self._handle(msg, raw)
                except Exception as e:
                    resp, rraw = {"ok": False, "error": "%s: %s"
                                  % (type(e).__name__, e)}, b""
                if isinstance(msg, dict) and msg.get("seq") is not None:
                    resp.setdefault("seq", msg.get("seq"))
                    resp.setdefault("cid", msg.get("cid"))
                _send_msg(conn, resp, rraw)
        except OSError:
            pass
        finally:
            conn.close()

    def serve_forever(self) -> None:
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
                    break
                t = threading.Thread(target=self._serve_conn,
                                     args=(conn,), daemon=True)
                t.start()
                if len(self._threads) > 64:
                    # every renewal sweep opens a fresh connection;
                    # finished handler threads must not pile up for
                    # the lifetime of the job
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
                             name="ps-witness", daemon=True)
        t.start()
        self._threads.append(t)
        return t

    def stop(self) -> None:
        self._shutdown.set()
        try:
            self._sock.close()
        except OSError:
            pass
