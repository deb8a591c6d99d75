"""Cross-worker record exchange for Dataset.global_shuffle.

The port of ``paddle_tpu/distributed/record_shuffle.py``. The
reference's DatasetImpl::GlobalShuffle (``framework/data_set.h``)
re-distributes
in-memory records ACROSS nodes through FleetWrapper RPC before local
shuffling — without it, each worker only ever sees its own file shard.
This module is that exchange over the same socket framing ps_rpc uses:
every worker runs a small record server; records are routed to
``crc32(record) % n_workers`` (content-stable, so every process computes
the same destination), shipped to their owners, and merged with the
locally-kept set. A done-barrier makes the result complete before
return.
"""
from __future__ import annotations

import socket
import threading
import time
import zlib
from typing import Dict, List, Tuple

import numpy as np
import torch

from .ps_rpc import _array_header, _recv_msg, _send_msg, host_array

_TIMEOUT = 120.0


def _serialize_record(rec: dict) -> Tuple[List[dict], bytes]:
    """One record {var name -> LoDTensor | ndarray} -> (meta, raw)."""
    from ..core.tensor import LoDTensor

    metas, chunks = [], []
    for name in sorted(rec):
        v = rec[name]
        if isinstance(v, LoDTensor):
            arr = np.ascontiguousarray(host_array(v.array))
            lod = [list(map(int, l)) for l in (v.lod() or [])]
        else:
            arr = np.ascontiguousarray(host_array(v))
            lod = []
        m = _array_header(arr)
        m["name"] = name
        m["lod"] = lod
        metas.append(m)
        chunks.append(arr.tobytes())
    return metas, b"".join(chunks)


def _deserialize_record(metas: List[dict], raw: bytes) -> dict:
    from ..core.tensor import LoDTensor

    rec, off = {}, 0
    for m in metas:
        n = int(np.dtype(m["dtype"]).itemsize
                * int(np.prod(m["shape"]) if m["shape"] else 1))
        arr = np.frombuffer(raw[off:off + n],
                            dtype=m["dtype"]).reshape(m["shape"]).copy()
        off += n
        if m.get("lod"):
            t = LoDTensor(torch.from_numpy(arr))
            t.set_lod([list(l) for l in m["lod"]])
            rec[m["name"]] = t
        else:
            rec[m["name"]] = arr
    return rec


class _RecordServer:
    """Accepts "put" (a batch of serialized records) and "done" messages
    from peer workers."""

    def __init__(self, endpoint: str, n_peers: int):
        host, port = endpoint.rsplit(":", 1)
        self.received: List[dict] = []
        self._dones = 0
        self._n_peers = n_peers
        self._cond = threading.Condition()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host or "127.0.0.1", int(port)))
        self._sock.listen(16)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        self._sock.settimeout(0.2)
        conns = []
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()
            conns.append(t)
        self._sock.close()

    def _serve_conn(self, conn):
        try:
            while True:
                got = _recv_msg(conn)
                if got is None:
                    return
                msg, raw = got
                if msg.get("kind") == "put":
                    recs, off = [], 0
                    for metas, size in zip(msg["recs"], msg["sizes"]):
                        recs.append(_deserialize_record(
                            metas, raw[off:off + size]))
                        off += size
                    with self._cond:
                        self.received.extend(recs)
                    _send_msg(conn, {"ok": True})
                elif msg.get("kind") == "done":
                    with self._cond:
                        self._dones += 1
                        self._cond.notify_all()
                    _send_msg(conn, {"ok": True})
                else:
                    _send_msg(conn, {"ok": False,
                                     "error": "unknown kind"})
        except OSError:
            pass
        finally:
            conn.close()

    def wait_all_done(self):
        deadline = time.time() + _TIMEOUT
        with self._cond:
            while self._dones < self._n_peers:
                if time.time() > deadline:
                    raise RuntimeError(
                        "global shuffle stalled: %d/%d peers done"
                        % (self._dones, self._n_peers))
                self._cond.wait(timeout=1.0)

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)


def _record_dest(metas, raw: bytes, n: int) -> int:
    """Content-stable destination: every process computes the same
    owner for the same record (crc32 of the raw payload)."""
    return zlib.crc32(raw) % n


def global_record_shuffle(records: List[dict], endpoints: List[str],
                          my_index: int) -> List[dict]:
    """Exchange ``records`` across workers; returns the records this
    worker now owns (its crc-partition of the global set)."""
    n = len(endpoints)
    if n <= 1:
        return list(records)
    server = _RecordServer(endpoints[my_index], n - 1)
    try:
        # self-owned records keep their ORIGINAL objects (no serialize
        # round-trip): routing only needs the crc of the payload
        partitions: Dict[int, list] = {k: [] for k in range(n)}
        kept: List[dict] = []
        for rec in records:
            metas, raw = _serialize_record(rec)
            dest = _record_dest(metas, raw, n)
            if dest == my_index:
                kept.append(rec)
            else:
                partitions[dest].append((metas, raw))

        deadline = time.time() + _TIMEOUT
        for k, ep in enumerate(endpoints):
            if k == my_index:
                continue
            host, port = ep.rsplit(":", 1)
            while True:  # the peer's server may still be booting
                try:
                    conn = socket.create_connection(
                        (host or "127.0.0.1", int(port)), timeout=5)
                    break
                except OSError:
                    if time.time() > deadline:
                        raise
                    time.sleep(0.2)
            try:
                batch = partitions[k]
                CHUNK = 256
                for i in range(0, len(batch), CHUNK):
                    part = batch[i:i + CHUNK]
                    _send_msg(conn, {
                        "kind": "put",
                        "recs": [m for m, _ in part],
                        "sizes": [len(r) for _, r in part],
                    }, b"".join(r for _, r in part))
                    resp = _recv_msg(conn)
                    if resp is None or not resp[0].get("ok"):
                        raise RuntimeError(
                            "shuffle put to %s failed: %r" % (ep, resp))
                _send_msg(conn, {"kind": "done"})
                resp = _recv_msg(conn)
                if resp is None or not resp[0].get("ok"):
                    raise RuntimeError("shuffle done to %s failed" % ep)
            finally:
                conn.close()

        server.wait_all_done()
        with server._cond:
            kept.extend(server.received)
        return kept
    finally:
        server.stop()
