"""Key-range sharded parameter server: the port of
``paddle_tpu/distributed/ps_shard.py`` without its live migrations.

The parameter space is partitioned over several independent server
groups, the reference's key-range-sliced tables lifted to the whole PS:

- **groups**: ``PADDLE_PSERVER_ENDPOINTS`` lists every endpoint and
  ``PADDLE_PSERVER_SHARDS=N`` slices it into N contiguous groups. The
  launcher gives each server its group's index
  (``PADDLE_PSERVER_SHARD``) and each trainer the full list and the
  count. In this port a group is one primary: backups are not ported.
- **routing**: dense vars route by a range partition of the hashed
  128-bit keyspace (``shard_for_key``, stable across processes; a var's
  ``@GRAD`` and ``@``-suffixed companions follow their base var). Sparse
  row ids route by contiguous row range (``shard_for_rows``: shard ``s``
  owns global rows ``[s*H/N, (s+1)*H/N)``), each shard holding its slice
  with LOCAL row ids.
- **two-phase round barrier**: phase 1 issues every shard's
  ``send_barrier`` in parallel; only when all acked does phase 2 advance
  each sub-client's round.

``migrate``, ``migrate_range`` and ``apply_shard_map`` (the versioned
shard map of the live migrations) raise ``NotImplementedError``.
"""
from __future__ import annotations

import hashlib
import os
import threading
from typing import List, Optional

import numpy as np

from .ps_rpc import PSClient, _refuse

__all__ = ["shard_for_key", "shard_for_rows", "row_range",
           "split_endpoint_groups", "ShardedPSClient",
           "client_from_env", "shards_from_env"]


def shard_for_key(name: str, nshards: int) -> int:
    """Range partition of the hashed keyspace: md5(base name) as a
    128-bit int, split into ``nshards`` equal ranges. A ``@``-suffixed
    name routes by its base var."""
    if nshards <= 1:
        return 0
    base = name.split("@", 1)[0]
    h = int.from_bytes(hashlib.md5(base.encode("utf-8")).digest(),
                       "big")
    return (h * int(nshards)) >> 128


def row_range(shard: int, height: int, nshards: int) -> tuple:
    """Global row range [start, stop) owned by ``shard`` of a
    height-``height`` table."""
    return (shard * height // nshards, (shard + 1) * height // nshards)


def shard_for_rows(rows, height: int, nshards: int) -> np.ndarray:
    """Shard index per global row id (contiguous range partition)."""
    rows = np.asarray(rows, dtype=np.int64)
    bounds = np.array([row_range(s, height, nshards)[0]
                       for s in range(1, nshards)], dtype=np.int64)
    return np.searchsorted(bounds, rows, side="right")


def split_endpoint_groups(endpoints: List[str],
                          nshards: int) -> List[List[str]]:
    """Slice the flat endpoint list into ``nshards`` contiguous groups
    (every group the same depth, the launch contract)."""
    eps = [e.strip() for e in endpoints if e.strip()]
    n = int(nshards)
    if n <= 1:
        return [eps]
    if not eps or len(eps) % n != 0:
        raise ValueError(
            "PADDLE_PSERVER_SHARDS=%d needs an endpoint count "
            "divisible by it, got %d endpoints %s"
            % (n, len(eps), eps))
    depth = len(eps) // n
    return [eps[i * depth:(i + 1) * depth] for i in range(n)]


def shards_from_env() -> int:
    return max(1, int(os.environ.get("PADDLE_PSERVER_SHARDS", "1")))


def client_from_env(trainer_id: int = 0,
                    endpoints: Optional[str] = None):
    """The client of the env contract: a ``PSClient`` for one group, a
    ``ShardedPSClient`` when ``PADDLE_PSERVER_SHARDS`` > 1."""
    raw = endpoints if endpoints is not None else os.environ.get(
        "PADDLE_PSERVER_ENDPOINTS", "")
    eps = [e.strip() for e in str(raw).split(",") if e.strip()]
    n = shards_from_env()
    if n <= 1:
        return PSClient.for_endpoint(",".join(eps),
                                     trainer_id=trainer_id)
    groups = split_endpoint_groups(eps, n)
    return ShardedPSClient([",".join(g) for g in groups],
                           trainer_id=trainer_id)


class ShardedPSClient:
    """Routes the ``PSClient`` surface across N shard groups, one
    ``PSClient`` each. Barriers are two-phase (module docstring)."""

    def __init__(self, shard_endpoints: List[str],
                 trainer_id: Optional[int] = 0, **client_kw):
        if not shard_endpoints:
            raise ValueError("ShardedPSClient needs >= 1 shard group")
        self.shards: List[PSClient] = [
            PSClient(eps, trainer_id=trainer_id, **client_kw)
            for eps in shard_endpoints]

    @property
    def nshards(self) -> int:
        return len(self.shards)

    def shard_of(self, name: str) -> int:
        return shard_for_key(name, self.nshards)

    def client_for(self, name: str) -> PSClient:
        return self.shards[self.shard_of(name)]

    # -- dense path -------------------------------------------------------

    def send_grad(self, name: str, value,
                  round: Optional[int] = None) -> None:
        self.client_for(name).send_grad(name, value, round=round)

    def get_param(self, name: str) -> np.ndarray:
        return self.client_for(name).get_param(name)

    def _all_shards(self, fn, what: str) -> List:
        """Run ``fn(client)`` on every shard in parallel; the first
        failure (by shard index) propagates after every thread finished."""
        results: List = [None] * self.nshards
        errors: List = [None] * self.nshards

        def run(i, c):
            try:
                results[i] = fn(c)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors[i] = e

        threads = [threading.Thread(
            target=run, args=(i, c),
            name="ps-shard-%s-%d" % (what, i), daemon=True)
            for i, c in enumerate(self.shards)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for e in errors:
            if e is not None:
                raise e
        return results

    def send_barrier(self, round: Optional[int] = None) -> None:
        """Two-phase round barrier: every shard acks (applies) its round
        before any shard's round advances."""
        self._all_shards(lambda c: c.barrier_prepare(round=round),
                         "prepare")
        for c in self.shards:
            c.barrier_commit()

    def fetch_barrier(self) -> None:
        self._all_shards(lambda c: c.fetch_barrier(), "fetch")

    # -- sparse path (key-range-sliced tables) ----------------------------

    def _row_owner(self, ids: np.ndarray, height: int):
        """Per global row id: (owner shard, local id)."""
        owner = shard_for_rows(ids, height, self.nshards)
        starts = np.array(
            [row_range(s, height, self.nshards)[0]
             for s in range(self.nshards)], dtype=np.int64)
        return owner, ids - starts[owner]

    def pull_sparse(self, name: str, row_ids, height: int) -> np.ndarray:
        """Value rows for GLOBAL row ids: split by owner, pull each
        shard's slice with LOCAL ids, reassemble in request order."""
        ids = np.asarray(row_ids, dtype=np.int64).reshape(-1)
        if not len(ids):
            # shard 0 answers the empty pull: shape and dtype still come
            # from the real table
            return self.shards[0].pull_sparse(name, ids)
        owner, local = self._row_owner(ids, height)
        parts = {}
        for s in range(self.nshards):
            pos = np.nonzero(owner == s)[0]
            if len(pos):
                parts[s] = (pos, self.shards[s].pull_sparse(
                    name, local[pos]))
        first = next(iter(parts.values()))[1]
        out = np.empty((len(ids),) + first.shape[1:], dtype=first.dtype)
        for pos, vals in parts.values():
            out[pos] = vals
        return out

    def push_sparse(self, name: str, rows, values, height: int,
                    param: str = "") -> None:
        """Push (global row ids, grad rows) split by owner; each shard
        applies its slice at once."""
        ids = np.asarray(rows, dtype=np.int64).reshape(-1)
        vals = np.asarray(values)
        owner, local = self._row_owner(ids, height)
        for s in range(self.nshards):
            pos = np.nonzero(owner == s)[0]
            if len(pos):
                self.shards[s].push_sparse(name, local[pos], vals[pos],
                                           param=param,
                                           global_height=height)

    # -- plumbing ---------------------------------------------------------

    def heartbeat_full(self) -> List[dict]:
        """Per-shard heartbeat responses (index-aligned)."""
        return self._all_shards(lambda c: c.heartbeat_full(),
                                "heartbeat")

    def start_heartbeat(self, interval_s: float = 1.0) -> None:
        for c in self.shards:
            c.start_heartbeat(interval_s)

    def close(self) -> None:
        for c in self.shards:
            c.close()

    # -- live migration: refused by name ----------------------------------

    def migrate(self, name: str, to_shard: int) -> dict:
        _refuse("live migration (ShardedPSClient.migrate)")

    def migrate_range(self, name: str, lo: int, hi: int,
                      to_shard: int, height: int) -> dict:
        _refuse("range migration (ShardedPSClient.migrate_range)")

    def apply_shard_map(self, payload) -> None:
        _refuse("the versioned shard map of live migration "
                "(apply_shard_map)")

    def seed_round(self, n: int) -> None:
        _refuse("durable rounds and the cold restart (seed_round)")
