"""Key-range sharded parameter server.

The port of ``paddle_tpu/distributed/ps_shard.py``. The parameter space
is partitioned over several independent server groups, the reference's
key-range-sliced tables lifted to the whole PS:

- **groups**: ``PADDLE_PSERVER_ENDPOINTS`` lists every endpoint and
  ``PADDLE_PSERVER_SHARDS=N`` slices it into N contiguous groups, each
  its own primary and backup chain with its own replication, leases and
  failover (``ps_rpc.PSServer`` sees only its group). The launcher gives
  each server its group (``PADDLE_PSERVER_SHARD`` and the group's
  ``PADDLE_PSERVER_ENDPOINTS``) and each trainer the full list and the
  count.
- **routing**: dense vars route by a range partition of the hashed
  128-bit keyspace (``shard_for_key``, stable across processes; a var's
  ``@GRAD`` and ``@``-suffixed companions follow their base var). Sparse
  row ids route by contiguous row range (``shard_for_rows``: shard ``s``
  owns global rows ``[s*H/N, (s+1)*H/N)``), each shard holding its slice
  with LOCAL row ids.
- **two-phase round barrier**: phase 1 issues every shard's
  ``send_barrier`` in parallel (each returns once its shard applied and
  replicated the round); only when all acked does phase 2 clear each
  sub-client's replay log and advance its round, so one shard's primary
  dying mid-round loses no other shard's round and double-applies none.
- **live migrations and the shard map**: the hash map is version 0.
  ``migrate(name, to_shard)`` and ``migrate_range(name, lo, hi, ...)``
  ask the donor group's primary to move a var or a row range under the
  round barrier (``ps_rpc`` runs the protocol); the router adopts the
  bumped map at the next barrier (each shard's phase-1 ack carries it)
  or through ``wrong_shard`` redirects, whose tokens the old owner never
  recorded, so the reissue at the new owner stays exactly-once.
"""
from __future__ import annotations

import hashlib
import os
import threading
from typing import Dict, List, Optional

import numpy as np

from .ps_rpc import PSClient, WrongShard, host_array

__all__ = ["shard_for_key", "shard_for_rows", "row_range",
           "split_endpoint_groups", "ShardedPSClient",
           "client_from_env", "shards_from_env"]


def shard_for_key(name: str, nshards: int) -> int:
    """Range partition of the hashed keyspace: md5(base_name) as a
    128-bit int, split into ``nshards`` equal ranges. A ``@``-suffixed
    name (``w@GRAD``, ``w@MOMENTUM``) routes by its BASE var so every
    companion of a param lands on the param's shard."""
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
    """Slice the flat endpoint list into ``nshards`` contiguous
    primary+backup groups (every group the same depth — the launch
    contract)."""
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
    """The right client for the env contract: a plain (possibly
    replicated) ``PSClient`` for one group, a ``ShardedPSClient`` when
    ``PADDLE_PSERVER_SHARDS`` > 1.

    After a whole-job cold restart the round counter is
    deliberately NOT seeded here from the launcher's
    ``PADDLE_PS_RESTORE_ROUND``: seeding belongs with the caller's
    resume logic, which must ALSO fast-forward its training loop past
    the cut — a counter seeded at the cut and then re-driving older
    rounds ends up ahead of the servers' applied round and trips
    their stale-primary guard on every pull. A resumed trainer calls
    ``seed_round`` with the cut when it fast-forwards."""
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
    """Routes the ``PSClient`` surface across N shard groups; each
    group gets its own ``PSClient`` with its own endpoint chain,
    replay log, and failover — one shard's death never touches the
    others' connections. Barriers are two-phase (module docstring)."""

    def __init__(self, shard_endpoints: List[str],
                 trainer_id: Optional[int] = 0, **client_kw):
        if not shard_endpoints:
            raise ValueError("ShardedPSClient needs >= 1 shard group")
        self._trainer_id = trainer_id
        self._shard_endpoints = [str(e) for e in shard_endpoints]
        # live-migration shard map: version 0 = pure hash;
        # overrides learned from barrier acks / wrong_shard redirects
        self._map_lock = threading.Lock()
        self.map_version = 0
        self.map_overrides: Dict[str, int] = {}
        # row-range overrides: per base table, ordered
        # (global_lo, global_hi, shard, local_base) entries — rows in
        # [lo, hi) live on ``shard`` at LOCAL id
        # ``local_base + (gid - lo)``; later entries supersede earlier
        # ones (the server appends the newest last)
        self.map_ranges: Dict[str, List[tuple]] = {}
        self.shards: List[PSClient] = []
        for eps in shard_endpoints:
            c = PSClient(eps, trainer_id=trainer_id, **client_kw)
            # phase 2 of the round barrier belongs to THIS router
            c._defer_barrier_commit = True
            c._map_version_hint = 0
            self.shards.append(c)

    @property
    def nshards(self) -> int:
        return len(self.shards)

    def shard_of(self, name: str) -> int:
        base = name.split("@", 1)[0]
        with self._map_lock:
            ov = self.map_overrides.get(base)
        if ov is not None:
            return int(ov)
        return shard_for_key(name, self.nshards)

    def client_for(self, name: str) -> PSClient:
        return self.shards[self.shard_of(name)]

    def apply_shard_map(self, payload) -> None:
        """Adopt a server-advertised shard map if it is newer than
        ours (version-monotonic; barrier acks and wrong_shard
        redirects both land here)."""
        if not isinstance(payload, dict):
            return
        ver = int(payload.get("version", 0))
        with self._map_lock:
            if ver <= self.map_version:
                return
            self.map_version = ver
            self.map_overrides = {
                str(n): int(s)
                for n, s in (payload.get("overrides") or {}).items()}
            self.map_ranges = {
                str(t): [(int(r[0]), int(r[1]), int(r[2]), int(r[3]))
                         for r in rs]
                for t, rs in (payload.get("ranges") or {}).items()}
        for c in self.shards:
            # every rpc now carries the adopted version (``mv``): a
            # recipient holding a STAGED var commits it only for a
            # client that provably saw the donor's map bump
            c._map_version_hint = ver

    def _routed(self, name: str, fn):
        """Run ``fn(client)`` against the var's owner, re-routing once
        per ``wrong_shard`` redirect (bounded by the shard count — a
        map can't cycle: versions only grow)."""
        for _ in range(self.nshards + 1):
            try:
                return fn(self.client_for(name))
            except WrongShard as e:
                self.apply_shard_map(e.shard_map)
        raise RuntimeError(
            "var %r still redirected after %d wrong_shard hops "
            "(map version %d)" % (name, self.nshards + 1,
                                  self.map_version))

    def migrate(self, name: str, to_shard: int) -> dict:
        """Live-migrate ``name``'s key range to ``to_shard``'s group
        (executes at the donor's next round barrier; see ps_rpc)."""
        to_shard = int(to_shard)
        if not 0 <= to_shard < self.nshards:
            raise ValueError("to_shard %d out of range (nshards=%d)"
                             % (to_shard, self.nshards))
        return self._routed(
            name, lambda c: c.migrate(
                name, to_shard, self._shard_endpoints[to_shard]))

    def migrate_range(self, name: str, lo: int, hi: int,
                      to_shard: int, height: int) -> dict:
        """Live-migrate GLOBAL rows ``[lo, hi)`` of sparse table
        ``name`` to ``to_shard``'s group. The range must lie
        entirely within ONE current ownership region (no hash or
        range-override boundary strictly inside) so the donor-LOCAL
        source window is contiguous; the donor executes the move at
        its next round barrier (see ps_rpc) and the bumped map — now
        carrying a per-range entry for the table — reaches every
        trainer via barrier acks or ``wrong_shard`` redirects."""
        lo, hi, to_shard = int(lo), int(hi), int(to_shard)
        if not 0 <= to_shard < self.nshards:
            raise ValueError("to_shard %d out of range (nshards=%d)"
                             % (to_shard, self.nshards))
        if not 0 <= lo < hi <= int(height):
            raise ValueError("bad row range [%d, %d) for height %d"
                             % (lo, hi, height))
        base = name.split("@", 1)[0]
        bounds = set()
        for s in range(1, self.nshards):
            bounds.add(row_range(s, height, self.nshards)[0])
        with self._map_lock:
            for rlo, rhi, _s, _b in self.map_ranges.get(base, ()):
                bounds.add(int(rlo))
                bounds.add(int(rhi))
        inner = sorted(b for b in bounds if lo < b < hi)
        if inner:
            raise ValueError(
                "range [%d, %d) of %r crosses ownership boundaries "
                "%s — split the request at them" % (lo, hi, base, inner))
        owner, local = self._row_owner(
            base, np.asarray([lo], dtype=np.int64), height)
        donor, src_lo = int(owner[0]), int(local[0])
        if donor == to_shard:
            raise ValueError("rows [%d, %d) of %r already live on "
                             "shard %d" % (lo, hi, base, to_shard))
        return self.shards[donor].migrate_range(
            base, lo, hi, src_lo, src_lo + (hi - lo), to_shard,
            self._shard_endpoints[to_shard])

    # -- dense path -------------------------------------------------------

    def send_grad(self, name: str, value,
                  round: Optional[int] = None) -> None:
        self._routed(name,
                     lambda c: c.send_grad(name, value, round=round))

    def get_param(self, name: str) -> np.ndarray:
        return self._routed(name, lambda c: c.get_param(name))

    def seed_round(self, n: int) -> None:
        """Floor every shard client's completed-round counter: a
        cold-restarted trainer seeds the job restore cut — the
        servers' applied round — and fast-forwards its training loop
        past it (see ``PSClient.seed_round``)."""
        for c in self.shards:
            c.seed_round(n)

    def _all_shards(self, fn, what: str) -> List:
        """Run ``fn(client)`` on every shard in parallel and return
        the per-shard results; the FIRST failure (by shard index)
        propagates after every thread finished — never a half-joined
        round."""
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
        """Two-phase round barrier: every shard must ack (apply +
        replicate) its round before ANY shard's replay log drops it —
        a single shard's death mid-round loses nothing and
        double-applies nothing. Phase-1 acks may carry a bumped
        ``shard_map`` (a migration rode this round's barrier): every
        trainer adopts it HERE, before any round-N+1 traffic — the
        atomic map-version bump. ``round`` stamps the
        training round for the stale-round eviction guard."""
        resps = self._all_shards(
            lambda c: c.barrier_prepare(round=round), "prepare")
        for c in self.shards:
            c.barrier_commit()
        for r in resps:
            if isinstance(r, dict) and r.get("shard_map"):
                self.apply_shard_map(r["shard_map"])

    def fetch_barrier(self) -> None:
        self._all_shards(lambda c: c.fetch_barrier(), "fetch")

    # -- sparse path (key-range-sliced tables) ----------------------------

    def _row_owner(self, name: str, ids: np.ndarray, height: int):
        """Per-GLOBAL-row-id ``(owner_shard, local_id)`` arrays: the
        static hash range partition, then every adopted row-range
        override for the table applied in order (newest last wins) —
        a row inside a migrated ``[lo, hi)`` lives on the recipient at
        ``local_base + (gid - lo)``."""
        base = name.split("@", 1)[0]
        owner = shard_for_rows(ids, height, self.nshards)
        starts = np.array(
            [row_range(s, height, self.nshards)[0]
             for s in range(self.nshards)], dtype=np.int64)
        local = ids - starts[owner]
        with self._map_lock:
            ranges = list(self.map_ranges.get(base, ()))
        for lo, hi, shard, local_base in ranges:
            m = (ids >= lo) & (ids < hi)
            if m.any():
                owner = np.where(m, shard, owner)
                local = np.where(m, local_base + (ids - lo), local)
        return owner, local

    def pull_sparse(self, name: str, row_ids, height: int) -> np.ndarray:
        """Pull value rows for GLOBAL row ids: split by current
        ownership (hash ranges + adopted row-range overrides), pull
        each shard's slice with LOCAL ids, reassemble in request
        order. A ``wrong_shard`` redirect (rows moved mid-pull) adopts
        the bumped map and recomputes — pulls are idempotent, so the
        whole split simply re-runs."""
        ids = np.asarray(row_ids, dtype=np.int64).reshape(-1)
        if not len(ids):
            # shard 0 answers the empty pull so shape/dtype still come
            # from the real table (the non-sharded client's behavior)
            return self.shards[0].pull_sparse(name, ids)
        for _ in range(self.nshards + 2):
            owner, local = self._row_owner(name, ids, height)
            try:
                parts: Dict[int, tuple] = {}
                for s in range(self.nshards):
                    pos = np.nonzero(owner == s)[0]
                    if not len(pos):
                        continue
                    parts[s] = (pos, self.shards[s].pull_sparse(
                        name, local[pos]))
                first = next(iter(parts.values()))[1]
                out = np.empty((len(ids),) + first.shape[1:],
                               dtype=first.dtype)
                for pos, vals in parts.values():
                    out[pos] = vals
                return out
            except WrongShard as e:
                self.apply_shard_map(e.shard_map)
        raise RuntimeError(
            "pull_sparse(%r) still redirected after %d wrong_shard "
            "hops (map version %d)" % (name, self.nshards + 2,
                                       self.map_version))

    def push_sparse(self, name: str, rows, values, height: int,
                    param: str = "") -> None:
        """Push (global row ids, grad rows) split by current
        ownership; each shard applies its slice immediately (async,
        row-local). A shard answering ``wrong_shard`` applied NOTHING
        (the redirect is all-or-nothing and un-records the replay
        token), so only THAT slice's rows re-route under the adopted
        map — rows already applied at other shards are never reissued:
        exactly-once either way."""
        ids = np.asarray(rows, dtype=np.int64).reshape(-1)
        vals = host_array(values)
        pending = np.arange(len(ids), dtype=np.int64)
        for _ in range(self.nshards + 2):
            if not len(pending):
                return
            owner, local = self._row_owner(name, ids[pending], height)
            redirected: List[np.ndarray] = []
            for s in range(self.nshards):
                pos = np.nonzero(owner == s)[0]
                if not len(pos):
                    continue
                sel = pending[pos]
                try:
                    self.shards[s].push_sparse(name, local[pos],
                                               vals[sel], param=param,
                                               global_height=height)
                except WrongShard as e:
                    self.apply_shard_map(e.shard_map)
                    redirected.append(sel)
            pending = (np.concatenate(redirected) if redirected
                       else np.empty(0, dtype=np.int64))
        raise RuntimeError(
            "push_sparse(%r): %d rows still redirected after %d "
            "wrong_shard hops (map version %d)"
            % (name, len(pending), self.nshards + 2, self.map_version))

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
