"""Worker of the port's survivable-PS multiprocess tests and
``tools/torch_chaos_drill.py``: ``tests/dist_worker_ft.py`` through
``paddle_tpu_torch``.

Role from PADDLE_ROLE (the launcher sets it) or FT_ROLE:

- ``pserver``: serves dense params (SGD lr 0.1) behind the round
  protocol. PADDLE_PSERVER_ENDPOINTS (this server's group) and
  PSERVER_ENDPOINT (its own) make index 0 the primary and the rest
  backups; PADDLE_PS_REJOIN=1 (the launcher, on a relaunch) rejoins as
  a catching-up backup. With PADDLE_PSERVER_SHARDS > 1 each shard
  serves the one var that routes to it (``ps_shard.shard_for_key``).
  FT_SERVER_DIE_AT_ROUND makes the first incarnation of shard
  FT_DIE_SHARD's primary of that round SIGKILL itself while applying it
  (applied locally, never replicated). Every server also holds a
  static ``ballast`` var (FT_BALLAST_FLOATS float32s) that rides anchors
  and never a delta. FT_EVICT_SHARD arms PADDLE_PS_EVICT_AFTER on that
  shard's servers only. The scope holds torch tensors on the CPU, as
  the port's executor does.
- ``trainer``: FT_ROUNDS sync rounds of deterministic grads,
  checkpointing after each round (``CheckpointManager.save_incremental``)
  and resuming from the newest valid checkpoint on a relaunch (at or
  below PADDLE_PS_RESTORE_ROUND after a cold restart). FT_DIE_AT_ROUND +
  FT_DIE_RANK make one rank SIGKILL itself mid-round on its first
  incarnation (FT_DIE_MODE=partial_barrier: after its phase-1 barrier
  reached shard 0 only). FT_MIGRATE_AT_ROUND makes trainer 0 ask for the
  live migration of shard FT_MIGRATE_FROM_SHARD's var to
  FT_MIGRATE_TO_SHARD (asked again two rounds later if the map never
  bumped). With FT_WAIT_CAUGHT_UP=1 it then waits until every server
  answers caught up (a relaunched one has rejoined). Writes its result
  JSON to FT_OUT.t<tid>.json.
- ``witness``: a ``PSWitness`` on PSERVER_ENDPOINT.
"""
import io
import json
import os
import signal
import sys
import time

import numpy as np
import torch

from paddle_tpu_torch.checkpoint import CheckpointManager, manifest_extra
from paddle_tpu_torch.distributed.ps_rpc import (PSClient, PSServer,
                                           PSWitness)
from paddle_tpu_torch.distributed.ps_shard import (client_from_env,
                                             shard_for_key)

LR = 0.1
DIM = 4


class MiniScope(dict):
    """A dict scope holding CPU torch tensors, as the port's executor
    does: a numpy array set into it is taken as a tensor."""

    def __setitem__(self, name, val):
        if isinstance(val, np.ndarray):
            val = torch.from_numpy(np.ascontiguousarray(val))
        super().__setitem__(name, val)

    def local_var_names(self):
        return list(self)


class MiniExec:
    """The minimal executor surface PSServer drives."""

    device = "cpu"

    def _read_var(self, scope, name):
        return scope.get(name)

    def _write_var(self, scope, name, val):
        if not isinstance(val, torch.Tensor):
            val = np.asarray(val)
        scope[name] = val

    def run_block(self, block, scope):
        block(scope)


def _sgd_block_for(name):
    def block(scope):
        scope[name] = scope[name] - LR * scope[name + "@GRAD"]
    return block


def grad_for(tid: int, rnd: int, var: int = 0) -> np.ndarray:
    """Deterministic per-(trainer, round, var) gradient — survivors
    and oracles recompute the exact same values. ``var=0`` keeps the
    legacy single-var values bit-identical."""
    return np.full(DIM, (tid + 1) * 0.01 * rnd + var * 0.001,
                   dtype=np.float32)


def _nshards() -> int:
    return max(1, int(os.environ.get("PADDLE_PSERVER_SHARDS", "1")))


def var_names(nshards: int):
    """One trained var per shard, names chosen so var i ROUTES to
    shard i (searched deterministically — every process agrees). One
    shard keeps the legacy name 'w'."""
    if nshards <= 1:
        return ["w"]
    names = []
    for s in range(nshards):
        i = 0
        while True:
            cand = "w%d" % i
            if shard_for_key(cand, nshards) == s and cand not in names:
                names.append(cand)
                break
            i += 1
    return names


def _ballast() -> np.ndarray:
    n = int(os.environ.get("FT_BALLAST_FLOATS", "4096"))
    return np.zeros(max(0, n), dtype=np.float32)


def run_witness():
    w = PSWitness(os.environ["PSERVER_ENDPOINT"])
    w.serve_forever()


def run_pserver():
    endpoints_raw = os.environ.get("PADDLE_PSERVER_ENDPOINTS", "")
    endpoints = [e.strip() for e in endpoints_raw.split(",")
                 if e.strip()]
    endpoint = os.environ.get("PSERVER_ENDPOINT")
    if not endpoint:
        idx = int(os.environ.get("PADDLE_PSERVER_INDEX", "0"))
        endpoint = endpoints[idx]
    fanin = int(os.environ.get("PADDLE_TRAINERS_NUM", "2"))
    rejoin = os.environ.get("PADDLE_PS_REJOIN") == "1"
    die_round = int(os.environ.get("FT_SERVER_DIE_AT_ROUND", "0"))
    die_shard = int(os.environ.get("FT_DIE_SHARD", "0"))
    index = endpoints.index(endpoint) if endpoint in endpoints else 0
    nshards = _nshards()
    my_shard = int(os.environ.get("PADDLE_PSERVER_SHARD", "0"))
    evict_shard = os.environ.get("FT_EVICT_SHARD")
    evict_after = None
    if evict_shard is not None and evict_shard != "":
        # sharded eviction drill: only ONE shard's servers arm the
        # heartbeat monitor — per-shard effective fanin disagreeing
        # mid-round is exactly the case under test
        evict_after = (float(os.environ.get("FT_EVICT_AFTER", "1.0"))
                       if my_shard == int(evict_shard) else 0.0)

    scope = MiniScope()
    grad_to_block = {}
    for s, name in enumerate(var_names(nshards)):
        if nshards > 1 and s != my_shard:
            continue  # key-range partition: not this shard's var
        scope[name] = np.zeros(DIM, dtype=np.float32)
        grad_to_block[name + "@GRAD"] = _sgd_block_for(name)
    # static ballast: in every anchor, never in a delta — the
    # delta-vs-full evidence the drills gate on
    scope["ballast"] = _ballast()

    applied = {"rounds": 0}
    # only the active primary runs the optimize blocks: whichever member
    # of the shard's group serves that round dies (under load a backup
    # that boots a lease before its primary may win the group first),
    # and one death a shard: the first to claim the marker file
    suicidal = (die_round > 0 and not rejoin and my_shard == die_shard)
    marker = (os.environ["FT_OUT"] + ".server_died.%d" % my_shard
              if os.environ.get("FT_OUT") else None)

    def _claim_death() -> bool:
        if marker is None:
            return index == 0
        try:
            os.close(os.open(marker, os.O_CREAT | os.O_EXCL))
            return True
        except FileExistsError:
            return False

    def _wrap(block):
        def inner(scope):
            block(scope)
            applied["rounds"] += 1
            if suicidal and applied["rounds"] == die_round \
                    and _claim_death():
                # die while APPLYING the round: grads are summed and
                # the local optimize ran, but the round was never
                # replicated — the trainers must rebuild it on the
                # promoted backup from their replay logs
                os.kill(os.getpid(), signal.SIGKILL)
        return inner

    grad_to_block = {g: _wrap(b) for g, b in grad_to_block.items()}
    execer = MiniExec()

    server = PSServer(endpoint, execer, scope, grad_to_block,
                      fanin=fanin, sync_mode=True,
                      endpoints=endpoints or None, rejoin=rejoin,
                      evict_after=evict_after,
                      # a live migration ships state, never code: the
                      # recipient rebuilds the optimize block for an
                      # adopted var from the shared definition
                      block_factory=lambda g: _sgd_block_for(
                          g.split("@", 1)[0]))
    server.serve_forever()
    server.stop()


def wait_caught_up(endpoints, timeout=90.0):
    """Poll every endpoint's ``repl_status`` until each answers caught up
    (a relaunched server has rejoined); returns the final answers."""
    from paddle_tpu_torch.distributed.ps_rpc import _bare_rpc

    deadline = time.time() + timeout
    while True:
        got = {}
        for ep in endpoints:
            try:
                got[ep] = _bare_rpc(ep, {"kind": "repl_status"},
                                    timeout=2.0)
            except (OSError, ValueError):
                got[ep] = {}
        if all(r.get("caught_up") for r in got.values()) \
                or time.time() > deadline:
            return {ep: {k: r.get(k) for k in ("active", "caught_up",
                                                "round", "epoch")}
                    for ep, r in got.items()}
        time.sleep(0.2)


def run_trainer():
    endpoint = os.environ["PSERVER_ENDPOINT"]
    tid = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    rounds = int(os.environ.get("FT_ROUNDS", "6"))
    restart = int(os.environ.get("PADDLE_RESTART_COUNT", "0"))
    die_round = int(os.environ.get("FT_DIE_AT_ROUND", "0"))
    die_rank = int(os.environ.get("FT_DIE_RANK", "-1"))
    die_mode = os.environ.get("FT_DIE_MODE", "")
    migrate_round = int(os.environ.get("FT_MIGRATE_AT_ROUND", "0"))
    migrate_from = int(os.environ.get("FT_MIGRATE_FROM_SHARD", "0"))
    migrate_to = int(os.environ.get("FT_MIGRATE_TO_SHARD", "1"))
    if restart > 0:
        # drills that pin an eviction race: the relaunched
        # incarnation must come back AFTER the evicting shard's
        # monitor fired, or the drill's oracle would be racy
        time.sleep(float(os.environ.get("FT_RESTART_DELAY", "0")))
    # per-rank result file: the launcher gives every rank the same env
    out_path = "%s.t%d.json" % (os.environ["FT_OUT"], tid)
    ckpt_root = os.environ.get("FT_CKPT_ROOT", "")
    nshards = _nshards()
    names = var_names(nshards)
    ballast_bytes = _ballast().tobytes()

    mgr = None
    start = 1
    resumed_from = None
    resumed_map = None
    if ckpt_root:
        mgr = CheckpointManager(os.path.join(ckpt_root, "t%d" % tid),
                                keep=3)
        state = {}

        def _load(d):
            data = np.load(os.path.join(d, "state.npz"))
            state["w"] = data["w"]
            # advisory routing state: the shard map this incarnation's
            # predecessor had adopted (checkpoint.manifest_extra)
            state["shard_map"] = manifest_extra(d).get("shard_map")

        restore_cut = os.environ.get("PADDLE_PS_RESTORE_ROUND", "")
        if restore_cut:
            # whole-job cold restart: load local state AT
            # OR BELOW the job restore cut, never past it — after a
            # corrupt-newest fallback the trainer's own newest
            # checkpoint can be AHEAD of the round the servers
            # restored, and local state derived from a round the
            # servers lost must not leak into the resumed run (the
            # training loop fast-forwards to cut+1 below either way)
            step = mgr.load_at_or_before(int(restore_cut), _load)
        else:
            step = mgr.load_latest(_load)
        if step is not None:
            resumed_from = step
            start = step + 1
            resumed_map = state.get("shard_map")
            print("[trainer %d] resumed from checkpoint round %d%s"
                  % (tid, step,
                     " (clamped to job restore cut %s)" % restore_cut
                     if restore_cut else ""),
                  file=sys.stderr, flush=True)

    if nshards > 1:
        client = client_from_env(trainer_id=tid)
        if resumed_map:
            # resume ROUTING too: migrations the dead incarnation saw
            # apply immediately instead of via wrong_shard redirects
            client.apply_shard_map(resumed_map)
    else:
        client = PSClient.for_endpoint(endpoint, trainer_id=tid)
    restore_cut_env = os.environ.get("PADDLE_PS_RESTORE_ROUND", "")
    if restore_cut_env:
        # whole-job cold restart: every round <= the cut is durably
        # folded into EVERY shard (that is what made it the cut), so
        # re-driving from an older checkpoint would only produce
        # stale re-sends — and stale barrier acks don't synchronize
        # trainers, so two resumed trainers can desync until one's
        # real round deadlocks against the other's stale-round
        # get_param. Fast-forward straight to cut+1 (grads are pure
        # functions of (tid, round), so rounds the servers fell back
        # past re-drive bit-identically) and seed the staleness-guard
        # counter to the cut — exactly the servers' applied round.
        cut = int(restore_cut_env)
        start = max(start, cut + 1)
        client.seed_round(cut)
    ws = {}

    def one_round(rnd):
        nonlocal ws
        for vi, name in enumerate(names):
            client.send_grad(name + "@GRAD", grad_for(tid, rnd, vi),
                             round=rnd)
        if restart == 0 and tid == die_rank and rnd == die_round:
            if die_mode == "partial_barrier" and nshards > 1:
                # phase-1 barrier reached shard 0 ONLY, then death:
                # shard 0 can apply the round with this trainer in,
                # the sister shard cannot — the per-shard effective
                # fanin disagreement the eviction drill reconciles
                client.shards[0].barrier_prepare(round=rnd)
            # mid-round death: grad in, barrier never (fully) sent —
            # the worst spot, servers are left waiting on this rank
            os.kill(os.getpid(), signal.SIGKILL)
        client.send_barrier(round=rnd)
        ws = {name: client.get_param(name) for name in names}
        client.fetch_barrier()
        if (migrate_round and tid == 0 and nshards > 1
                and (rnd == migrate_round
                     or (rnd >= migrate_round + 2
                         and getattr(client, "map_version", 1) == 0))):
            # live migration rides the NEXT round's barrier; the
            # re-trigger two rounds later covers a donor killed
            # mid-migration before the intent ever replicated (the
            # rollback path the --migrate chaos drill drills)
            try:
                client.migrate(names[migrate_from], migrate_to)
                print("[trainer %d] requested migration of %s -> "
                      "shard %d at round %d" % (tid,
                                                names[migrate_from],
                                                migrate_to, rnd),
                      file=sys.stderr, flush=True)
            except (RuntimeError, OSError) as e:
                print("[trainer %d] migrate request failed (will "
                      "retry): %s" % (tid, e), file=sys.stderr,
                      flush=True)
        if mgr is not None:
            buf = io.BytesIO()
            np.savez(buf, w=ws[names[0]], round=rnd,
                     **{"v_%s" % n: w for n, w in ws.items()})
            # the static ballast shard is fingerprint-reused: the
            # incremental save writes only what changed this round.
            # The adopted shard map rides the manifest (advisory) so
            # a relaunched incarnation resumes routing with it.
            extra = None
            if nshards > 1 and getattr(client, "map_version", 0):
                extra = {"shard_map": {
                    "version": client.map_version,
                    "overrides": dict(client.map_overrides),
                    "ranges": {
                        t: [list(r) for r in rs] for t, rs in
                        getattr(client, "map_ranges", {}).items()}}}
            mgr.save_incremental(
                rnd, {"state.npz": buf.getvalue(),
                      "ballast.bin": ballast_bytes},
                fingerprints={"ballast.bin": "static-v1"},
                extra=extra)

    for rnd in range(start, rounds + 1):
        one_round(rnd)
    caught_up = None
    if os.environ.get("FT_WAIT_CAUGHT_UP") == "1":
        caught_up = wait_caught_up(endpoint.split(","))

    if nshards > 1:
        hbs = client.heartbeat_full()  # per shard, index-aligned
        hb = hbs[0]
        shard_info = [
            {"endpoint": c.endpoint, "ep_idx": c._ep_idx,
             "failovers": c._failover_count,
             "server_active": h.get("active"),
             "server_round": h.get("round"),
             "server_promotions": h.get("promotions")}
            for c, h in zip(client.shards, hbs)]
        ep_idx = client.shards[0]._ep_idx
        failovers = sum(c._failover_count for c in client.shards)
        endpoint_now = ",".join(c.endpoint for c in client.shards)
        evicted = set()
        for c, h in zip(client.shards, hbs):
            evicted |= c.evicted_peers | set(h.get("evicted", []))
    else:
        hb = client.heartbeat_full()
        hbs = [hb]
        shard_info = None
        ep_idx = client._ep_idx
        failovers = client._failover_count
        endpoint_now = client.endpoint
        evicted = client.evicted_peers | set(hb.get("evicted", []))
    with open(out_path, "w") as f:
        json.dump({
            "tid": tid,
            "rounds_done": rounds - start + 1,
            "resumed_from": resumed_from,
            "restart": restart,
            "w": np.asarray(ws[names[0]]).tolist(),
            "vars": {n: np.asarray(w).tolist() for n, w in ws.items()},
            "evicted_peers": sorted(evicted),
            "evictions": hb.get("evictions"),
            "readmissions": hb.get("readmissions"),
            # failover telemetry: which endpoint the client ended on,
            # how many times it advanced, and the serving side's view
            "endpoint": endpoint_now,
            "ep_idx": ep_idx,
            "failovers": failovers,
            "server_active": hb.get("active"),
            "server_round": hb.get("round"),
            "server_promotions": sum(
                h.get("promotions") or 0 for h in hbs),
            "shards": shard_info,
            # live-migration telemetry: the router's adopted map and
            # the servers' own view of it (drill-gated)
            "map_version": getattr(client, "map_version", 0),
            "map_overrides": getattr(client, "map_overrides", {}),
            "caught_up": caught_up,
            "server_map_versions": [
                (h.get("shard_map") or {}).get("version", 0)
                for h in hbs],
        }, f)


def main():
    role = os.environ.get("PADDLE_ROLE") or os.environ["FT_ROLE"]
    if role == "pserver":
        run_pserver()
    elif role == "trainer":
        run_trainer()
    elif role == "witness":
        run_witness()
    else:
        raise SystemExit("unknown FT_ROLE %r" % role)


if __name__ == "__main__":
    main()
