"""The survivable parameter server of ``paddle_tpu_torch``, case for case
against ``tests/test_survivable_ps.py``.

Every case of the JAX package's file runs here through the port's
``ps_rpc`` / ``ps_shard`` / ``fault`` / ``checkpoint`` with the servers'
scopes holding torch tensors on the CPU (``MiniScope`` stores what the
port's executor stores), so every replicate, digest, snapshot and splice
goes through ``host_array`` / ``device_tensor``: delta replication
bitwise against full anchors and its counters, row slices of
``push_sparse`` tables, chunk and incremental digests, incremental
checkpoints, leases and the quorum (renewals, tombstones, partitions,
the isolated primary of three, the legacy instant promotion, witnesses,
votedFor re-grants, clock jitter), async round-gated replay, key-range
sharding with the two-phase barrier, the stale-round guard and the
sharded eviction reconcile, live and row-range migrations, and the
durable rounds with the cold restart and the async op log.

Tolerance: bitwise everywhere. The servers' update arithmetic is the
test's own float32 blocks, the same in both packages, and replication,
failover, migration and restore move bytes, never recompute them.
``test_ps_scale_bench_smoke`` has no case here: ``tools/ps_scale_bench``
is not ported."""
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _eps(n):
    return ["127.0.0.1:%d" % _free_port() for _ in range(n)]


class MiniScope(dict):
    """A dict scope that keeps its dense values as CPU torch tensors, as
    the port's executor does: a numpy array set into it is taken as a
    tensor (sharing its memory), so the server's reads go through
    ``host_array`` and its writes through ``device_tensor``."""

    def __setitem__(self, name, val):
        if isinstance(val, np.ndarray):
            val = torch.from_numpy(np.ascontiguousarray(val))
        super().__setitem__(name, val)

    def update(self, *args, **kw):
        for k, v in dict(*args, **kw).items():
            self[k] = v

    def local_var_names(self):
        return list(self)


class MiniExec:
    """The executor surface ``PSServer`` drives, on the host device."""

    device = "cpu"

    def _read_var(self, scope, name):
        return scope.get(name)

    def _write_var(self, scope, name, val):
        if not isinstance(val, torch.Tensor):
            val = np.asarray(val)
        scope[name] = val

    def run_block(self, block, scope):
        block(scope)


def _sgd_block(scope, lr=0.1):
    scope["w"] = scope["w"] - lr * scope["w@GRAD"]


def _grad(tid, rnd, dim=4):
    return np.full(dim, (tid + 1) * 0.01 * rnd, dtype=np.float32)


def _wait_until(pred, timeout=20.0, what="a condition"):
    """Poll ``pred`` until it holds; fail naming ``what`` after
    ``timeout`` seconds (the tests wait on states, never on a fixed
    sleep: the suite runs them in parallel workers, under load)."""
    deadline = time.time() + timeout
    while not pred():
        assert time.time() < deadline, "timed out waiting for %s" % what
        time.sleep(0.02)


def _renewals_after(obs, n):
    """A predicate: ``n`` more lease renewals than now landed."""
    r0 = obs.counter_value("ps.lease_renewals") or 0
    return lambda: (obs.counter_value("ps.lease_renewals") or 0) >= r0 + n


def _fast_env(monkeypatch):
    monkeypatch.setenv("PADDLE_PS_CONNECT_TIMEOUT", "1")
    monkeypatch.setenv("PADDLE_PS_FAILOVER_CONNECT_TIMEOUT", "1")
    monkeypatch.setenv("PADDLE_PS_RPC_RETRIES", "2")
    monkeypatch.setenv("PADDLE_PS_RPC_BACKOFF_MS", "10")
    monkeypatch.setenv("PADDLE_PS_RPC_DEADLINE", "20")


def _mk_ps(eps, i, fanin=1, sync=True, ballast=0, **kw):
    from paddle_tpu_torch.distributed.ps_rpc import PSServer

    scope = MiniScope()
    scope["w"] = np.zeros(4, dtype=np.float32)
    if ballast:
        scope["ballast"] = np.zeros(ballast, dtype=np.float32)
    server = PSServer(eps[i], MiniExec(), scope,
                      {"w@GRAD": _sgd_block}, fanin=fanin,
                      sync_mode=sync, endpoints=eps, **kw)
    server.start_background()
    return server, scope


# -- delta replication -------------------------------------------------------


def _train(eps, rounds, tid=0):
    from paddle_tpu_torch.distributed.ps_rpc import PSClient

    c = PSClient(",".join(eps), trainer_id=tid)
    w = None
    for rnd in range(1, rounds + 1):
        c.send_grad("w@GRAD", _grad(tid, rnd))
        c.send_barrier()
        w = c.get_param("w")
        c.fetch_barrier()
    c.close()
    return w


def test_delta_replication_bitwise_vs_full(monkeypatch):
    """The same 5-round workload replicated twice — anchors-only
    (anchor_every=1: every round a full blob) vs delta mode
    (anchor_every=3) — must leave the BACKUP bit-for-bit identical,
    with the delta run recording delta rounds whose bytes are
    strictly below the anchors' (the ballast var never changes, so
    deltas exclude it)."""
    from paddle_tpu_torch import observability as obs

    _fast_env(monkeypatch)

    def run(anchor_every):
        eps = _eps(2)
        s0, sc0 = _mk_ps(eps, 0, ballast=4096,
                         anchor_every=anchor_every)
        s1, sc1 = _mk_ps(eps, 1, ballast=4096,
                         anchor_every=anchor_every)
        try:
            _train(eps, rounds=5)
            np.testing.assert_array_equal(np.asarray(sc0["w"]),
                                          np.asarray(sc1["w"]))
            return (np.asarray(sc1["w"]).tobytes(),
                    np.asarray(sc1["ballast"]).tobytes())
        finally:
            s0.stop()
            s1.stop()

    d0 = obs.counter_value("ps.delta_rounds") or 0
    a0 = obs.counter_value("ps.anchor_rounds") or 0
    db0 = obs.counter_value("ps.replication_bytes", mode="delta") or 0
    fb0 = obs.counter_value("ps.replication_bytes", mode="full") or 0
    full_run = run(anchor_every=1)
    anchors_after = (obs.counter_value("ps.anchor_rounds") or 0) - a0
    assert anchors_after == 5, "anchor_every=1 must ship 5 full blobs"
    assert (obs.counter_value("ps.delta_rounds") or 0) == d0
    delta_run = run(anchor_every=3)
    assert delta_run == full_run, \
        "delta and full replication must converge bit-for-bit"
    d_rounds = (obs.counter_value("ps.delta_rounds") or 0) - d0
    assert d_rounds == 3, \
        "anchor_every=3 over 5 rounds = anchors at 1,3 + 3 deltas"
    d_bytes = (obs.counter_value("ps.replication_bytes", mode="delta")
               or 0) - db0
    f_bytes = (obs.counter_value("ps.replication_bytes", mode="full")
               or 0) - fb0
    assert 0 < d_bytes < f_bytes, (d_bytes, f_bytes)
    # the per-round delta excludes the 16KB ballast entirely
    assert d_bytes / d_rounds < 4096 * 4, d_bytes


def test_delta_row_slice_for_push_sparse(monkeypatch):
    """Async push_sparse marks only the touched rows dirty: after the
    first (anchor) ship, a later push replicates a ROW SLICE of the
    table — bytes ~ rows touched, not table size — and the backup's
    table still matches the primary's bit-for-bit."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.distributed.ps_rpc import PSClient, PSServer

    _fast_env(monkeypatch)
    eps = _eps(2)
    height, width = 128, 4

    class SparseExec(MiniExec):
        def _write_var(self, scope, name, val):
            scope[name] = val  # keep SelectedRows grads un-coerced

    def mk(i):
        scope = MiniScope()
        scope["emb"] = np.zeros((height, width), dtype=np.float32)

        def sparse_block(scope):
            g = scope["emb@GRAD"]
            rows = np.asarray(g.rows(), dtype=np.int64)
            vals = np.asarray(g._value)
            emb = np.array(scope["emb"], copy=True)
            emb[rows] -= 0.1 * vals  # row-local, like pslib sgd
            scope["emb"] = emb

        s = PSServer(eps[i], SparseExec(), scope,
                     {"emb@GRAD": sparse_block}, fanin=1,
                     sync_mode=False, endpoints=eps)
        s.start_background()
        return s, scope

    s0, sc0 = mk(0)
    s1, sc1 = mk(1)
    monkeypatch.setattr(s0, "_async_repl_every", 1)  # ship every push
    try:
        c = PSClient(",".join(eps), trainer_id=0)
        c.push_sparse("emb@GRAD", [3, 7],
                      np.ones((2, width), "f4"), param="emb")
        db0 = obs.counter_value("ps.replication_bytes",
                                mode="delta") or 0
        c.push_sparse("emb@GRAD", [5],
                      np.full((1, width), 2.0, "f4"), param="emb")
        d_bytes = (obs.counter_value("ps.replication_bytes",
                                     mode="delta") or 0) - db0
        assert 0 < d_bytes <= 4 * width * 4, \
            "second push must ship a row slice, got %d bytes" % d_bytes
        np.testing.assert_array_equal(np.asarray(sc0["emb"]),
                                      np.asarray(sc1["emb"]))
        assert np.asarray(sc1["emb"])[5, 0] == np.float32(-0.2)
        c.close()
    finally:
        s0.stop()
        s1.stop()


# -- incremental checkpoints -------------------------------------------------


def test_incremental_checkpoint_parity_and_fallback(tmp_path):
    """save_incremental == save bit-for-bit on load; a fingerprint
    match skips even PRODUCING the shard; corrupting a reused shard
    (the torn-write replace case) falls back to the previous
    checkpoint; counters record the reuse."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.checkpoint import CheckpointManager, verify_manifest

    big = os.urandom(1 << 15)
    full = CheckpointManager(str(tmp_path / "full"), keep=3)
    inc = CheckpointManager(str(tmp_path / "inc"), keep=3)

    def writer(step):
        def w(d):
            with open(os.path.join(d, "state.bin"), "wb") as f:
                f.write(b"round-%d" % step)
            with open(os.path.join(d, "ballast.bin"), "wb") as f:
                f.write(big)
        return w

    r0 = obs.counter_value("checkpoint.shards_reused") or 0
    d0 = obs.counter_value("checkpoint.delta_bytes") or 0
    for step in (1, 2, 3):
        full.save(step, writer(step))
        inc.save_incremental(
            step, {"state.bin": b"round-%d" % step,
                   "ballast.bin": _must_not_run if step > 1 else big},
            fingerprints={"ballast.bin": "static-v1"})
    assert (obs.counter_value("checkpoint.shards_reused") - r0) == 2
    fresh = (obs.counter_value("checkpoint.delta_bytes") or 0) - d0
    assert fresh == len(big) + 3 * len(b"round-N"), fresh

    def load(mgr):
        out = {}

        def loader(d):
            verify_manifest(d)
            for fn in ("state.bin", "ballast.bin"):
                with open(os.path.join(d, fn), "rb") as f:
                    out[fn] = f.read()
        step = mgr.load_latest(loader)
        return step, out

    assert load(full) == load(inc), \
        "incremental and full checkpoints must load identically"

    # content-hash reuse without a fingerprint still links
    r1 = obs.counter_value("checkpoint.shards_reused")
    inc.save_incremental(4, {"state.bin": b"round-4",
                             "ballast.bin": big})
    assert obs.counter_value("checkpoint.shards_reused") - r1 == 1

    # corrupt the newest REUSED shard (replace: the torn-write case,
    # which breaks the hardlink) -> load falls back one rotation
    p = str(tmp_path / "inc" / "ckpt-4" / "ballast.bin")
    os.remove(p)
    with open(p, "wb") as f:
        f.write(b"garbage")
    step, out = load(inc)
    assert step == 3 and out["ballast.bin"] == big


def _must_not_run():
    raise AssertionError("fingerprint-matched shard was produced")


def test_manifest_extra_roundtrips_shard_map(tmp_path):
    """A trainer checkpoints its adopted shard map as manifest
    ``extra``; ``manifest_extra`` hands it back (advisory — an
    unreadable manifest degrades to {}, never an error)."""
    from paddle_tpu_torch.checkpoint import CheckpointManager, manifest_extra

    mgr = CheckpointManager(str(tmp_path / "c"), keep=2)
    smap = {"version": 2, "overrides": {"w0": 1}}
    mgr.save_incremental(1, {"state.bin": b"x"},
                         extra={"shard_map": smap})
    d = mgr.dir_for(1)
    got = manifest_extra(d)
    assert got.get("shard_map") == smap
    assert manifest_extra(str(tmp_path / "nope")) == {}


# -- lease + quorum promotion ------------------------------------------------


def test_lease_renewals_keep_backup_loyal(monkeypatch):
    """While the primary renews, the backup never promotes (no lease
    expiry, no election) and a FRESH client walking into the backup is
    redirected to the primary, exactly as before."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.distributed.ps_rpc import PSClient

    _fast_env(monkeypatch)
    eps = _eps(2)
    s0, sc0 = _mk_ps(eps, 0, lease_ms=300)
    s1, _ = _mk_ps(eps, 1, lease_ms=300)
    renewed = _renewals_after(obs, 4)
    try:
        # 4 renewals: more than a lease (300 ms) of live primary
        _wait_until(renewed, what="4 lease renewals")
        assert not s1._promoted, "backup promoted under live renewals"
        c = PSClient("%s,%s" % (eps[1], eps[0]), trainer_id=0)
        c.send_grad("w@GRAD", _grad(0, 1))
        c.send_barrier()
        assert c.endpoint == eps[0], "fresh client not redirected"
        assert not s1._promoted
        c.get_param("w")
        c.fetch_barrier()
        c.close()
    finally:
        s0.stop()
        s1.stop()


def test_dead_primary_tombstone_elects_backup_proactively(monkeypatch):
    """A SIGKILL-equivalent (stopped listener => connection REFUSED)
    lets the backup win its election on the tombstone quorum WITHOUT
    any client traffic — promotion is proactive under leases."""
    from paddle_tpu_torch import observability as obs

    _fast_env(monkeypatch)
    eps = _eps(2)
    s0, _ = _mk_ps(eps, 0, lease_ms=300)
    s1, _ = _mk_ps(eps, 1, lease_ms=300)
    e0 = obs.counter_value("ps.lease_expiries", shard="0") or 0
    try:
        _wait_until(_renewals_after(obs, 1), what="a lease renewal")
        s0.stop()
        deadline = time.time() + 5
        while not s1._promoted and time.time() < deadline:
            time.sleep(0.05)
        assert s1._promoted, "tombstone quorum never promoted backup"
        assert s1._epoch >= 1, "promotion must bump the epoch"
        assert (obs.counter_value("ps.lease_expiries", shard="0")
                or 0) > e0
    finally:
        s0.stop()
        s1.stop()


def test_partitioned_backup_is_quorum_denied(monkeypatch):
    """Control-plane partition (every lease/vote rpc times out): the
    backup's lease expires but its elections gather neither a grant
    nor a tombstone — quorum denied, NO promotion, and the primary
    (2-endpoint group: no rival quorum can form without it) keeps
    serving. Exactly one writable primary."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.distributed import ps_rpc
    from paddle_tpu_torch.observability import flight

    _fast_env(monkeypatch)
    eps = _eps(2)
    s0, _ = _mk_ps(eps, 0, lease_ms=300)
    s1, _ = _mk_ps(eps, 1, lease_ms=300)

    def severed(endpoint, msg, timeout=1.0):
        raise socket.timeout("partitioned control plane")

    def lost_elections():
        return sum(1 for _, k, f in flight.events()
                   if k == "ps.election" and f.get("endpoint") == eps[1]
                   and not f.get("won"))

    try:
        _wait_until(_renewals_after(obs, 1), what="a healthy renewal")
        monkeypatch.setattr(ps_rpc, "_bare_rpc", severed)
        lost0 = lost_elections()
        # the backup's lease expires and it stands, and loses, 3 times
        _wait_until(lambda: lost_elections() >= lost0 + 3,
                    what="3 lost elections")
        assert not s1._promoted, \
            "partition must never yield a second primary"
        assert s0._active_role(), "2-endpoint primary must serve on"
        assert s1._promised_epoch == 0 or not s1._promoted
    finally:
        s0.stop()
        s1.stop()


def test_isolated_primary_of_three_demotes(monkeypatch):
    """In a group of >= 3 a primary that cannot renew with a majority
    for a full lease steps down: behind its partition, the two backups
    COULD have elected a rival — better a loud redirect than split
    brain."""
    from paddle_tpu_torch.distributed import ps_rpc

    _fast_env(monkeypatch)
    eps = _eps(3)

    def severed(endpoint, msg, timeout=1.0):
        raise socket.timeout("partitioned control plane")

    monkeypatch.setattr(ps_rpc, "_bare_rpc", severed)
    s0, _ = _mk_ps(eps, 0, lease_ms=300)
    try:
        deadline = time.time() + 5
        while s0._active_role() and time.time() < deadline:
            time.sleep(0.05)
        assert not s0._active_role(), \
            "isolated 3-group primary must demote within ~a lease"
    finally:
        s0.stop()


def test_legacy_instant_promotion_when_lease_disabled(monkeypatch):
    """PADDLE_PS_LEASE_MS=0 restores the instant-promotion contract: a genuinely
    failed-over client (fo >= 1) promotes the backup instantly; no
    lease threads run."""
    from paddle_tpu_torch.distributed.ps_rpc import PSClient

    _fast_env(monkeypatch)
    eps = _eps(2)
    s0, _ = _mk_ps(eps, 0, fanin=1, lease_ms=0)
    s1, sc1 = _mk_ps(eps, 1, fanin=1, lease_ms=0)
    try:
        c = PSClient(",".join(eps), trainer_id=0)
        c.send_grad("w@GRAD", _grad(0, 1))
        c.send_barrier()
        c.get_param("w")
        c.fetch_barrier()
        s0.stop()
        t0 = time.time()
        c.send_grad("w@GRAD", _grad(0, 2))
        c.send_barrier()
        w = c.get_param("w")
        c.fetch_barrier()
        assert s1._promoted
        exp = {"w": np.zeros(4, "f4"), "w@GRAD": _grad(0, 1)}
        _sgd_block(exp)
        exp["w@GRAD"] = _grad(0, 2)
        _sgd_block(exp)
        np.testing.assert_array_equal(w, exp["w"])
        assert time.time() - t0 < 15
        c.close()
    finally:
        s0.stop()
        s1.stop()


# -- async-mode round-gated replay -------------------------------------------


def test_async_failover_round_gated_exactly_once(monkeypatch):
    """Async (RunAsyncLoop) mode with backups: every K applied ops the
    primary ships a synthetic round, acks tag each op with the round
    carrying it, and the client prunes its replay log by durable
    round. Killing the primary mid-stream and finishing on the backup
    applies every op EXACTLY once — bit-for-bit with the sequential
    oracle — and the replay log never grows past one round."""
    from paddle_tpu_torch.distributed.ps_rpc import PSClient

    _fast_env(monkeypatch)
    eps = _eps(2)
    s0, sc0 = _mk_ps(eps, 0, sync=False, lease_ms=300)
    s1, sc1 = _mk_ps(eps, 1, sync=False, lease_ms=300)
    monkeypatch.setattr(s0, "_async_repl_every", 4)
    monkeypatch.setattr(s1, "_async_repl_every", 4)
    grads = [np.full(4, 0.01 * (i + 1), dtype=np.float32)
             for i in range(11)]
    try:
        c = PSClient(",".join(eps), trainer_id=0)
        for g in grads[:6]:
            c.send_grad("w@GRAD", g)
        # ops 1-4 shipped as round 1 and PRUNED; 5,6 still pending
        assert len(c._replay_log) == 2, \
            [e[2] for e in c._replay_log]
        s0.stop()
        for g in grads[6:]:
            c.send_grad("w@GRAD", g)
        w = c.get_param("w")
        c.close()
        oracle = {"w": np.zeros(4, "f4")}
        for g in grads:
            oracle["w@GRAD"] = g
            _sgd_block(oracle)
        assert w.tobytes() == oracle["w"].tobytes(), \
            "async failover lost or double-applied a push"
        np.testing.assert_array_equal(np.asarray(sc1["w"]),
                                      oracle["w"])
    finally:
        s0.stop()
        s1.stop()


def test_async_durable_round_requires_an_acked_backup(monkeypatch):
    """A ship that reached NOBODY must not advance durable_round: with
    the backup dead, the client's replay log keeps every unreplicated
    op — pruning them would lose pushes that exist only on the
    primary."""
    from paddle_tpu_torch.distributed.ps_rpc import PSClient

    _fast_env(monkeypatch)
    eps = _eps(2)
    s0, _ = _mk_ps(eps, 0, sync=False, lease_ms=0)
    s1, _ = _mk_ps(eps, 1, sync=False, lease_ms=0)
    monkeypatch.setattr(s0, "_async_repl_every", 2)
    try:
        c = PSClient(",".join(eps), trainer_id=0)
        c.send_grad("w@GRAD", _grad(0, 1))
        c.send_grad("w@GRAD", _grad(0, 2))  # round 1 ships, acked
        assert not c._replay_log, "acked round must prune"
        s1.stop()  # the only backup dies: ships reach nobody
        for rnd in range(3, 9):
            c.send_grad("w@GRAD", _grad(0, rnd))
        assert len(c._replay_log) == 6, \
            "unacked ships must not prune the replay log"
        c.close()
    finally:
        s0.stop()
        s1.stop()


# -- key-range sharding ------------------------------------------------------


def test_shard_routing_stable_and_grad_follows_param():
    from paddle_tpu_torch.distributed.ps_shard import (shard_for_key,
                                                 shard_for_rows,
                                                 row_range,
                                                 split_endpoint_groups)

    assert shard_for_key("w", 1) == 0
    for n in (2, 3, 8):
        for name in ("w", "emb/table", "fc_0.w_0"):
            s = shard_for_key(name, n)
            assert 0 <= s < n
            assert shard_for_key(name, n) == s, "routing must be stable"
            assert shard_for_key(name + "@GRAD", n) == s
            assert shard_for_key(name + "@MOMENTUM", n) == s
    # every shard of a 2-way split is reachable by SOME var name
    hit = {shard_for_key("w%d" % i, 2) for i in range(32)}
    assert hit == {0, 1}

    groups = split_endpoint_groups(["a:1", "b:2", "c:3", "d:4"], 2)
    assert groups == [["a:1", "b:2"], ["c:3", "d:4"]]
    with pytest.raises(ValueError, match="divisible"):
        split_endpoint_groups(["a:1", "b:2", "c:3"], 2)

    # contiguous row ranges tile the table exactly
    height = 103
    for n in (2, 4):
        edges = [row_range(s, height, n) for s in range(n)]
        assert edges[0][0] == 0 and edges[-1][1] == height
        for (a, b), (c, d) in zip(edges, edges[1:]):
            assert b == c
        owner = shard_for_rows(np.arange(height), height, n)
        for s, (lo, hi) in enumerate(edges):
            assert (owner[lo:hi] == s).all()


def _mk_group(eps, name, fanin=1, **kw):
    """One shard group's servers, all serving var ``name``."""
    from paddle_tpu_torch.distributed.ps_rpc import PSServer

    out = []
    for ep in eps:
        scope = MiniScope()
        scope[name] = np.zeros(4, dtype=np.float32)

        def block(scope, _n=name):
            scope[_n] = scope[_n] - 0.1 * scope[_n + "@GRAD"]

        s = PSServer(ep, MiniExec(), scope, {name + "@GRAD": block},
                     fanin=fanin, endpoints=eps, **kw)
        s.start_background()
        out.append((s, scope))
    return out


def _shard_var_names(nshards):
    from paddle_tpu_torch.distributed.ps_shard import shard_for_key

    names = []
    for s in range(nshards):
        i = 0
        while True:
            cand = "w%d" % i
            if (shard_for_key(cand, nshards) == s
                    and cand not in names):
                names.append(cand)
                break
            i += 1
    return names


def test_sharded_two_phase_barrier_and_shard_failover(monkeypatch):
    """2 key-range shards x (primary+backup): the two-phase barrier
    keeps every sub-client's replay log alive until EVERY shard acked;
    killing shard 0's primary mid-run fails over that shard alone and
    BOTH shards' params finish bit-for-bit against the per-var
    oracle."""
    from paddle_tpu_torch.distributed.ps_shard import ShardedPSClient

    _fast_env(monkeypatch)
    names = _shard_var_names(2)
    g0, g1 = _eps(2), _eps(2)
    shard0 = _mk_group(g0, names[0], lease_ms=300)
    shard1 = _mk_group(g1, names[1], lease_ms=300)
    rounds, kill_at = 4, 2
    try:
        c = ShardedPSClient([",".join(g0), ",".join(g1)],
                            trainer_id=0)
        assert [c.shard_of(n) for n in names] == [0, 1]
        ws = {}
        for rnd in range(1, rounds + 1):
            for vi, name in enumerate(names):
                c.send_grad(name + "@GRAD", _grad(0, rnd) + vi)
            # phase-1/phase-2 contract: the logs hold the round until
            # EVERY shard acks
            assert all(len(sc._replay_log) == 1 for sc in c.shards)
            c.send_barrier()
            assert all(not sc._replay_log for sc in c.shards), \
                "commit must clear every shard's log"
            for name in names:
                ws[name] = c.get_param(name)
            c.fetch_barrier()
            if rnd == kill_at:
                shard0[0][0].stop()  # shard 0 primary dies; shard 1
                # must never notice
        for vi, name in enumerate(names):
            exp = {"w": np.zeros(4, "f4")}
            for rnd in range(1, rounds + 1):
                exp["w@GRAD"] = _grad(0, rnd) + vi
                _sgd_block(exp)
            assert ws[name].tobytes() == exp["w"].tobytes(), name
        assert shard0[1][0]._promoted, "shard 0 backup not promoted"
        assert not shard1[1][0]._promoted, \
            "shard 1 backup must be untouched"
        assert c.shards[1]._failover_count == 0
        c.close()
    finally:
        for s, _ in shard0 + shard1:
            s.stop()


def test_sharded_sparse_row_range_pull_push(monkeypatch):
    """pull/push_sparse with GLOBAL row ids: rows split by contiguous
    range, each shard holding its slice under LOCAL ids, results
    reassembled in request order."""
    from paddle_tpu_torch.distributed.ps_rpc import PSServer
    from paddle_tpu_torch.distributed.ps_shard import (ShardedPSClient,
                                                 row_range)

    _fast_env(monkeypatch)
    height, width, nshards = 10, 3, 2
    eps = _eps(2)
    servers = []
    for s in range(nshards):
        lo, hi = row_range(s, height, nshards)
        scope = MiniScope()
        scope["emb"] = (np.arange(lo, hi, dtype=np.float32)
                        .reshape(-1, 1) * np.ones((1, width), "f4"))
        srv = PSServer(eps[s], MiniExec(), scope, {}, fanin=1,
                       endpoints=[eps[s]])
        srv.start_background()
        servers.append(srv)
    try:
        c = ShardedPSClient([eps[0], eps[1]], trainer_id=0)
        ids = [7, 1, 9, 0, 4]  # deliberately out of order, both shards
        vals = c.pull_sparse("emb", ids, height=height)
        np.testing.assert_array_equal(
            vals, np.asarray(ids, "f4").reshape(-1, 1)
            * np.ones((1, width), "f4"))
        empty = c.pull_sparse("emb", [], height=height)
        assert empty.shape == (0, width) and empty.dtype == np.float32
        c.close()
    finally:
        for s in servers:
            s.stop()


# -- external quorum witness -------------------------------------------------


def test_witness_blocks_forged_tombstones_then_allows_real_death(
        monkeypatch):
    """The N>=3 forged-tombstone corner: every group peer of the
    candidate answers connection-REFUSED (forgeable positive-death
    evidence) while the primary is ALIVE and still renewing with the
    witness — the witness denies, so the election must fail. Stop the
    primary for real and the witness's lease view expires: the next
    election wins on a genuine witness grant."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.distributed import ps_rpc
    from paddle_tpu_torch.distributed.ps_rpc import PSWitness

    _fast_env(monkeypatch)
    eps = _eps(3)
    wit_ep = _eps(1)[0]
    witness = PSWitness(wit_ep)
    witness.start_background()
    real_bare = ps_rpc._bare_rpc

    def forged(endpoint, msg, timeout=1.0):
        if endpoint == wit_ep:
            return real_bare(endpoint, msg, timeout)
        if msg.get("kind") in ("vote", "lease_renew") \
                and msg.get("candidate") == eps[1]:
            # only the CANDIDATE's probes see forged refusals; the
            # primary's own renewals to the group stay real
            raise ConnectionRefusedError("forged tombstone")
        return real_bare(endpoint, msg, timeout)

    s0, _ = _mk_ps(eps, 0, lease_ms=300, witnesses=[wit_ep])
    s1, _ = _mk_ps(eps, 1, lease_ms=300, witnesses=[wit_ep])
    s2, _ = _mk_ps(eps, 2, lease_ms=300, witnesses=[wit_ep])
    v0 = obs.counter_value("ps.witness_votes", shard="0") or 0
    w0 = obs.counter_value("ps.witness_renewals", shard="0") or 0
    try:
        # renewals reach the group and the witness
        _wait_until(lambda: (obs.counter_value("ps.witness_renewals",
                                               shard="0") or 0) > w0,
                    what="a renewal at the witness")
        # backup 1's lease view never refreshes; its group probes are
        # forged-refused — only the witness answers honestly
        monkeypatch.setattr(s1, "_refresh_lease_locked",
                            lambda epoch: None)
        monkeypatch.setattr(ps_rpc, "_bare_rpc", forged)
        s1._lease_deadline = time.monotonic() - 1.0
        deadline = time.time() + 2.0
        while time.time() < deadline:
            assert not s1._promoted, \
                "forged tombstones elected a backup under a live " \
                "primary despite the witness"
            time.sleep(0.05)
        assert (obs.counter_value("ps.witness_votes", shard="0")
                or 0) > v0, "the election never consulted the witness"
        # now the primary REALLY dies: renewals to the witness stop,
        # its lease view expires, the grant flows, promotion happens
        monkeypatch.setattr(ps_rpc, "_bare_rpc", real_bare)
        s0.stop()
        deadline = time.time() + 6.0
        while not (s1._promoted or s2._promoted) \
                and time.time() < deadline:
            time.sleep(0.05)
        assert s1._promoted or s2._promoted, \
            "real death + expired witness view must still promote"
    finally:
        s0.stop()
        s1.stop()
        s2.stop()
        witness.stop()


def test_vote_regrant_same_candidate_survives_lost_reply(monkeypatch):
    """votedFor semantics (found by the --migrate drill under an
    injected reply drop): a voter — group peer or witness — that
    granted an epoch must RE-GRANT the same epoch to the SAME
    candidate, or a lost grant reply burns the epoch and livelocks
    every election retry. A rival at the consumed epoch stays
    denied."""
    from paddle_tpu_torch.distributed.ps_rpc import PSWitness

    _fast_env(monkeypatch)
    eps = _eps(2)
    s0, _ = _mk_ps(eps, 0, lease_ms=300)
    s1, _ = _mk_ps(eps, 1, lease_ms=300)
    try:
        s1._lease_deadline = time.monotonic() - 1.0  # expired voter
        vote = {"kind": "vote", "epoch": 1, "cand_round": 99,
                "candidate": "cand:A"}
        r1, _ = s1._handle(dict(vote), b"")
        assert r1["granted"]
        r2, _ = s1._handle(dict(vote), b"")  # grant reply "lost"
        assert r2["granted"], "re-vote by the promise holder denied"
        rb, _ = s1._handle(dict(vote, candidate="cand:B"), b"")
        assert not rb["granted"], "rival stole a consumed epoch"
        r3, _ = s1._handle(dict(vote, epoch=2,
                                candidate="cand:B"), b"")
        assert r3["granted"], "higher epoch must still win the voter"
    finally:
        s0.stop()
        s1.stop()

    w = PSWitness(_eps(1)[0])
    try:
        wvote = {"kind": "vote", "epoch": 1, "shard": "7",
                 "lease_ms": 50, "candidate": "cand:A"}
        w._shard_state_locked("7", 50)["deadline"] = \
            time.monotonic() - 1.0
        g1, _ = w._handle(dict(wvote), b"")
        assert g1["granted"]
        w._state["7"]["deadline"] = time.monotonic() - 1.0
        g2, _ = w._handle(dict(wvote), b"")
        assert g2["granted"], "witness re-vote denied after lost reply"
        gb, _ = w._handle(dict(wvote, candidate="cand:B"), b"")
        assert not gb["granted"]
    finally:
        w.stop()


# -- clock-jitter chaos ------------------------------------------------------


def test_clock_jitter_rule_parses_and_is_deterministic():
    import random as _random

    from paddle_tpu_torch.distributed import fault

    rules = fault.parse_plan("clock_jitter:0.5:600,send.drop:0.1")
    assert rules[0].kind == "clock_jitter" and rules[0].param == 600.0
    with pytest.raises(ValueError, match="magnitude"):
        fault.parse_plan("clock_jitter:0.5")
    # repr round-trips
    assert fault.parse_plan(repr(rules[0]))[0].param == 600.0
    # per-process skew: seeded by (seed x identity), reproducible,
    # different identities wander differently
    prev = fault.get_identity()
    try:
        fault.set_identity("a:1")
        i1 = fault.FaultInjector(
            fault.parse_plan("clock_jitter:0:500"), seed=3)
        i2 = fault.FaultInjector(
            fault.parse_plan("clock_jitter:0:500"), seed=3)
        assert i1.clock_skew_s() == i2.clock_skew_s()
        assert abs(i1.clock_skew_s()) <= 0.5
        fault.set_identity("b:2")
        i3 = fault.FaultInjector(
            fault.parse_plan("clock_jitter:0:500"), seed=3)
        assert i3.clock_skew_s() != i1.clock_skew_s()
    finally:
        fault.set_identity(prev)
    # random_plan wiring: appended after the legacy draws
    base = fault.random_plan(_random.Random(11))
    withj = fault.random_plan(_random.Random(11), clock_jitter_ms=300)
    assert withj.startswith(base) and "clock_jitter:0.5:300" in withj
    fault.parse_plan(withj)
    # frame faults are untouched by a jitter-only plan
    inj = fault.FaultInjector(fault.parse_plan("clock_jitter:1:100"))
    assert not inj.rules and not inj.partitions
    assert len(inj.clock_rules) == 1


def test_clock_jitter_2x_lease_never_splits_the_brain(monkeypatch):
    """±2x-lease clock jitter on every participant: the backup's
    lease view may expire spuriously, but its elections stay
    quorum-gated (the live primary denies; in a 2-group no rival
    quorum can form without it) — no promotion, exactly one writable
    primary, training bit-for-bit."""
    from paddle_tpu_torch.distributed import fault
    from paddle_tpu_torch.distributed.ps_rpc import PSClient

    _fast_env(monkeypatch)
    monkeypatch.setenv("PADDLE_TPU_FAULTS", "clock_jitter:0.5:600")
    monkeypatch.setenv("PADDLE_TPU_FAULT_SEED", "9")
    fault.reset_injector()
    eps = _eps(2)
    try:
        s0, sc0 = _mk_ps(eps, 0, lease_ms=300)
        s1, _ = _mk_ps(eps, 1, lease_ms=300)
        try:
            c = PSClient(",".join(eps), trainer_id=0)
            w = None
            for rnd in range(1, 7):
                c.send_grad("w@GRAD", _grad(0, rnd), round=rnd)
                c.send_barrier(round=rnd)
                w = c.get_param("w")
                c.fetch_barrier()
                assert s0._active_role() and not s1._promoted, \
                    "jitter alone promoted a backup under a live " \
                    "primary"
                time.sleep(0.15)
            exp = {"w": np.zeros(4, "f4")}
            for rnd in range(1, 7):
                exp["w@GRAD"] = _grad(0, rnd)
                _sgd_block(exp)
            assert w.tobytes() == exp["w"].tobytes()
            assert (fault.get_injector() is not None
                    and fault.get_injector().clock_rules)
            c.close()
        finally:
            s0.stop()
            s1.stop()
    finally:
        fault.reset_injector()


# -- sharded eviction: disagreeing per-shard fanin ---------------------------


def test_stale_round_guard_drops_resent_applied_round(monkeypatch):
    """A fresh incarnation re-running a TRAINING round the server
    already applied (its dead predecessor's barrier closed it) must
    be dropped — grads NOT folded into the next round, barriers NOT
    pre-paying the next fanin."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.distributed.ps_rpc import PSClient

    _fast_env(monkeypatch)
    eps = _eps(1)
    s, scope = _mk_ps(eps, 0, fanin=1)
    st0 = obs.counter_value("ps.stale_rounds") or 0
    try:
        c1 = PSClient(eps[0], trainer_id=0)
        for rnd in (1, 2):
            c1.send_grad("w@GRAD", _grad(0, rnd), round=rnd)
            c1.send_barrier(round=rnd)
            c1.get_param("w")
            c1.fetch_barrier()
        c1.close()  # incarnation 1 "dies" after round 2 applied
        c2 = PSClient(eps[0], trainer_id=0)  # fresh cid, resumes at 2
        c2.send_grad("w@GRAD", _grad(0, 2), round=2)
        c2.send_barrier(round=2)  # both stale: dropped, not counted
        assert (obs.counter_value("ps.stale_rounds") or 0) >= st0 + 2
        assert s._applied_round == 2 and not s._pending
        c2.send_grad("w@GRAD", _grad(0, 3), round=3)
        c2.send_barrier(round=3)
        w = c2.get_param("w")
        c2.fetch_barrier()
        c2.close()
        exp = {"w": np.zeros(4, "f4")}
        for rnd in (1, 2, 3):
            exp["w@GRAD"] = _grad(0, rnd)
            _sgd_block(exp)
        assert w.tobytes() == exp["w"].tobytes(), \
            "stale-round resend leaked into a later round"
    finally:
        s.stop()


def test_sharded_eviction_disagreeing_fanin_reconciles(monkeypatch):
    """The drill case, in-process and fully pinned: trainer 1's
    round-1 grads reach BOTH shards but its phase-1 barrier reaches
    shard A only, then it dies. A (no eviction) applies round 1 with
    t1's barrier; B (evicting) evicts t1 and applies round 1 too —
    with t1's PENDING grads, so round 1 is complete everywhere. The
    disagreement bites at round 2: B (fanin shrunk to 1) applies it
    with t0 alone while A waits; the relaunched incarnation re-runs
    rounds 1-2 — stale-DROPPED exactly where they already applied —
    and genuinely contributes where they did not. Deterministic
    oracles: shard A's var = full 2-trainer history; shard B's var =
    full minus t1's round-2 grad; round 3 complete on both (t1
    re-admitted, fanin restored). Without the stale-round guard,
    t1's re-sent round-1 barrier would pre-pay B's round-3 fanin and
    apply it with a stale grad mix."""
    import threading as _threading

    from paddle_tpu_torch.distributed.ps_rpc import PSClient

    _fast_env(monkeypatch)
    # a barrier legitimately waits on the relaunched trainer here: under
    # a loaded host that can outlast the fast 20 s deadline
    monkeypatch.setenv("PADDLE_PS_RPC_DEADLINE", "60")
    names = _shard_var_names(2)
    epA, epB = _eps(1), _eps(1)
    rounds = 3

    def mk(eps_one, name, evict_after):
        from paddle_tpu_torch.distributed.ps_rpc import PSServer

        scope = MiniScope()
        scope[name] = np.zeros(4, dtype=np.float32)
        s = PSServer(eps_one[0], MiniExec(), scope,
                     {name + "@GRAD": _sgd_factory(name + "@GRAD")},
                     fanin=2, endpoints=eps_one,
                     evict_after=evict_after)
        s.start_background()
        return s, scope

    sA, scA = mk(epA, names[0], evict_after=0.0)   # never evicts
    sB, scB = mk(epB, names[1], evict_after=0.6)   # evicts t1
    servers = [sA, sB]

    def t0_loop(out):
        cA = PSClient(epA[0], trainer_id=0)
        cB = PSClient(epB[0], trainer_id=0)
        for rnd in range(1, rounds + 1):
            cA.send_grad(names[0] + "@GRAD", _grad(0, rnd), round=rnd)
            cB.send_grad(names[1] + "@GRAD", _grad(0, rnd), round=rnd)

            def barrier(c, rnd=rnd):
                c.send_barrier(round=rnd)
            tb = [_threading.Thread(target=barrier, args=(c,))
                  for c in (cA, cB)]
            for t in tb:
                t.start()
            for t in tb:
                t.join(timeout=60)
            out[names[0]] = cA.get_param(names[0])
            out[names[1]] = cB.get_param(names[1])
            cA.fetch_barrier()
            cB.fetch_barrier()
        cA.close()
        cB.close()

    # incarnation 1 of t1: grads to BOTH shards, barrier to A ONLY
    c1A = PSClient(epA[0], trainer_id=1)
    c1B = PSClient(epB[0], trainer_id=1)
    c1A.send_grad(names[0] + "@GRAD", _grad(1, 1), round=1)
    c1B.send_grad(names[1] + "@GRAD", _grad(1, 1), round=1)
    out = {}
    t0 = _threading.Thread(target=t0_loop, args=(out,))
    t0.start()
    barA = _threading.Thread(
        target=lambda: c1A.send_barrier(round=1))
    barA.start()
    barA.join(timeout=60)  # A applies round 1 with BOTH trainers
    c1A.close()
    c1B.close()  # t1 dead; B must evict it to finish round 1

    def t1_incarnation2():
        # B evicted the dead incarnation and applied round 2 with t0
        # alone: only then does the relaunch re-run its rounds
        deadline = time.time() + 30
        while sB._applied_round < 2 and time.time() < deadline:
            time.sleep(0.02)
        cA = PSClient(epA[0], trainer_id=1)
        cB = PSClient(epB[0], trainer_id=1)
        for rnd in range(1, rounds + 1):  # re-runs round 1 (stale)
            cA.send_grad(names[0] + "@GRAD", _grad(1, rnd), round=rnd)
            cB.send_grad(names[1] + "@GRAD", _grad(1, rnd), round=rnd)
            acks = {}

            def barrier(c, r=rnd):
                acks[c] = c.barrier_prepare(round=r)
                c.barrier_commit()
            tb = [_threading.Thread(target=barrier, args=(c,))
                  for c in (cA, cB)]
            for t in tb:
                t.start()
            for t in tb:
                t.join(timeout=60)
            # a round a shard already applied has no params of its own
            # to wait for: the other trainer's next round may be open
            # there, and it waits for this trainer's barrier
            for c, n in ((cA, names[0]), (cB, names[1])):
                if not (acks.get(c) or {}).get("stale_round"):
                    c.get_param(n)
            cA.fetch_barrier()
            cB.fetch_barrier()
        cA.close()
        cB.close()

    t1v2 = _threading.Thread(target=t1_incarnation2)
    t1v2.start()
    t0.join(timeout=120)
    t1v2.join(timeout=120)
    try:
        assert not t0.is_alive() and not t1v2.is_alive(), \
            "reconciliation deadlocked"
        # shard A: every round had both trainers
        expA = np.zeros(4, dtype=np.float32)
        for rnd in range(1, rounds + 1):
            expA = expA - np.float32(0.1) * (_grad(0, rnd)
                                             + _grad(1, rnd))
        np.testing.assert_array_equal(np.asarray(scA[names[0]]), expA)
        # shard B: round 1 complete (t1's grads were pending when the
        # eviction applied it); round 2 sailed with t0 only; round 3
        # complete again (t1 re-admitted). The stale resends of
        # rounds 1-2 were dropped, never mixed into round 3.
        expB = np.zeros(4, dtype=np.float32)
        for rnd in range(1, rounds + 1):
            tot = _grad(0, rnd) if rnd == 2 \
                else _grad(0, rnd) + _grad(1, rnd)
            expB = expB - np.float32(0.1) * tot
        np.testing.assert_array_equal(np.asarray(scB[names[1]]), expB)
    finally:
        for s in servers:
            s.stop()


class _PeerSock:
    def __init__(self, peer):
        self._peer = peer
        self.sent = []

    def getpeername(self):
        host, port = self._peer.rsplit(":", 1)
        return (host, int(port))

    def sendall(self, b):
        self.sent.append(bytes(b))


def test_partition_rule_parses_and_matches_pairs():
    from paddle_tpu_torch.distributed.fault import FaultRule, parse_plan

    rules = parse_plan("partition:1:127.0.0.1:7001|127.0.0.1:7002,"
                       "send.drop:0.1")
    assert rules[0].kind == "partition" and rules[0].prob == 1.0
    assert rules[0].param == "127.0.0.1:7001|127.0.0.1:7002"
    assert rules[0].partition_peer("127.0.0.1:7001") == "127.0.0.1:7002"
    assert rules[0].partition_peer("127.0.0.1:7002") == "127.0.0.1:7001"
    assert rules[0].partition_peer("127.0.0.1:9999") is None
    assert rules[0].partition_peer(None) is None
    single = parse_plan("any.partition:0.5:127.0.0.1:7003")[0]
    assert single.partition_peer(None) == "127.0.0.1:7003"
    with pytest.raises(ValueError, match="peer"):
        parse_plan("partition:1")
    # round-trips through repr
    assert parse_plan(repr(rules[0]))[0].param == rules[0].param


def test_partition_injector_blackholes_both_directions():
    """A pair rule severs frames on sockets to the peer — send AND
    recv — only in processes whose identity is one of the pair; a
    third party's traffic to either endpoint is untouched."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.distributed import fault

    a, b = "127.0.0.1:7001", "127.0.0.1:7002"
    inj = fault.FaultInjector(
        fault.parse_plan("partition:1:%s|%s" % (a, b)), seed=1)
    prev = fault.get_identity()
    n0 = obs.counter_value("fault.injected", side="send",
                           kind="partition") or 0
    try:
        fault.set_identity(a)
        s = _PeerSock(b)
        assert inj.on_send(s, b"frame") is False and not s.sent
        assert inj.on_recv(_PeerSock(b)) == "drop"
        other = _PeerSock("127.0.0.1:9999")
        assert inj.on_send(other, b"frame") is True and other.sent
        # a process OUTSIDE the pair (a trainer) is never severed
        fault.set_identity("127.0.0.1:5555")
        s2 = _PeerSock(b)
        assert inj.on_send(s2, b"frame") is True and s2.sent
        assert (obs.counter_value("fault.injected", side="send",
                                  kind="partition") or 0) == n0 + 1
    finally:
        fault.set_identity(prev)


def test_random_plan_partition_wiring():
    import random as _random

    from paddle_tpu_torch.distributed.fault import parse_plan, random_plan

    base = random_plan(_random.Random(11))
    withp = random_plan(_random.Random(11),
                        partition_peers=["h:1|h:2", "h:3|h:4"])
    assert withp.startswith(base), \
        "peers must not perturb the legacy rng draws"
    assert "partition:1:" in withp
    rules = parse_plan(withp)
    assert rules[-1].kind == "partition"
    assert rules[-1].param in ("h:1|h:2", "h:3|h:4")


def test_chaos_schedule_deterministic_for_sharded_modes():
    import sys

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import torch_chaos_drill as chaos_drill

    a = chaos_drill.make_schedule(77, 6, shards=2, partition=True)
    assert a == chaos_drill.make_schedule(77, 6, shards=2,
                                          partition=True)
    assert a["shards"] == 2 and a["partition"]
    assert a["die_shard"] in (0, 1)
    assert a["partition_shard"] == (a["die_shard"] + 1) % 2
    legacy = chaos_drill.make_schedule(77, 6)
    # legacy draws unchanged: same plan and kill points
    assert legacy["plan"] == a["plan"]
    assert legacy["trainer_kill_round"] == a["trainer_kill_round"]
    assert legacy["partition_shard"] is None
    # the migrate and evict modes: deterministic, legacy-draw-compatible
    m = chaos_drill.make_schedule(77, 8, shards=2, migrate=True)
    assert m == chaos_drill.make_schedule(77, 8, shards=2,
                                          migrate=True)
    assert m["migrate_from"] == m["die_shard"]
    assert m["migrate_to"] == (m["die_shard"] + 1) % 2
    assert 1 <= m["migrate_round"] <= 4
    assert m["plan"] == chaos_drill.make_schedule(77, 8,
                                                  shards=2)["plan"]
    e = chaos_drill.make_schedule(77, 6, shards=2, evict=True)
    assert e == chaos_drill.make_schedule(77, 6, shards=2, evict=True)
    assert e["evict_shard"] == 1
    assert e["trainer_kill_round"] <= 4


# -- chunk-level + incremental digests ---------------------------------------


def _plan_server(eps, scope_vars, **kw):
    """A PSServer whose _replication_plan we drive directly (no
    backups — planning is pure given the scope + dirty state)."""
    from paddle_tpu_torch.distributed.ps_rpc import PSServer

    scope = MiniScope()
    scope.update(scope_vars)
    s = PSServer(eps[0], MiniExec(), scope, {}, fanin=1,
                 endpoints=[eps[0]], **kw)
    return s, scope


def _prime(server):
    """First plan = anchor; adopt its digests as the shipped state."""
    arrays = server._scope_arrays()
    mode, items, digests = server._replication_plan(arrays)
    assert mode == "full"
    server._shipped_digests = digests
    server._dirty_rows.clear()
    server._dirty_dense.clear()
    server._applied_round += 1  # off the anchor cadence
    return digests


def _plan_bytes(items):
    return sum(a.nbytes for _, a, _ in items)


def test_one_row_update_to_256mb_var_ships_under_one_percent():
    """The acceptance bound: a single-row touch of a >=256MB
    dense var ships < 1% of the full-var bytes — via a row slice when
    the rows are known, via CHUNK slices when only the digest knows
    (dense-dirty, rows lost)."""
    from paddle_tpu_torch.distributed import ps_rpc

    height, width = 262144, 256  # 256 MiB float32
    big = np.zeros((height, width), dtype=np.float32)
    s, scope = _plan_server(_eps(1), {"big": big},
                            anchor_every=1000000)
    try:
        _prime(s)
        full_bytes = big.nbytes
        # rows-known path (push_sparse tracked the touch)
        scope["big"][12345, :] = 7.0
        s._dirty_rows["big"] = {12345}
        mode, items, digests = s._replication_plan(s._scope_arrays())
        assert mode == "delta"
        assert items and items[0][2] == {"rows": [12345]}
        assert _plan_bytes(items) < 0.01 * full_bytes
        s._shipped_digests = digests
        s._dirty_rows.clear()
        # rows-UNKNOWN path (dense-dirty): the chunk digests localize
        # the change to one chunk of the flat stream
        scope["big"][200000, :] = 9.0
        s._dirty_dense.add("big")
        mode, items, digests = s._replication_plan(s._scope_arrays())
        assert mode == "delta"
        assert items and "chunk" in (items[0][2] or {})
        shipped = _plan_bytes(items)
        assert shipped < 0.01 * full_bytes, shipped
        ce = ps_rpc._chunk_elems_for(big)
        assert shipped <= 2 * ce * 4  # ~one chunk (straddle-safe)
    finally:
        s.stop()


def test_chunk_boundary_straddling_dirty_row():
    """A dirty row whose byte range straddles a chunk boundary must
    re-hash and ship BOTH chunks; the backup splice must be
    bit-for-bit."""
    import paddle_tpu_torch.distributed.ps_rpc as ps_rpc

    rows = ps_rpc._chunks_for_rows(
        [1], np.zeros((4, 6), "f4"), 8)  # row 1 = elems 6..11
    assert rows == {0, 1}
    assert ps_rpc._chunks_for_rows([0], np.zeros((4, 6), "f4"), 8) \
        == {0}
    assert ps_rpc._chunks_for_rows([3], np.zeros((4, 6), "f4"), 8) \
        == {2}

    # end to end with a tiny chunk size: the straddled update ships
    # two chunk slices and the backup matches bit-for-bit
    prev = os.environ.pop("PADDLE_PS_DIGEST_CHUNK_MB", None)
    os.environ["PADDLE_PS_DIGEST_CHUNK_MB"] = str(32 / (1 << 20))
    try:
        tbl = np.arange(24, dtype=np.float32).reshape(4, 6)
        s, scope = _plan_server(_eps(1), {"t": tbl.copy()},
                                anchor_every=1000000)
        try:
            d0 = _prime(s)
            assert len(d0["t"]["chunks"]) == 3  # 24 elems / 8
            # rows KNOWN: the straddled row re-hashes chunks 0+1
            # incrementally (chunk 2 carried over) and ships the
            # smaller ROW slice
            scope["t"][1, :] += 100.0
            s._dirty_rows["t"] = {1}
            mode, items, d1 = s._replication_plan(s._scope_arrays())
            assert mode == "delta"
            assert items[0][2] == {"rows": [1]}  # row beats chunk
            assert d1["t"]["chunks"][0] != d0["t"]["chunks"][0]
            assert d1["t"]["chunks"][1] != d0["t"]["chunks"][1]
            assert d1["t"]["chunks"][2] == d0["t"]["chunks"][2]
            s._shipped_digests = d1
            s._dirty_rows.clear()
            # rows UNKNOWN (dense-dirty): the same straddling change
            # ships ONE contiguous chunk run covering both chunks,
            # and the flat splice is bit-for-bit
            scope["t"][1, :] += 1.0
            s._dirty_dense.add("t")
            before = np.frombuffer(
                tbl.tobytes(), dtype=np.float32).copy()
            before.reshape(4, 6)[1, :] += 100.0  # the shipped state
            mode, items, _ = s._replication_plan(s._scope_arrays())
            assert mode == "delta"
            ranges = [it[2]["chunk"] for it in items]
            assert ranges == [[0, 16]], ranges
            got = before.copy()
            for _, arr, extra in items:
                lo, hi = extra["chunk"]
                got[lo:hi] = arr.reshape(-1)
            assert got.reshape(4, 6).tobytes() \
                == np.asarray(scope["t"]).tobytes()
        finally:
            s.stop()
    finally:
        if prev is None:
            os.environ.pop("PADDLE_PS_DIGEST_CHUNK_MB", None)
        else:
            os.environ["PADDLE_PS_DIGEST_CHUNK_MB"] = prev


def test_chunk_size_larger_than_var_degenerates_to_whole_var():
    s, scope = _plan_server(_eps(1), {"w": np.zeros(8, "f4")},
                            anchor_every=1000000)
    try:
        d = _prime(s)
        assert len(d["w"]["chunks"]) == 1  # one chunk covers the var
        scope["w"][3] = 5.0
        s._dirty_dense.add("w")
        mode, items, _ = s._replication_plan(s._scope_arrays())
        assert mode == "delta"
        # single-chunk vars ship WHOLE (no chunk header)
        assert len(items) == 1 and items[0][2] is None
        assert items[0][1].nbytes == 32
    finally:
        s.stop()


def test_digest_state_resets_after_anchor_and_skips_untouched():
    """Anchors re-hash EVERYTHING (incremental skips cannot drift past
    an anchor); between anchors an untouched var is neither re-hashed
    (ps.digest_vars{mode=skipped}) nor shipped, and its carried-over
    digest still detects a later change."""
    from paddle_tpu_torch import observability as obs

    s, scope = _plan_server(_eps(1),
                            {"w": np.zeros(8, "f4"),
                             "ballast": np.zeros(64, "f4")},
                            anchor_every=1000000)
    try:
        sk0 = obs.counter_value("ps.digest_vars", mode="skipped") or 0
        _prime(s)
        # round 1: only w touched -> ballast skipped, not shipped
        scope["w"][0] = 1.0
        s._dirty_dense.add("w")
        mode, items, digests = s._replication_plan(s._scope_arrays())
        assert mode == "delta"
        assert [n for n, _, _ in items] == ["w"]
        assert (obs.counter_value("ps.digest_vars", mode="skipped")
                or 0) > sk0
        s._shipped_digests = digests
        s._dirty_dense.clear()
        # force an anchor: everything re-hashed + shipped, fresh state
        s._applied_round = 0
        s._anchor_every = 1
        prev_ballast = digests["ballast"]
        mode, items, digests = s._replication_plan(s._scope_arrays())
        assert mode == "full" and len(items) == 2
        assert digests["ballast"] is not prev_ballast  # re-hashed
        assert digests["ballast"]["chunks"] \
            == prev_ballast["chunks"]  # same content, same digest
        s._shipped_digests = digests
        s._anchor_every = 1000000
        s._applied_round = 1
        # the carried digest still catches a change with NO dirty info
        # when incremental digesting is off for that var (dense-dirty)
        scope["ballast"][5] = 3.0
        s._dirty_dense.add("ballast")
        mode, items, _ = s._replication_plan(s._scope_arrays())
        assert [n for n, _, _ in items] == ["ballast"]
    finally:
        s.stop()


def test_incremental_digest_bitwise_parity_with_optimizer_family(
        monkeypatch):
    """A momentum-style block touches w AND w@MOM: the family-dirty
    contract must re-hash the companions too, leaving the backup
    bit-for-bit identical under PADDLE_PS_INCR_DIGEST=1 vs =0."""
    from paddle_tpu_torch.distributed.ps_rpc import PSClient, PSServer

    _fast_env(monkeypatch)

    def run(incr):
        monkeypatch.setenv("PADDLE_PS_INCR_DIGEST",
                           "1" if incr else "0")
        eps = _eps(2)
        servers = []
        for ep in eps:
            scope = MiniScope()
            scope["w"] = np.zeros(4, dtype=np.float32)
            scope["w@MOM"] = np.zeros(4, dtype=np.float32)
            scope["ballast"] = np.zeros(512, dtype=np.float32)

            def mom_block(sc):
                sc["w@MOM"] = (np.float32(0.9) * sc["w@MOM"]
                               + sc["w@GRAD"])
                sc["w"] = sc["w"] - np.float32(0.1) * sc["w@MOM"]

            s = PSServer(ep, MiniExec(), scope,
                         {"w@GRAD": mom_block}, fanin=1,
                         endpoints=eps, anchor_every=4)
            s.start_background()
            servers.append((s, scope))
        try:
            c = PSClient(",".join(eps), trainer_id=0)
            for rnd in range(1, 7):
                c.send_grad("w@GRAD", _grad(0, rnd), round=rnd)
                c.send_barrier(round=rnd)
                c.get_param("w")
                c.fetch_barrier()
            c.close()
            bsc = servers[1][1]
            return (np.asarray(bsc["w"]).tobytes(),
                    np.asarray(bsc["w@MOM"]).tobytes())
        finally:
            for s, _ in servers:
                s.stop()

    assert run(True) == run(False), \
        "incremental digesting diverged the backup's optimizer family"


# -- live shard migration ----------------------------------------------------


def _sgd_factory(gname):
    base = gname.split("@", 1)[0]

    def blk(scope):
        scope[base] = scope[base] - np.float32(0.1) * scope[gname]
    return blk


def _mk_migration_fixture(monkeypatch, lease_ms=400, extra_var=False):
    """2 shards x (primary+backup), one var per shard (plus an extra
    donor var when asked), block factories armed for adoption."""
    from paddle_tpu_torch.distributed.ps_rpc import PSServer
    from paddle_tpu_torch.distributed.ps_shard import ShardedPSClient

    _fast_env(monkeypatch)
    names = _shard_var_names(2)
    groups = [_eps(2), _eps(2)]
    servers = []
    for si, grp in enumerate(groups):
        for ep in grp:
            scope = MiniScope()
            scope[names[si]] = np.zeros(4, dtype=np.float32)
            g2b = {names[si] + "@GRAD": _sgd_factory(
                names[si] + "@GRAD")}
            if extra_var and si == 0:
                scope["extra0"] = np.zeros(4, dtype=np.float32)
                g2b["extra0@GRAD"] = _sgd_factory("extra0@GRAD")
            s = PSServer(ep, MiniExec(), scope, g2b, fanin=1,
                         endpoints=grp, lease_ms=lease_ms, shard=si,
                         block_factory=_sgd_factory)
            s.start_background()
            servers.append((s, scope))
    c = ShardedPSClient([",".join(g) for g in groups], trainer_id=0)
    return names, groups, servers, c


def test_live_migration_end_to_end(monkeypatch):
    """Happy path: migrate shard 0's var to shard 1 mid-training —
    map bumps atomically at the barrier, params stay oracle-exact,
    the recipient's BACKUP holds the var before the donor drops it,
    a fresh (version-0) client self-repairs via wrong_shard, and the
    donor group keeps answering barriers for its empty range."""
    names, groups, servers, c = _mk_migration_fixture(monkeypatch)
    from paddle_tpu_torch.distributed.ps_shard import ShardedPSClient

    rounds = 6
    try:
        ws = {}
        for rnd in range(1, rounds + 1):
            for vi, n in enumerate(names):
                c.send_grad(n + "@GRAD", _grad(0, rnd) + vi,
                            round=rnd)
            c.send_barrier(round=rnd)
            ws = {n: c.get_param(n) for n in names}
            c.fetch_barrier()
            if rnd == 2:
                r = c.migrate(names[0], 1)
                assert r.get("pending")
        assert c.map_version == 1
        assert c.map_overrides == {names[0]: 1}
        for vi, n in enumerate(names):
            exp = {"w": np.zeros(4, "f4")}
            for rnd in range(1, rounds + 1):
                exp["w@GRAD"] = _grad(0, rnd) + vi
                _sgd_block(exp)
            assert ws[n].tobytes() == exp["w"].tobytes(), n
        # recipient backup holds it; donor group dropped it
        assert names[0] in servers[3][1]
        assert names[0] not in servers[0][1]
        assert names[0] not in servers[1][1]
        # a fresh hash-routed client self-repairs via wrong_shard
        c2 = ShardedPSClient([",".join(g) for g in groups],
                             trainer_id=1)
        got = c2.get_param(names[0])
        assert got.tobytes() == ws[names[0]].tobytes()
        assert c2.map_version == 1
        c2.close()
    finally:
        c.close()
        for s, _ in servers:
            s.stop()


def test_migration_replay_original_tokens_exactly_once(monkeypatch):
    """The watermark shipped with the install makes a replay of an
    rpc ALREADY FOLDED into the migrated state answer `replayed` at
    the recipient — exactly-once across the shard-map version bump —
    and a donor-primary death right after migration fails over with
    original-token replays, finishing oracle-exact."""
    names, groups, servers, c = _mk_migration_fixture(monkeypatch,
                                                      extra_var=True)
    rounds, kill_at = 6, 4
    allv = names + ["extra0"]
    try:
        ws = {}
        for rnd in range(1, rounds + 1):
            for vi, n in enumerate(allv):
                c.send_grad(n + "@GRAD", _grad(0, rnd) + vi,
                            round=rnd)
            c.send_barrier(round=rnd)
            ws = {n: c.get_param(n) for n in allv}
            c.fetch_barrier()
            if rnd == 2:
                c.migrate(names[0], 1)
            if rnd == kill_at:
                servers[0][0].stop()  # donor primary dies post-
                # migration; its backup must serve the remaining var
        for vi, n in enumerate(allv):
            exp = {"w": np.zeros(4, "f4")}
            for rnd in range(1, rounds + 1):
                exp["w@GRAD"] = _grad(0, rnd) + vi
                _sgd_block(exp)
            assert ws[n].tobytes() == exp["w"].tobytes(), n
        assert servers[1][0]._promoted
        # the exactly-once mechanism itself: a replay of a PRE-
        # MIGRATION rpc (the donor sub-client's folded seq) at the
        # RECIPIENT answers `replayed` without executing
        donor_cid = c.shards[0]._cid
        recipient = servers[2][0] if servers[2][0]._active_role() \
            else servers[3][0]
        resp, _ = recipient._dispatch(
            {"kind": "send_grad", "cid": donor_cid, "seq": 1,
             "round": 0, "name": names[0] + "@GRAD",
             "array": {"dtype": "float32", "shape": [4]}},
            np.zeros(4, "f4").tobytes())
        assert resp.get("replayed"), resp
    finally:
        c.close()
        for s, _ in servers:
            s.stop()


def test_migration_ships_optimizer_family(monkeypatch):
    """A momentum-optimized var migrates WITH its @-companions: the
    recipient's rebuilt block finds w@MOM exactly where the donor
    left it, and the training history stays oracle-exact across the
    move. (Without family shipping, the rebuilt block would crash or
    silently restart momentum from zero.)"""
    from paddle_tpu_torch.distributed.ps_rpc import PSServer
    from paddle_tpu_torch.distributed.ps_shard import ShardedPSClient

    _fast_env(monkeypatch)
    names = _shard_var_names(2)

    def mom_factory(gname):
        base = gname.split("@", 1)[0]

        def blk(sc):
            sc[base + "@MOM"] = (np.float32(0.9) * sc[base + "@MOM"]
                                 + sc[gname])
            sc[base] = sc[base] - np.float32(0.1) * sc[base + "@MOM"]
        return blk

    groups = [_eps(2), _eps(2)]
    servers = []
    for si, grp in enumerate(groups):
        for ep in grp:
            scope = MiniScope()
            scope[names[si]] = np.zeros(4, dtype=np.float32)
            scope[names[si] + "@MOM"] = np.zeros(4, dtype=np.float32)
            s = PSServer(ep, MiniExec(), scope,
                         {names[si] + "@GRAD": mom_factory(
                             names[si] + "@GRAD")},
                         fanin=1, endpoints=grp, lease_ms=400,
                         shard=si, block_factory=mom_factory)
            s.start_background()
            servers.append((s, scope))
    c = ShardedPSClient([",".join(g) for g in groups], trainer_id=0)
    rounds = 6
    try:
        ws = {}
        for rnd in range(1, rounds + 1):
            for vi, n in enumerate(names):
                c.send_grad(n + "@GRAD", _grad(0, rnd) + vi,
                            round=rnd)
            c.send_barrier(round=rnd)
            ws = {n: c.get_param(n) for n in names}
            c.fetch_barrier()
            if rnd == 2:
                c.migrate(names[0], 1)
        assert c.map_version == 1
        for vi, n in enumerate(names):
            w = np.zeros(4, dtype=np.float32)
            mom = np.zeros(4, dtype=np.float32)
            for rnd in range(1, rounds + 1):
                mom = np.float32(0.9) * mom + (_grad(0, rnd) + vi)
                w = w - np.float32(0.1) * mom
            assert ws[n].tobytes() == w.tobytes(), \
                "%s diverged — optimizer state lost in migration" % n
        # the companion physically lives on the recipient now
        assert names[0] + "@MOM" in servers[2][1] \
            or names[0] + "@MOM" in servers[3][1]
        assert names[0] + "@MOM" not in servers[0][1]
    finally:
        c.close()
        for s, _ in servers:
            s.stop()


def test_migration_reinstalls_when_recipient_lost_the_stage(
        monkeypatch):
    """The recipient-kill window: the staged family is memory-only,
    so a recipient primary dying between install and commit loses it
    — the donor (which still holds the state; that is why the hard
    commit waits) must RE-INSTALL on the promoted recipient and drive
    the commit home."""
    from paddle_tpu_torch import observability as obs

    names, groups, servers, c = _mk_migration_fixture(monkeypatch)
    donor_primary = servers[0][0]
    recipient_primary = servers[2][0]
    real_mig_client = donor_primary._mig_client
    state = {"dropped": False}

    class _DropFirstCommit:
        def __init__(self, inner):
            self._inner = inner

        def _call(self, msg, raw=b""):
            if msg.get("kind") == "migrate_commit" \
                    and not state["dropped"]:
                # simulate the recipient primary dying right after
                # the install: its promoted backup has no stage
                state["dropped"] = True
                with recipient_primary._lock:
                    recipient_primary._staged_in.clear()
                raise OSError("recipient primary died before commit")
            return self._inner._call(msg, raw)

    monkeypatch.setattr(
        donor_primary, "_mig_client",
        lambda chain: _DropFirstCommit(real_mig_client(chain)))
    cr0 = obs.counter_value("ps.migrations",
                            outcome="commit_retry") or 0
    rounds = 6
    try:
        ws = {}
        for rnd in range(1, rounds + 1):
            for vi, n in enumerate(names):
                c.send_grad(n + "@GRAD", _grad(0, rnd) + vi,
                            round=rnd)
            c.send_barrier(round=rnd)
            ws = {n: c.get_param(n) for n in names}
            c.fetch_barrier()
            if rnd == 2:
                c.migrate(names[0], 1)
        assert state["dropped"], "the failure was never injected"
        assert (obs.counter_value("ps.migrations",
                                  outcome="commit_retry") or 0) > cr0
        assert c.map_version == 1 and c.map_overrides == {names[0]: 1}
        assert names[0] in servers[2][1], \
            "re-install never reached the recipient"
        for vi, n in enumerate(names):
            exp = {"w": np.zeros(4, "f4")}
            for rnd in range(1, rounds + 1):
                exp["w@GRAD"] = _grad(0, rnd) + vi
                _sgd_block(exp)
            assert ws[n].tobytes() == exp["w"].tobytes(), n
    finally:
        c.close()
        for s, _ in servers:
            s.stop()


def test_migrate_begin_refuses_second_pending_var(monkeypatch):
    """One in-flight migration per group: a second migrate_begin for
    a DIFFERENT var before the barrier executes the first is refused
    loudly, never silently replacing the acked intent."""
    names, groups, servers, c = _mk_migration_fixture(
        monkeypatch, extra_var=True)
    try:
        r = c.migrate(names[0], 1)
        assert r.get("pending")
        with pytest.raises(RuntimeError, match="already pending"):
            c.migrate("extra0", 1)
    finally:
        c.close()
        for s, _ in servers:
            s.stop()


def test_migration_install_failure_rolls_back(monkeypatch):
    """Unreachable recipient: bounded install retries, then ROLLBACK
    — map never bumps, the var keeps training on the donor, params
    oracle-exact."""
    from paddle_tpu_torch import observability as obs

    names, groups, servers, c = _mk_migration_fixture(monkeypatch)
    rounds = 6
    rb0 = obs.counter_value("ps.migrations", outcome="rollback") or 0
    try:
        # every install the donor attempts dies on the wire
        for s, _ in servers[:2]:
            monkeypatch.setattr(
                s, "_mig_client",
                lambda chain: (_ for _ in ()).throw(
                    OSError("recipient unreachable")))
        ws = {}
        for rnd in range(1, rounds + 1):
            for vi, n in enumerate(names):
                c.send_grad(n + "@GRAD", _grad(0, rnd) + vi,
                            round=rnd)
            c.send_barrier(round=rnd)
            ws = {n: c.get_param(n) for n in names}
            c.fetch_barrier()
            if rnd == 1:
                c.migrate(names[0], 1)
        assert c.map_version == 0 and not c.map_overrides
        assert (obs.counter_value("ps.migrations", outcome="rollback")
                or 0) > rb0
        assert names[0] in servers[0][1]  # donor still owns it
        for vi, n in enumerate(names):
            exp = {"w": np.zeros(4, "f4")}
            for rnd in range(1, rounds + 1):
                exp["w@GRAD"] = _grad(0, rnd) + vi
                _sgd_block(exp)
            assert ws[n].tobytes() == exp["w"].tobytes(), n
    finally:
        c.close()
        for s, _ in servers:
            s.stop()


# -- row-range live migration ------------------------------------------------


class _SparseMigExec(MiniExec):
    def _write_var(self, scope, name, val):
        scope[name] = val  # keep SelectedRows grads un-coerced


def _sparse_sgd(scope):
    g = scope["emb@GRAD"]
    rows = np.asarray(g.rows(), dtype=np.int64)
    vals = np.asarray(g._value)
    emb = np.array(scope["emb"], copy=True)
    emb[rows] -= np.float32(0.1) * vals  # row-local, like pslib sgd
    scope["emb"] = emb


def _range_factory(gname):
    if gname.split("@", 1)[0] == "emb":
        return _sparse_sgd
    return _sgd_factory(gname)


def _mk_range_fixture(monkeypatch, height=16, width=4, lease_ms=400):
    """2 shards x (primary+backup): each shard holds its LOCAL slice
    of a height-``height`` sparse table ``emb`` (global rows sliced by
    ``row_range``) plus one dense var to drive the round barrier, the
    block factory armed so a recipient can rebuild the sparse
    optimize block for a range it adopts."""
    from paddle_tpu_torch.distributed.ps_rpc import PSServer
    from paddle_tpu_torch.distributed.ps_shard import (ShardedPSClient,
                                                 row_range)

    _fast_env(monkeypatch)
    # the donor's migration client inherits the replication deadline
    # captured at server construction: keep it tight so a blackholed
    # install fails fast instead of stalling the apply
    monkeypatch.setenv("PADDLE_PS_REPL_DEADLINE", "2")
    names = _shard_var_names(2)
    groups = [_eps(2), _eps(2)]
    servers = []
    for si, grp in enumerate(groups):
        lo, hi = row_range(si, height, 2)
        for ep in grp:
            scope = MiniScope()
            scope[names[si]] = np.zeros(4, dtype=np.float32)
            scope["emb"] = (np.arange(lo, hi, dtype=np.float32)
                            .reshape(-1, 1)
                            * np.ones((1, width), "f4"))
            g2b = {names[si] + "@GRAD": _sgd_factory(
                names[si] + "@GRAD"), "emb@GRAD": _sparse_sgd}
            s = PSServer(ep, _SparseMigExec(), scope, g2b, fanin=1,
                         endpoints=grp, lease_ms=lease_ms, shard=si,
                         block_factory=_range_factory)
            s.start_background()
            servers.append((s, scope))
    c = ShardedPSClient([",".join(g) for g in groups], trainer_id=0)
    return names, groups, servers, c


def _emb_oracle(height, width):
    return (np.arange(height, dtype=np.float32).reshape(-1, 1)
            * np.ones((1, width), "f4"))


def _push_round(c, oracle, rows, rnd, height, width):
    """Push one deterministic grad per row through the router AND
    fold it into the plain-numpy oracle (row-local sgd, lr 0.1)."""
    rows = np.asarray(rows, dtype=np.int64)
    vals = (np.float32(0.01) * np.float32(rnd)
            * (rows.astype(np.float32) + 1.0)[:, None]
            * np.ones((1, width), "f4"))
    c.push_sparse("emb@GRAD", rows, vals, height=height, param="emb")
    oracle[rows] = oracle[rows] - np.float32(0.1) * vals


def test_range_migration_end_to_end(monkeypatch):
    """Move GLOBAL rows [4, 8) of a sliced sparse table from shard 0
    to shard 1 mid-training: the map grows a per-range entry, moved
    rows re-base to recipient-LOCAL ids past its resident slice,
    pushes keep landing exactly once on both sides of the split, the
    donor's slice is zero-tombstoned after the replicated commit, and
    a fresh version-0 client self-repairs via wrong_shard."""
    from paddle_tpu_torch.distributed.ps_shard import ShardedPSClient

    height, width = 16, 4
    names, groups, servers, c = _mk_range_fixture(
        monkeypatch, height=height, width=width)
    oracle = _emb_oracle(height, width)
    all_rows = np.arange(height, dtype=np.int64)
    rounds = 6
    try:
        for rnd in range(1, rounds + 1):
            _push_round(c, oracle, all_rows, rnd, height, width)
            for vi, n in enumerate(names):
                c.send_grad(n + "@GRAD", _grad(0, rnd) + vi,
                            round=rnd)
            c.send_barrier(round=rnd)
            c.fetch_barrier()
            if rnd == 2:
                r = c.migrate_range("emb", 4, 8, to_shard=1,
                                    height=height)
                assert r.get("pending"), r
        assert c.map_version >= 1
        assert c.map_ranges.get("emb") == [(4, 8, 1, 8)]
        got = c.pull_sparse("emb", all_rows, height=height)
        assert got.tobytes() == oracle.tobytes()
        # donor hard-committed: moved local rows [4, 8) are a zero
        # tombstone on the primary AND (via the dirty-dense stream)
        # its backup
        for srv, sc in servers[:2]:
            np.testing.assert_array_equal(
                np.asarray(sc["emb"])[4:8], np.zeros((4, width), "f4"))
        # recipient family grew to local height 12 on primary+backup
        assert np.asarray(servers[2][1]["emb"]).shape[0] == 12
        assert np.asarray(servers[3][1]["emb"]).shape[0] == 12
        # a fresh hash-routed client self-repairs via wrong_shard
        c2 = ShardedPSClient([",".join(g) for g in groups],
                             trainer_id=1)
        got2 = c2.pull_sparse("emb", [5, 4, 7, 1, 12], height=height)
        assert got2.tobytes() == oracle[[5, 4, 7, 1, 12]].tobytes()
        assert c2.map_version >= 1
        c2.close()
    finally:
        c.close()
        for s, _ in servers:
            s.stop()


def test_range_migration_partition_aborts_cleanly(monkeypatch):
    """An active ``partition:1:donor|recipient`` blackhole between the
    donor and recipient primaries while trainers keep pushing rows on
    both sides of the split point: bounded install retries, then
    ROLLBACK — no override anywhere, no orphan stage servable, zero
    lost or double-applied rows — and the same move succeeds once the
    partition heals."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.distributed import fault

    height, width = 16, 4
    # a blackholed install stalls the donor's apply for the (tight)
    # replication deadline each round: keep the lease comfortably
    # above it so the test exercises the abort path, not elections
    names, groups, servers, c = _mk_range_fixture(
        monkeypatch, height=height, width=width, lease_ms=15000)
    oracle = _emb_oracle(height, width)
    all_rows = np.arange(height, dtype=np.int64)
    donor_rows = np.arange(8, dtype=np.int64)  # both sides of lo=4
    rb0 = obs.counter_value("ps.migrations", outcome="rollback") or 0
    prev_ident = fault.get_identity()
    try:
        # the partition rule severs traffic from THIS identity to the
        # named peer: stand in the donor primary's shoes
        fault.set_identity(groups[0][0])
        for rnd in (1, 2):
            _push_round(c, oracle, all_rows, rnd, height, width)
            for vi, n in enumerate(names):
                c.send_grad(n + "@GRAD", _grad(0, rnd) + vi,
                            round=rnd)
            c.send_barrier(round=rnd)
            c.fetch_barrier()
        monkeypatch.setenv("PADDLE_TPU_FAULTS", "partition:1:%s|%s"
                           % (groups[0][0], groups[1][0]))
        fault.reset_injector()
        # the migration client is created lazily at the first install
        # attempt — no in-client retries and no lease-wait loitering
        # on the recipient backup's not_primary hint: the round
        # barrier already re-drives the install
        monkeypatch.setenv("PADDLE_PS_REPL_RETRIES", "0")
        monkeypatch.setenv("PADDLE_PS_LEASE_WAIT_S", "1")
        monkeypatch.setenv("PADDLE_PS_FAILOVER_MAX", "1")
        r = c.migrate_range("emb", 4, 8, to_shard=1, height=height)
        assert r.get("pending"), r
        # shard-0-only rounds while the pair is severed (the full
        # barrier would cross the blackhole): every install attempt
        # dies on the wire, then the donor rolls back
        for rnd in range(3, 7):
            _push_round(c, oracle, donor_rows, rnd, height, width)
            c.send_grad(names[0] + "@GRAD", _grad(0, rnd), round=rnd)
            c.shards[0].barrier_prepare(round=rnd)
            c.shards[0].barrier_commit()
            c.shards[0].fetch_barrier()
        assert (obs.counter_value("ps.migrations", outcome="rollback")
                or 0) > rb0
        assert servers[0][0]._shard_map_version == 0
        assert not servers[0][0]._range_overrides
        assert "emb" not in servers[2][0]._staged_ranges
        assert c.map_version == 0 and not c.map_ranges
        monkeypatch.delenv("PADDLE_TPU_FAULTS")
        fault.reset_injector()
        # healed: rows all land exactly once, and the SAME move now
        # completes through the real protocol
        for rnd in (7, 8):
            _push_round(c, oracle, all_rows, rnd, height, width)
            for vi, n in enumerate(names):
                c.send_grad(n + "@GRAD", _grad(0, rnd) + vi,
                            round=rnd)
            c.send_barrier(round=rnd)
            c.fetch_barrier()
            if rnd == 7:
                assert c.migrate_range("emb", 4, 8, to_shard=1,
                                       height=height).get("pending")
        assert c.map_ranges.get("emb") == [(4, 8, 1, 8)]
        got = c.pull_sparse("emb", all_rows, height=height)
        assert got.tobytes() == oracle.tobytes()
    finally:
        monkeypatch.delenv("PADDLE_TPU_FAULTS", raising=False)
        fault.reset_injector()
        fault.set_identity(prev_ident)
        c.close()
        for s, _ in servers:
            s.stop()


# -- whole-job crash consistency ----------------------------------------------


def _put_frame(store, rnd, mode="full", base=None, epoch=0):
    hdr = [{"name": "w", "dtype": "float32", "shape": [4]}]
    store.put_round(rnd, hdr, np.zeros(4, np.float32).tobytes(), {},
                    mode=mode, base_round=base, epoch=epoch)


def test_roundstore_torn_delta_drops_its_chain(tmp_path):
    """A frame is restorable only with its whole anchor->delta chain
    intact: tearing a mid-chain delta drops it AND every delta stacked
    on it, while the anchor (and the previous chain) stay loadable."""
    from paddle_tpu_torch.checkpoint import CheckpointCorrupt, RoundStore

    store = RoundStore(str(tmp_path), shard=0)
    _put_frame(store, 1)
    _put_frame(store, 2, mode="delta", base=1)
    _put_frame(store, 3, mode="delta", base=2)
    assert store.restorable_rounds() == [1, 2, 3]
    blob = os.path.join(store.round_dir(2), "blob.bin")
    with open(blob, "r+b") as f:
        f.truncate(os.path.getsize(blob) // 2)
    fresh = RoundStore(str(tmp_path), shard=0)
    assert fresh.restorable_rounds() == [1], \
        "a torn delta must drop itself and everything chained past it"
    with pytest.raises(CheckpointCorrupt):
        fresh.load_round(3, lambda meta, raw: None)


def test_job_restore_round_is_the_common_cut(tmp_path):
    """Mixed per-shard progress (shard 0 durable through round 3,
    shard 1 only through round 2) restores the newest round present on
    EVERY shard — never a mixed cut."""
    from paddle_tpu_torch.checkpoint import RoundStore, job_restore_round

    s0 = RoundStore(str(tmp_path), shard=0)
    s1 = RoundStore(str(tmp_path), shard=1)
    _put_frame(s0, 1)
    _put_frame(s0, 2, mode="delta", base=1)
    _put_frame(s0, 3, mode="delta", base=2)
    _put_frame(s1, 1)
    _put_frame(s1, 2, mode="delta", base=1)
    assert job_restore_round(str(tmp_path), 2) == 2
    # the laggard catches up: the cut advances with it
    _put_frame(s1, 3, mode="delta", base=2)
    assert job_restore_round(str(tmp_path), 2) == 3
    # tearing the newest frame on ONE shard pulls the job cut back
    blob = os.path.join(s1.round_dir(3), "blob.bin")
    with open(blob, "r+b") as f:
        f.truncate(os.path.getsize(blob) // 2)
    assert job_restore_round(str(tmp_path), 2) == 2


def test_job_restore_missing_shard_is_a_typed_error(tmp_path):
    """A restore that cannot see EVERY shard group must raise the
    typed error naming the missing shard — a partial or mixed restore
    never happens silently."""
    from paddle_tpu_torch.checkpoint import (RestoreMissingShard, RoundStore,
                                       job_restore_round)

    _put_frame(RoundStore(str(tmp_path), shard=0), 1)
    with pytest.raises(RestoreMissingShard) as ei:
        job_restore_round(str(tmp_path), 2)
    assert ei.value.shard == 1
    assert "shard 1" in str(ei.value)
    # a shard dir whose every frame is torn is just as missing
    s1 = RoundStore(str(tmp_path), shard=1)
    _put_frame(s1, 1)
    blob = os.path.join(s1.round_dir(1), "blob.bin")
    with open(blob, "r+b") as f:
        f.truncate(2)
    fresh_err = pytest.raises(RestoreMissingShard,
                              job_restore_round, str(tmp_path), 2)
    assert fresh_err.value.shard == 1


def test_cold_restart_restores_bitwise_and_fences_dead_incarnation(
        monkeypatch, tmp_path):
    """The tentpole end to end in one process group: a sync primary
    with a durable dir persists every applied round; after a stop
    (standing in for SIGKILL — the frames are already on disk before
    any barrier ack) a fresh server booted with PADDLE_PS_RESTORE=1
    loads the newest round bit-for-bit, re-sends of already-applied
    rounds are dropped (exactly-once across the restart), training
    continues at cut+1, and a straggler from the dead incarnation's
    epoch is refused by the disk-restored fence."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.distributed.ps_rpc import PSClient, _bare_rpc

    _fast_env(monkeypatch)
    durable = str(tmp_path)
    eps = _eps(1)
    s0, sc0 = _mk_ps(eps, 0, durable_dir=durable)
    try:
        c = PSClient(",".join(eps), trainer_id=0)
        for rnd in range(1, 5):
            c.send_grad("w@GRAD", _grad(0, rnd), round=rnd)
            c.send_barrier(round=rnd)
            c.fetch_barrier()
        w_dead = np.asarray(sc0["w"]).copy()
        c.close()
    finally:
        s0.stop()
    # whole-job loss: nothing survives but the durable dir
    monkeypatch.setenv("PADDLE_PS_RESTORE", "1")
    s1, sc1 = _mk_ps(eps, 0, durable_dir=durable)
    try:
        assert s1._restored_round == 4
        assert np.asarray(sc1["w"]).tobytes() == w_dead.tobytes(), \
            "cold restore must be bit-for-bit"
        c = PSClient(",".join(eps), trainer_id=0)
        c.seed_round(4)
        # a dead-incarnation re-send (round 4 already applied) must be
        # DROPPED, not folded into round 5
        stale0 = obs.counter_value("ps.stale_rounds") or 0
        c.send_grad("w@GRAD", _grad(0, 4), round=4)
        resp = c.barrier_prepare(round=4)
        assert resp.get("stale_round"), resp
        assert (obs.counter_value("ps.stale_rounds") or 0) > stale0
        assert np.asarray(sc1["w"]).tobytes() == w_dead.tobytes()
        # the job continues exactly-once at cut+1
        c.send_grad("w@GRAD", _grad(0, 5), round=5)
        c.send_barrier(round=5)
        c.fetch_barrier()
        oracle = {"w": np.zeros(4, "f4")}
        for rnd in range(1, 6):
            oracle["w@GRAD"] = _grad(0, rnd)
            _sgd_block(oracle)
        assert np.asarray(sc1["w"]).tobytes() == oracle["w"].tobytes()
        c.close()
        # a straggler still speaking the dead incarnation's epoch is
        # refused by the restored fence, loudly
        f0 = obs.counter_value("ps.fence_refused") or 0
        resp = _bare_rpc(eps[0], {"kind": "lease_renew", "epoch": 0,
                                  "frm": "ghost"})
        assert resp.get("fenced"), resp
        assert (obs.counter_value("ps.fence_refused") or 0) > f0
    finally:
        s1.stop()


def test_cold_restart_corrupt_newest_round_falls_back_one(
        monkeypatch, tmp_path):
    """A newest round frame torn by the crash (killed mid-rename or
    mid-write) silently falls the restore back to the previous
    complete round — bit-for-bit with what round 3 looked like — and
    the trainer-side manager clamps its own resume to that cut."""
    from paddle_tpu_torch.checkpoint import CheckpointManager, RoundStore
    from paddle_tpu_torch.distributed.ps_rpc import PSClient

    _fast_env(monkeypatch)
    durable = str(tmp_path / "ps")
    eps = _eps(1)
    s0, sc0 = _mk_ps(eps, 0, durable_dir=durable)
    w_at = {}
    try:
        c = PSClient(",".join(eps), trainer_id=0)
        for rnd in range(1, 5):
            c.send_grad("w@GRAD", _grad(0, rnd), round=rnd)
            c.send_barrier(round=rnd)
            c.fetch_barrier()
            w_at[rnd] = np.asarray(sc0["w"]).copy()
        c.close()
    finally:
        s0.stop()
    store = RoundStore(durable, shard=0)
    blob = os.path.join(store.round_dir(4), "blob.bin")
    with open(blob, "r+b") as f:
        f.truncate(os.path.getsize(blob) // 2)
    monkeypatch.setenv("PADDLE_PS_RESTORE", "1")
    s1, sc1 = _mk_ps(eps, 0, durable_dir=durable)
    try:
        assert s1._restored_round == 3
        assert np.asarray(sc1["w"]).tobytes() == w_at[3].tobytes()
    finally:
        s1.stop()
    # the trainer resumes AT OR BEFORE the fallen-back cut even though
    # its own newest checkpoint (step 4) outlived the servers' round 4
    ck = tmp_path / "trainer"
    mgr = CheckpointManager(str(ck))
    for step in (2, 3, 4):
        mgr.save(step, lambda d, s=step: open(
            os.path.join(d, "step.txt"), "w").write(str(s)))
    seen = []
    got = mgr.load_at_or_before(3, lambda d: seen.append(
        open(os.path.join(d, "step.txt")).read()))
    assert got == 3 and seen == ["3"]
    assert mgr.load_at_or_before(1, lambda d: None) is None


def test_async_oplog_replays_exactly_once_on_cold_restart(
        monkeypatch, tmp_path):
    """Async/geo mode: ops acked between synthetic-round frames live
    only in the durable op log; a cold restart replays exactly the
    tail past the restored frame's watermark — bit-for-bit with the
    uninterrupted sequential oracle, nothing lost, nothing doubled."""
    from paddle_tpu_torch.distributed.ps_rpc import PSClient

    _fast_env(monkeypatch)
    durable = str(tmp_path)
    eps = _eps(1)
    s0, sc0 = _mk_ps(eps, 0, sync=False, durable_dir=durable)
    monkeypatch.setattr(s0, "_async_repl_every", 3)
    grads = [np.full(4, 0.01 * (i + 1), dtype=np.float32)
             for i in range(5)]
    try:
        c = PSClient(",".join(eps), trainer_id=0)
        for g in grads:
            c.send_grad("w@GRAD", g)
        w_dead = np.asarray(sc0["w"]).copy()
        c.close()
    finally:
        s0.stop()
    # ops 1-3 folded into the round-1 frame; 4 and 5 exist ONLY in
    # oplog.jsonl — the kill happens before their frame ships
    monkeypatch.setenv("PADDLE_PS_RESTORE", "1")
    s1, sc1 = _mk_ps(eps, 0, sync=False, durable_dir=durable)
    try:
        oracle = {"w": np.zeros(4, "f4")}
        for g in grads:
            oracle["w@GRAD"] = g
            _sgd_block(oracle)
        assert w_dead.tobytes() == oracle["w"].tobytes()
        assert np.asarray(sc1["w"]).tobytes() == oracle["w"].tobytes(), \
            "op-log replay lost or double-applied an acked async push"
    finally:
        s1.stop()


# -- program blocks: what a Fluid optimize block writes ---------------------


def _adam_program_server(ep, eps, sparse=False):
    """A server whose executor runs a Fluid ``adam`` block, its state
    named as the transpiler names it (``w_moment1_0``, not ``w@...``)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.distributed.ps_rpc import PSServer

    prog = fluid.Program()
    blk = prog._create_block()
    prog._rollback()
    state = ["w_moment1_0", "w_moment2_0", "w_beta1_pow_acc_0",
             "w_beta2_pow_acc_0"]
    blk.append_op(
        "adam", {"Param": ["w"], "Grad": ["w@GRAD"], "LearningRate": ["lr"],
                 "Moment1": [state[0]], "Moment2": [state[1]],
                 "Beta1Pow": [state[2]], "Beta2Pow": [state[3]]},
        {"ParamOut": ["w"], "Moment1Out": [state[0]],
         "Moment2Out": [state[1]], "Beta1PowOut": [state[2]],
         "Beta2PowOut": [state[3]]}, {}, infer_shape=False)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())._core
    shape = (16, 4) if sparse else (4,)
    for n, a in (("w", np.linspace(-1, 1, int(np.prod(shape)))
                  .reshape(shape)), ("lr", [0.1]),
                 (state[0], np.zeros(shape)), (state[1], np.zeros(shape)),
                 (state[2], [0.9]), (state[3], [0.999])):
        exe._write_var(scope, n, torch.tensor(np.asarray(a, "float32")))
    s = PSServer(ep, exe, scope, {"w@GRAD": blk}, fanin=1,
                 sync_mode=not sparse, endpoints=eps, anchor_every=100)
    s.start_background()
    return s, scope, exe


@pytest.mark.parametrize("sparse", [False, True])
def test_program_block_deltas_carry_every_var_the_block_wrote(
        monkeypatch, sparse):
    """Delta rounds of a primary whose optimize block is a Fluid ``adam``
    op: the backup must end bitwise equal on the param, both moments and
    the beta powers. The family rule alone (``w`` and its ``@``
    companions) would skip the moments and powers, and a sparse push's
    row slice would miss the rows Adam moved without a grad (its sparse
    update is not lazy)."""
    from paddle_tpu_torch.distributed.ps_rpc import PSClient

    _fast_env(monkeypatch)
    eps = _eps(2)
    pairs = [_adam_program_server(ep, eps, sparse) for ep in eps]
    monkeypatch.setattr(pairs[0][0], "_async_repl_every", 1)
    try:
        c = PSClient(",".join(eps), trainer_id=0)
        for rnd in range(1, 5):
            if sparse:
                c.push_sparse("w@GRAD", [rnd, 2 * rnd],
                              np.full((2, 4), 0.1 * rnd, "f4"), param="w")
            else:
                c.send_grad("w@GRAD", np.full(4, 0.1 * rnd, "f4"))
                c.send_barrier()
                c.get_param("w")
                c.fetch_barrier()
        c.close()
        names = ["w", "w_moment1_0", "w_moment2_0", "w_beta1_pow_acc_0",
                 "w_beta2_pow_acc_0"]
        prim = [np.asarray(pairs[0][2]._read_var(pairs[0][1], n))
                for n in names]
        back = [np.asarray(pairs[1][2]._read_var(pairs[1][1], n))
                for n in names]
        for n, a, b in zip(names, prim, back):
            assert a.tobytes() == b.tobytes(), n
        assert float(prim[3].ravel()[0]) == pytest.approx(0.9 ** 5)
    finally:
        for s, _, _ in pairs:
            s.stop()
