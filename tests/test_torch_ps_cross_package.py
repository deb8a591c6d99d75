"""The survivable parameter server across the two packages, in both
directions.

- A JAX primary streams delta rounds to a port backup that takes over
  when the primary dies, and the reverse: with callable blocks (bitwise
  on the clean run, and no re-anchor: both packages digest the same
  bytes) and with the executors' own ``sgd`` program blocks.
- A server of one package rejoins a group of the other through its
  ``join_backup`` snapshot and finishes the job after a second kill.
- A group of one package elects through the other's ``PSWitness``.
- A var migrates between shard groups of the two packages, driven by a
  sharded client.
- A ``RoundStore`` directory written by one package's primary
  cold-restores in the other's server, which fences the dead incarnation.
- One seeded in-process chaos schedule (``tools/torch_chaos_drill.py``)
  gives the same parameters through both packages.

Tolerances: bitwise wherever both servers run the same float32 ops (the
tests' callable blocks: numpy's ``w - 0.1 * g`` and torch's round the
same way). Where the packages' executors apply ``sgd`` themselves, 4
ulps: XLA contracts ``p - lr * g`` into one FMA on the CPU and torch
rounds twice (the bound of ``test_torch_ps_rpc.py``'s wire parity).
"""
import time

import numpy as np
import pytest
import torch

from test_torch_ps_failover import (MiniExec, MiniScope, _clean_w, _eps,
                                    _fast_failover_env, _grad, _mk_ps,
                                    _mods, _obs, _rejoin_cycle,
                                    _sgd_block, _two_trainers)


@pytest.mark.parametrize("primary,backup", [("jax", "torch"),
                                            ("torch", "jax")])
def test_cross_package_failover_bitwise(monkeypatch, primary, backup):
    """A primary of one package streams delta rounds to a backup of the
    other, which takes over when the primary dies mid-round: the
    trainers (clients of the backup's package) finish bitwise on the
    clean run, and the stream never re-anchored (the two packages
    digest the same bytes)."""
    _fast_failover_env(monkeypatch)
    pobs = _obs(primary)
    eps = _eps(2)
    s0, _ = _mk_ps(eps, 0, pkg=primary, anchor_every=100)
    s1, sc1 = _mk_ps(eps, 1, pkg=backup, anchor_every=100)
    a0 = pobs.counter_value("ps.anchor_rounds") or 0
    d0 = pobs.counter_value("ps.delta_rounds") or 0
    try:
        ws = _two_trainers(eps, 6, 4, s0.stop, client_pkg=backup)
        expected = _clean_w(6).tobytes()
        assert ws[0] == expected and ws[1] == expected
        assert s1._promoted
        assert np.asarray(sc1["w"]).tobytes() == expected
        # rounds 1-3 reached the backup as one anchor and two deltas
        assert (pobs.counter_value("ps.anchor_rounds") or 0) - a0 == 1
        assert (pobs.counter_value("ps.delta_rounds") or 0) - d0 == 2
    finally:
        s0.stop()
        s1.stop()


def _sgd_program_server(pkg, ep, eps, w0):
    """A server of ``pkg`` whose executor runs an ``sgd`` program block
    over ``w`` (lr 0.1), in the group ``eps``."""
    if pkg == "jax":
        import paddle_tpu as P
    else:
        import paddle_tpu_torch as P
    ps_rpc = _mods(pkg)[0]
    prog = P.Program()
    blk = prog._create_block()
    prog._rollback()
    blk.append_op("sgd", {"Param": ["w"], "Grad": ["w@GRAD"],
                          "LearningRate": ["lr"]},
                  {"ParamOut": ["w"]}, {}, infer_shape=False)
    scope = P.Scope()
    exe = P.Executor(P.CPUPlace())._core
    if pkg == "jax":
        exe._write_var(scope, "w", w0.copy())
        exe._write_var(scope, "lr", np.array([0.1], "float32"))
    else:
        exe._write_var(scope, "w", torch.from_numpy(w0.copy()))
        exe._write_var(scope, "lr", torch.tensor([0.1]))
    server = ps_rpc.PSServer(ep, exe, scope, {"w@GRAD": blk}, fanin=2,
                             endpoints=eps)
    server.start_background()
    return server


def _ulps(a: bytes, b: bytes) -> int:
    x = np.frombuffer(a, np.float32).view(np.int32).astype(np.int64)
    y = np.frombuffer(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(x - y).max())


@pytest.mark.parametrize("primary,backup", [("jax", "torch"),
                                            ("torch", "jax")])
def test_cross_package_failover_program_blocks(monkeypatch, primary,
                                                backup):
    """The executors' own ``sgd`` blocks: a failover from one package's
    primary to the other's backup lands within 4 ulps of the primary's
    package running the whole job unkilled."""
    _fast_failover_env(monkeypatch)
    w0 = np.linspace(-1, 1, 4).astype("float32")
    eps = _eps(2)
    s0 = _sgd_program_server(primary, eps[0], eps, w0)
    s1 = _sgd_program_server(backup, eps[1], eps, w0)
    try:
        cross = _two_trainers(eps, 5, 3, s0.stop, client_pkg=backup)
    finally:
        s0.stop()
        s1.stop()
    ref_eps = _eps(1)
    ref = _sgd_program_server(primary, ref_eps[0], ref_eps, w0)
    try:
        clean = _two_trainers(ref_eps, 5, 3, lambda: None,
                              client_pkg=primary)
    finally:
        ref.stop()
    assert cross[0] == cross[1]
    assert _ulps(cross[0], clean[0]) <= 4, (
        np.frombuffer(cross[0], "f4"), np.frombuffer(clean[0], "f4"))


@pytest.mark.parametrize("group,rejoiner", [("jax", "torch"),
                                            ("torch", "jax")])
def test_cross_package_rejoin_catch_up(monkeypatch, group, rejoiner):
    """A server of one package rejoins a group of the other through its
    ``join_backup`` snapshot (the tensor-stream files and their
    manifest), takes the stream, and finishes the job when the group's
    last original server dies: bitwise on the clean run."""
    ws, rejoined = _rejoin_cycle(monkeypatch, (group, group, rejoiner))
    expected = _clean_w(8).tobytes()
    assert ws[0] == expected and ws[1] == expected
    assert rejoined._promoted


@pytest.mark.parametrize("servers,witness", [("torch", "jax"),
                                             ("jax", "torch")])
def test_cross_package_witness_election(monkeypatch, servers, witness):
    """A group of one package renews with, and elects through, the other
    package's ``PSWitness``: a dead primary's backup promotes on the
    witness's grant."""
    _fast_failover_env(monkeypatch)
    wit_mod = _mods(witness)[0]
    wobs = _obs(witness)
    wit_ep = _eps(1)[0]
    w = wit_mod.PSWitness(wit_ep)
    w.start_background()
    eps = _eps(2)
    s0, _ = _mk_ps(eps, 0, pkg=servers, lease_ms=400,
                   witnesses=[wit_ep])
    s1, _ = _mk_ps(eps, 1, pkg=servers, lease_ms=400,
                   witnesses=[wit_ep])
    v0 = wobs.counter_value("ps.witness_votes", shard="0") or 0
    r0 = wobs.counter_value("ps.witness_renewals", shard="0") or 0
    try:
        deadline = time.time() + 5
        while (wobs.counter_value("ps.witness_renewals", shard="0")
               or 0) <= r0 and time.time() < deadline:
            time.sleep(0.05)
        assert (wobs.counter_value("ps.witness_renewals", shard="0")
                or 0) > r0, "the primary never renewed with the witness"
        s0.stop()
        deadline = time.time() + 10
        while not s1._promoted and time.time() < deadline:
            time.sleep(0.05)
        assert s1._promoted, "no promotion through the witness"
        assert (wobs.counter_value("ps.witness_votes", shard="0")
                or 0) > v0
    finally:
        s0.stop()
        s1.stop()
        w.stop()


def _sgd_factory(gname):
    base = gname.split("@", 1)[0]

    def blk(scope):
        scope[base] = scope[base] - np.float32(0.1) * scope[gname]
    return blk


@pytest.mark.parametrize("donor,recipient", [("jax", "torch"),
                                              ("torch", "jax")])
def test_cross_package_live_migration(monkeypatch, donor, recipient):
    """Shard 0's group of one package migrates its var to shard 1's group
    of the other (``migrate_begin`` from the recipient's package's sharded
    client, ``migrate_install`` / ``migrate_commit`` between the
    packages' primaries, the map riding both streams): the client adopts
    the bumped map, both recipient members hold the var, and the params
    stay on the oracle."""
    _fast_failover_env(monkeypatch)
    ps_shard = _mods(recipient)[1]
    names = []
    for s in range(2):
        i = 0
        while True:
            cand = "w%d" % i
            if ps_shard.shard_for_key(cand, 2) == s and cand not in names:
                names.append(cand)
                break
            i += 1
    groups = [_eps(2), _eps(2)]
    srv = []
    for si, grp in enumerate(groups):
        pkg = donor if si == 0 else recipient
        for ep in grp:
            scope = MiniScope(torch_tensors=pkg == "torch")
            scope[names[si]] = np.zeros(4, dtype=np.float32)
            s = _mods(pkg)[0].PSServer(
                ep, MiniExec(), scope,
                {names[si] + "@GRAD": _sgd_factory(names[si] + "@GRAD")},
                fanin=1, endpoints=grp, lease_ms=400, shard=si,
                block_factory=_sgd_factory)
            s.start_background()
            srv.append((s, scope))
    c = ps_shard.ShardedPSClient([",".join(g) for g in groups],
                                 trainer_id=0)
    try:
        ws = {}
        for rnd in range(1, 6):
            for vi, n in enumerate(names):
                c.send_grad(n + "@GRAD", _grad(0, rnd) + vi, round=rnd)
            c.send_barrier(round=rnd)
            ws = {n: c.get_param(n) for n in names}
            c.fetch_barrier()
            if rnd == 2:
                assert c.migrate(names[0], 1).get("pending")
        assert c.map_version == 1 and c.map_overrides == {names[0]: 1}
        for vi, n in enumerate(names):
            exp = {"w": np.zeros(4, "f4")}
            for rnd in range(1, 6):
                exp["w@GRAD"] = _grad(0, rnd) + vi
                _sgd_block(exp)
            assert ws[n].tobytes() == exp["w"].tobytes(), n
        assert names[0] in srv[2][1] and names[0] in srv[3][1]
        assert names[0] not in srv[0][1] and names[0] not in srv[1][1]
    finally:
        c.close()
        for s, _ in srv:
            s.stop()


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_cross_package_roundstore_cold_restore(monkeypatch, tmp_path,
                                               writer, reader):
    """A durable directory written by one package's primary (anchors and
    delta frames) cold-restores bitwise in the other package's server,
    which fences the dead incarnation and trains on at cut + 1."""
    _fast_failover_env(monkeypatch)
    durable = str(tmp_path)
    eps = _eps(1)
    s0, sc0 = _mk_ps(eps, 0, fanin=1, pkg=writer, durable_dir=durable,
                     anchor_every=3)
    try:
        c = _mods(writer)[0].PSClient(eps[0], trainer_id=0)
        for rnd in range(1, 6):
            c.send_grad("w@GRAD", _grad(0, rnd), round=rnd)
            c.send_barrier(round=rnd)
            c.fetch_barrier()
        w_dead = np.asarray(sc0["w"]).copy()
        c.close()
    finally:
        s0.stop()
    if reader == "torch":
        from paddle_tpu_torch.checkpoint import job_restore_round
    else:
        from paddle_tpu.checkpoint import job_restore_round
    assert job_restore_round(durable, 1) == 5
    monkeypatch.setenv("PADDLE_PS_RESTORE", "1")
    s1, sc1 = _mk_ps(eps, 0, fanin=1, pkg=reader, durable_dir=durable)
    try:
        assert s1._restored_round == 5
        assert np.asarray(sc1["w"]).tobytes() == w_dead.tobytes()
        c = _mods(reader)[0].PSClient(eps[0], trainer_id=0)
        c.seed_round(5)
        c.send_grad("w@GRAD", _grad(0, 6), round=6)
        c.send_barrier(round=6)
        c.fetch_barrier()
        c.close()
        oracle = {"w": np.zeros(4, "f4")}
        for rnd in range(1, 7):
            oracle["w@GRAD"] = _grad(0, rnd)
            _sgd_block(oracle)
        assert np.asarray(sc1["w"]).tobytes() == oracle["w"].tobytes()
        resp = _mods(reader)[0]._bare_rpc(
            eps[0], {"kind": "lease_renew", "epoch": 0, "frm": "ghost"})
        assert resp.get("fenced"), resp
    finally:
        s1.stop()


def test_cross_package_chaos_schedule_same_params():
    """One seeded chaos schedule (frame faults, a primary kill) through
    both packages' servers and clients: the same parameters, equal to
    the clean run."""
    import torch_chaos_drill

    from paddle_tpu.distributed import fault as jfault
    from paddle_tpu.distributed import ps_rpc as jrpc
    from paddle_tpu.distributed import ps_shard as jshard

    sched = torch_chaos_drill.make_schedule(31, sync_rounds=5,
                                            fault=jfault)
    port = torch_chaos_drill.run_inprocess(sched)
    jax = torch_chaos_drill.run_inprocess(sched, ps_rpc=jrpc,
                                          ps_shard=jshard, fault=jfault,
                                          torch_tensors=False)
    assert port == jax
    assert port[0]["w"] == torch_chaos_drill.oracle_w(5).tobytes()
