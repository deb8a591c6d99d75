"""Failover of the port's parameter server on the CPU.

- The PS cases of ``tests/test_fault_tolerance.py`` through the port, the
  servers' scopes holding CPU torch tensors: a primary killed mid-round
  with both trainers failing over and replaying exactly once, a fresh
  client redirected by a backup without promoting it, a rejoined server
  catching up and surviving a second kill, the seeded ``random_plan``
  (the JAX package's plan, draw for draw), the chaos schedule (the JAX
  drill's), and the in-process chaos run twice with one seed.
- The launcher's half, in processes (``tests/dist_worker_ft_torch.py``
  as trainer and server under ``paddle_tpu_torch.distributed.launch``):
  a primary that SIGKILLs itself mid-round is replaced by its backup and
  relaunched as a rejoining backup; the launcher's groups, witnesses and
  restore cut.

Tolerance: bitwise against the clean computation; the servers' update is
the tests' float32 block, and failover moves bytes, never recomputes
them. ``tests/test_torch_ps_cross_package.py`` holds the cases that mix
the packages.
"""
import os
import random
import sys
import threading
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _eps(n):
    return ["127.0.0.1:%d" % _free_port() for _ in range(n)]


class MiniScope(dict):
    """A dict scope; ``torch_tensors`` keeps dense values as CPU torch
    tensors, as the port's executor does (the JAX package's servers get
    numpy values, as its executor's tests do)."""

    def __init__(self, torch_tensors=True):
        super().__init__()
        self.torch_tensors = torch_tensors

    def __setitem__(self, name, val):
        if self.torch_tensors and isinstance(val, np.ndarray):
            val = torch.from_numpy(np.ascontiguousarray(val))
        super().__setitem__(name, val)

    def local_var_names(self):
        return list(self)


class MiniExec:
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


def _mods(pkg):
    if pkg == "jax":
        from paddle_tpu.distributed import fault, ps_rpc, ps_shard
    else:
        from paddle_tpu_torch.distributed import fault, ps_rpc, ps_shard
    return ps_rpc, ps_shard, fault


def _obs(pkg):
    if pkg == "jax":
        from paddle_tpu import observability
    else:
        from paddle_tpu_torch import observability
    return observability


def _fast_failover_env(monkeypatch):
    monkeypatch.setenv("PADDLE_PS_CONNECT_TIMEOUT", "1")
    monkeypatch.setenv("PADDLE_PS_FAILOVER_CONNECT_TIMEOUT", "1")
    monkeypatch.setenv("PADDLE_PS_RPC_RETRIES", "2")
    monkeypatch.setenv("PADDLE_PS_RPC_BACKOFF_MS", "10")
    monkeypatch.setenv("PADDLE_PS_RPC_DEADLINE", "20")


def _mk_ps(eps, i, rejoin=False, fanin=2, pkg="torch", **kw):
    ps_rpc = _mods(pkg)[0]
    scope = MiniScope(torch_tensors=pkg == "torch")
    scope["w"] = np.zeros(4, dtype=np.float32)
    server = ps_rpc.PSServer(eps[i], MiniExec(), scope,
                             {"w@GRAD": _sgd_block}, fanin=fanin,
                             endpoints=eps, rejoin=rejoin, **kw)
    server.start_background()
    return server, scope


def _clean_w(rounds, dim=4):
    w = np.zeros(dim, dtype=np.float32)
    for rnd in range(1, rounds + 1):
        scope = {"w": w, "w@GRAD": _grad(0, rnd, dim)
                 + _grad(1, rnd, dim)}
        _sgd_block(scope)
        w = scope["w"]
    return w


def _two_trainers(eps, rounds, kill_at, kill, client_pkg="torch",
                  timeout=60):
    """Two trainer threads over the chain ``eps``: both send round
    ``kill_at``'s grads, then ``kill()`` runs, then they go on. Returns
    each trainer's final ``w`` bytes."""
    ps_rpc = _mods(client_pkg)[0]
    gate = threading.Barrier(3)
    errors, ws = [], {}

    def trainer(tid):
        try:
            c = ps_rpc.PSClient(",".join(eps), trainer_id=tid)
            w = None
            for rnd in range(1, rounds + 1):
                c.send_grad("w@GRAD", _grad(tid, rnd))
                if rnd == kill_at:
                    gate.wait(timeout=timeout)
                    gate.wait(timeout=timeout)
                c.send_barrier()
                w = c.get_param("w")
                c.fetch_barrier()
            ws[tid] = w.tobytes()
            c.close()
        except Exception as e:  # pragma: no cover - reported below
            errors.append((tid, e))

    ts = [threading.Thread(target=trainer, args=(t,), daemon=True)
          for t in (0, 1)]
    for t in ts:
        t.start()
    gate.wait(timeout=timeout)
    kill()
    gate.wait(timeout=timeout)
    for t in ts:
        t.join(timeout=2 * timeout)
    assert not any(t.is_alive() for t in ts), "failover deadlocked"
    assert not errors, errors
    return ws


# -- the cases of test_fault_tolerance.py -------------------------------------


def test_replicated_ps_failover_bitwise(monkeypatch):
    """Primary killed mid-round 3 (both grads in, the round never applied
    or replicated): both trainers fail over to the backup, replay their
    round logs exactly once and finish bitwise on the clean run."""
    from paddle_tpu_torch import observability as obs

    _fast_failover_env(monkeypatch)
    eps = _eps(2)
    s0, _ = _mk_ps(eps, 0)
    s1, sc1 = _mk_ps(eps, 1)
    fo0 = obs.counter_value("ps.failovers", cause="transport") or 0
    try:
        ws = _two_trainers(eps, 6, 3, s0.stop)
        expected = _clean_w(6)
        assert ws[0] == expected.tobytes() and ws[1] == expected.tobytes()
        assert s1._promoted, "backup was never promoted"
        np.testing.assert_array_equal(np.asarray(sc1["w"]), expected)
        assert (obs.counter_value("ps.failovers", cause="transport")
                or 0) >= fo0 + 2
    finally:
        s0.stop()
        s1.stop()


def test_backup_redirects_fresh_clients_no_promotion(monkeypatch):
    """A fresh client whose chain starts at a backup is redirected to the
    live primary without promoting the backup."""
    from paddle_tpu_torch.distributed.ps_rpc import PSClient

    _fast_failover_env(monkeypatch)
    eps = _eps(2)
    s0, sc0 = _mk_ps(eps, 0, fanin=1)
    s1, _ = _mk_ps(eps, 1, fanin=1)
    try:
        c = PSClient("%s,%s" % (eps[1], eps[0]), trainer_id=0)
        c.send_grad("w@GRAD", _grad(0, 1))
        c.send_barrier()
        w = c.get_param("w")
        c.fetch_barrier()
        assert c.endpoint == eps[0], "client not redirected to primary"
        assert not s1._promoted, "redirect must not promote the backup"
        exp = {"w": np.zeros(4, "f4"), "w@GRAD": _grad(0, 1)}
        _sgd_block(exp)
        np.testing.assert_array_equal(w, exp["w"])
        np.testing.assert_array_equal(np.asarray(sc0["w"]), exp["w"])
        c.close()
    finally:
        s0.stop()
        s1.stop()


def _rejoin_cycle(monkeypatch, pkgs):
    """Primary (``pkgs[0]``) dies, a relaunched server (``pkgs[2]``)
    rejoins through ``join_backup`` from the promoted backup
    (``pkgs[1]``), which then dies too: the rejoined server finishes the
    job. Each kill happens while the trainers are held between rounds
    (arrive, kill, release), so no rpc of theirs races the stop of the
    server it was sent to. Returns the trainers' final bytes and the
    rejoined server."""
    from paddle_tpu_torch.distributed.ps_rpc import PSClient

    _fast_failover_env(monkeypatch)
    eps = _eps(2)
    s0, _ = _mk_ps(eps, 0, pkg=pkgs[0])
    s1, _ = _mk_ps(eps, 1, pkg=pkgs[1])
    rounds = 8
    gate1, gate2 = threading.Barrier(3), threading.Barrier(3)
    errors, ws = [], {}

    def trainer(tid):
        try:
            c = PSClient(",".join(eps), trainer_id=tid)
            w = None
            for rnd in range(1, rounds + 1):
                if rnd == 3:  # s0 killed, s0b started
                    gate1.wait(timeout=60)
                    gate1.wait(timeout=60)
                if rnd == 6:  # s0b caught up, s1 killed
                    gate2.wait(timeout=60)
                    gate2.wait(timeout=60)
                c.send_grad("w@GRAD", _grad(tid, rnd))
                c.send_barrier()
                w = c.get_param("w")
                c.fetch_barrier()
            ws[tid] = w.tobytes()
            c.close()
        except Exception as e:  # pragma: no cover
            errors.append((tid, e))

    s0b = None
    try:
        ts = [threading.Thread(target=trainer, args=(t,), daemon=True)
              for t in (0, 1)]
        for t in ts:
            t.start()
        gate1.wait(timeout=60)  # rounds 1-2 done
        s0.stop()
        s0b, _ = _mk_ps(eps, 0, rejoin=True, pkg=pkgs[2])
        gate1.wait(timeout=60)
        gate2.wait(timeout=60)  # rounds 3-5 done on s1
        # caught up and holding the stream's newest round
        deadline = time.time() + 30
        while not (s0b._caught_up
                   and s0b._applied_round == s1._applied_round) \
                and time.time() < deadline:
            time.sleep(0.05)
        assert s0b._caught_up, "rejoined server never caught up"
        assert s0b._applied_round == s1._applied_round
        s1.stop()
        gate2.wait(timeout=60)
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts), "deadlocked"
        assert not errors, errors
        return ws, s0b
    finally:
        s0.stop()
        s1.stop()
        if s0b is not None:
            s0b.stop()


def test_rejoined_server_catches_up_and_survives_second_kill(
        monkeypatch):
    """Failover, the rejoin catch-up from the promoted backup, a second
    kill and the rejoined server promoted: the params stay bitwise."""
    ws, rejoined = _rejoin_cycle(monkeypatch, ("torch",) * 3)
    expected = _clean_w(8).tobytes()
    assert ws[0] == expected and ws[1] == expected
    assert rejoined._promoted, "rejoined server never promoted"


def test_random_plan_seeded_and_parses():
    """One rng seed, one plan; it parses; and the JAX package draws the
    same plan from the same seed."""
    from paddle_tpu.distributed import fault as jfault

    from paddle_tpu_torch.distributed.fault import parse_plan, random_plan

    plans = {random_plan(random.Random(5)) for _ in range(3)}
    assert len(plans) == 1, "same rng seed must yield one plan"
    plan = plans.pop()
    assert parse_plan(plan), plan
    assert random_plan(random.Random(6)) != plan
    for seed in range(20):
        kw = dict(partition_peers=["a:1|b:2", "c:3|d:4"],
                  clock_jitter_ms=300) if seed % 2 else {}
        assert random_plan(random.Random(seed), **kw) == \
            jfault.random_plan(random.Random(seed), **kw)


def test_chaos_schedule_deterministic():
    """Same seed, same schedule; a different seed, another; and the
    schedule is the JAX drill's, draw for draw."""
    import chaos_drill
    import torch_chaos_drill

    from paddle_tpu_torch.distributed.fault import parse_plan

    a = torch_chaos_drill.make_schedule(4242, sync_rounds=6)
    assert a == torch_chaos_drill.make_schedule(4242, sync_rounds=6)
    assert torch_chaos_drill.make_schedule(4243, sync_rounds=6) != a
    assert parse_plan(a["plan"])
    assert 1 <= a["trainer_kill_round"] <= 5
    assert 1 <= a["server_kill_round"] <= 5
    assert a["trainer_kill_rank"] in (0, 1)
    for kw in ({}, {"shards": 2, "partition": True},
               {"shards": 2, "migrate": True, "sync_rounds": 8},
               {"shards": 2, "evict": True}):
        kw = dict({"sync_rounds": 6}, **kw)
        assert torch_chaos_drill.make_schedule(4242, **kw) == \
            chaos_drill.make_schedule(4242, **kw)


def test_chaos_inprocess_same_seed_same_params():
    """Seeded frame faults and a primary kill against in-process servers,
    twice with one seed: both runs land on the clean run's params."""
    import torch_chaos_drill

    sched = torch_chaos_drill.make_schedule(99, sync_rounds=5)
    first = torch_chaos_drill.run_inprocess(sched)
    second = torch_chaos_drill.run_inprocess(sched)
    expected = torch_chaos_drill.oracle_w(5).tobytes()
    assert first[0]["w"] == expected and first[1]["w"] == expected
    assert second == first


# -- the launcher's half ------------------------------------------------------


def test_launcher_relaunches_killed_pserver_as_rejoining_backup(tmp_path):
    """Under the port's launcher: the primary SIGKILLs itself while
    applying round 2 (applied locally, never replicated); its backup wins
    the election, both trainers fail over and replay, and the launcher
    relaunches the dead server with ``PADDLE_PS_REJOIN=1``: it catches
    up from the promoted backup and answers as a caught-up backup. Both
    trainers end bitwise on the clean run."""
    import json
    import subprocess

    import torch_chaos_drill

    worker = os.path.join(REPO, "tests", "dist_worker_ft_torch.py")
    eps = _eps(2)
    env = dict(os.environ)
    env.update({
        "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", ""),
        "PSERVER_ENDPOINT": ",".join(eps), "FT_ROUNDS": "4",
        "FT_SERVER_DIE_AT_ROUND": "2", "FT_DIE_AT_ROUND": "0",
        "FT_BALLAST_FLOATS": "64", "FT_WAIT_CAUGHT_UP": "1",
        "FT_OUT": str(tmp_path / "out"),
        "PADDLE_PS_LEASE_MS": "800", "PADDLE_PS_EVICT_AFTER": "0",
        "PADDLE_PS_CONNECT_TIMEOUT": "20",
        "PADDLE_PS_FAILOVER_CONNECT_TIMEOUT": "1",
        "PADDLE_PS_RPC_DEADLINE": "30"})
    for k in ("PADDLE_TPU_FAULTS", "PADDLE_TPU_METRICS_DIR"):
        env.pop(k, None)
    logs = tmp_path / "logs"
    res = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node=2", "--max_restarts=1",
         "--started_port=%d" % _free_port(), "--log_dir=%s" % logs,
         "--server_script=%s" % worker,
         "--pserver_endpoints=%s" % ",".join(eps), worker],
        env=env, cwd=REPO, timeout=180, capture_output=True, text=True)
    server_log = "".join((logs / ("serverlog.%d" % i)).read_text()
                         for i in range(2))
    assert res.returncode == 0, res.stderr[-3000:] + server_log[-3000:]
    expected = torch_chaos_drill.oracle_w(4).tobytes()
    for tid in (0, 1):
        with open(str(tmp_path / ("out.t%d.json" % tid))) as f:
            out = json.load(f)
        assert np.asarray(out["w"], np.float32).tobytes() == expected
        assert out["failovers"] >= 1
        # both members serve again, one of them active
        states = list(out["caught_up"].values())
        assert all(x["caught_up"] for x in states), states
        assert sorted(bool(x["active"]) for x in states) == [False, True]
    assert "rejoined as backup" in server_log
    assert "relaunching as a catching-up backup" in res.stderr


def _launch_args(**kw):
    import argparse

    base = dict(pserver_endpoints="", server_script="serve.py",
                pserver_shards=1, ps_witness_endpoints="",
                ps_durable_dir="", restore=False)
    base.update(kw)
    return argparse.Namespace(**base)


def test_launcher_groups_witnesses_and_restore_cut(tmp_path, monkeypatch):
    """The launcher slices primary + backup groups a shard and names the
    witnesses; with a durable root it bumps the incarnation in
    ``job.json`` and computes the restore cut every shard can reach
    (``--restore`` on an empty root is the typed error naming the
    shard)."""
    from paddle_tpu_torch.checkpoint import (RestoreMissingShard,
                                             RoundStore,
                                             read_job_manifest)
    from paddle_tpu_torch.distributed import launch as plaunch

    monkeypatch.delenv("PADDLE_INCARNATION", raising=False)
    eps, groups, wit = plaunch._pserver_groups(_launch_args(
        pserver_endpoints="a:1,b:2,c:3,d:4", pserver_shards=2,
        ps_witness_endpoints="w:9"))
    assert groups == [["a:1", "b:2"], ["c:3", "d:4"]] and wit == ["w:9"]
    with pytest.raises(SystemExit):
        plaunch._pserver_groups(_launch_args(ps_witness_endpoints="w:9"))
    root = str(tmp_path / "durable")
    args = _launch_args(pserver_endpoints="a:1,b:2", pserver_shards=2,
                        ps_durable_dir=root)
    assert plaunch._restore_cut(args, ["a:1", "b:2"], 2) == (root, None)
    assert read_job_manifest(root)["incarnation"] == 0
    with pytest.raises(RestoreMissingShard):
        plaunch._restore_cut(_launch_args(ps_durable_dir=root,
                                          restore=True), ["a:1", "b:2"], 2)
    hdr = [{"name": "w", "dtype": "float32", "shape": [4]}]
    raw = np.zeros(4, np.float32).tobytes()
    for shard, last in ((0, 3), (1, 2)):
        store = RoundStore(root, shard)
        store.put_round(1, hdr, raw, {})
        for r in range(2, last + 1):
            store.put_round(r, hdr, raw, {}, mode="delta", base_round=r - 1)
    assert plaunch._restore_cut(args, ["a:1", "b:2"], 2) == (root, 2)
    doc = read_job_manifest(root)
    # the refused restore launched nothing: this is the second launch
    assert doc["incarnation"] == 1 and doc["restore_round"] == 2
    assert os.environ["PADDLE_INCARNATION"] == "1"
