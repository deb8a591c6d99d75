"""The port's PS socket RPC (``paddle_tpu_torch/distributed/ps_rpc.py``) on
the CPU, over loopback, and across the packages.

- The cases of ``tests/test_multiprocess_ps.py`` through the port: fanin-2
  sync rounds with a slow fetcher (the RunSyncLoop gate), a malformed
  frame answered and a duplicate token run once, the client's deadline
  against a hung server.
- Heartbeat eviction: a silent trainer leaves the fanin and the survivor's
  round completes; ``ps.evictions`` counts it.
- The launcher's shard groups (the survivability half, backups,
  witnesses and durable rounds, is tested in
  ``test_torch_survivable_ps.py``, ``test_torch_ps_failover.py`` and
  ``test_torch_ps_cross_package.py``).
- Wire parity: the same rpc sequence (sync rounds, async grads, sparse
  pulls and pushes, a heartbeat) gives a port client the same answers,
  bitwise, as a JAX client from a JAX ``PSServer``, and a JAX client the
  same as a port client from a port ``PSServer``; the two servers' sgd
  updates agree within 4 ulps. The snapshot rpc's files load in the JAX
  package.
"""
import argparse
import socket
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import observability as jobs
from paddle_tpu.distributed import ps_rpc as jrpc

import paddle_tpu_torch as fluid
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.distributed import launch as plaunch
from paddle_tpu_torch.distributed import ps_rpc
from paddle_tpu_torch.distributed import ps_shard
from paddle_tpu_torch.distributed.ps_rpc import PSClient, PSServer


def _ep():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return "127.0.0.1:%d" % port


@pytest.fixture(autouse=True)
def _clean():
    for o in (obs, jobs):
        o.reset()
        o.enable()
    PSClient.reset()
    jrpc.PSClient.reset()
    yield
    PSClient.reset()
    jrpc.PSClient.reset()


def _sgd_server(pkg, w0, fanin=1, sync=True, table0=None, **kw):
    """A started ``PSServer`` of ``pkg`` over ``w`` (sgd, lr 0.1) and, with
    ``table0``, a table ``t`` whose sparse grads run sgd too."""
    prog = pkg.Program()
    blk = prog._create_block()
    prog._rollback()
    blk.append_op("sgd", {"Param": ["w"], "Grad": ["w@GRAD"],
                          "LearningRate": ["lr"]},
                  {"ParamOut": ["w"]}, {}, infer_shape=False)
    g2b = {"w@GRAD": blk}
    if table0 is not None:
        tblk = prog._create_block()
        prog._rollback()
        tblk.append_op("sgd", {"Param": ["t"], "Grad": ["t@GRAD"],
                               "LearningRate": ["lr"]},
                       {"ParamOut": ["t"]}, {}, infer_shape=False)
        g2b["t@GRAD"] = tblk
    scope = pkg.Scope()
    if pkg is jfluid:
        exe = jfluid.Executor(jfluid.CPUPlace())._core
        put = lambda n, a: exe._write_var(scope, n, a)  # noqa: E731
    else:
        exe = fluid.Executor(fluid.CPUPlace())._core
        put = lambda n, a: exe._write_var(  # noqa: E731
            scope, n, torch.from_numpy(np.array(a)))
    put("w", w0.copy())
    put("lr", np.array([0.1], "float32"))
    if table0 is not None:
        put("t", table0.copy())
    ep = _ep()
    mod = jrpc if pkg is jfluid else ps_rpc
    server = mod.PSServer(ep, exe, scope, g2b, fanin=fanin,
                          sync_mode=sync, **kw)
    server.start_background()
    return server, ep, exe, scope


def _read(exe, scope, name):
    v = exe._read_var(scope, name)
    return v.numpy().copy() if isinstance(v, torch.Tensor) else np.array(v)


def test_fanin2_round_protocol():
    """Two trainers, three sync rounds: the fanin-th send_barrier applies
    the summed grads; a fast trainer's next round waits for the slow
    trainer's fetch. No deadlock; the updates equal summed-grad SGD."""
    w0 = np.arange(4, dtype="float32")
    server, ep, exe, scope = _sgd_server(fluid, w0, fanin=2)
    rounds, errors = 3, []

    def trainer(tid, delay):
        try:
            c = PSClient(ep, trainer_id=tid)
            for _ in range(rounds):
                c.send_grad("w@GRAD", np.full(4, float(tid + 1), "f4"))
                c.send_barrier()
                c.get_param("w")
                time.sleep(delay)  # a slow fetcher holds the next round
                c.fetch_barrier()
            c.close()
        except Exception as e:  # pragma: no cover
            errors.append((tid, e))

    ts = [threading.Thread(target=trainer, args=(0, 0.0)),
          threading.Thread(target=trainer, args=(1, 0.15))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts), "PS round deadlock"
    assert not errors, errors
    np.testing.assert_allclose(_read(exe, scope, "w"),
                               w0 - 0.1 * 3.0 * rounds, rtol=1e-6)
    c = PSClient(ep, trainer_id=9)
    assert sorted(c.heartbeat()) == [0, 1, 9]
    assert obs.histogram("ps.apply_ms", shard="0", table="_round").count \
        == rounds
    c.shutdown_server()
    c.close()
    server.stop()


def test_rpc_malformed_message_and_dedupe():
    """A malformed frame gets an {ok: false} reply and the connection
    stays usable; a duplicate token runs once; a restarted incarnation of
    a trainer (new cid) replaces its grad; another trainer's adds."""
    server, ep, exe, scope = _sgd_server(fluid, np.zeros(2, "float32"))
    try:
        host, port = ep.rsplit(":", 1)
        conn = socket.create_connection((host, int(port)), timeout=10)
        ps_rpc._send_msg(conn, {"bogus": 1})
        resp, _ = ps_rpc._recv_msg(conn)
        assert resp["ok"] is False
        g = np.ones(2, "float32")
        msg = {"kind": "send_grad", "name": "w@GRAD", "trainer_id": 5,
               "seq": 1, "cid": "aa", "array": ps_rpc._array_header(g)}
        for _ in range(2):
            ps_rpc._send_msg(conn, dict(msg), g.tobytes())
            resp, _ = ps_rpc._recv_msg(conn)
            assert resp["ok"] is True
        for extra in ({"cid": "bb"}, {"cid": "cc", "trainer_id": 6}):
            ps_rpc._send_msg(conn, dict(msg, **extra), g.tobytes())
            resp, _ = ps_rpc._recv_msg(conn)
            assert resp["ok"] is True
        # an older seq of a live cid never runs: seq 0 is at or below
        # the replicated watermark (0 for a cid no round carried), so it
        # answers ``replayed``, as the JAX package's server does
        ps_rpc._send_msg(conn, dict(msg, cid="bb", seq=0), g.tobytes())
        resp, _ = ps_rpc._recv_msg(conn)
        assert resp.get("replayed") is True
        ps_rpc._send_msg(conn, {"kind": "send_barrier", "trainer_id": 5,
                                "seq": 2, "cid": "bb"})
        resp, _ = ps_rpc._recv_msg(conn)
        assert resp["ok"] is True
        conn.close()
        np.testing.assert_allclose(_read(exe, scope, "w@GRAD"), 2 * g)
        c = PSClient(ep, trainer_id=9)
        c.shutdown_server()
        c.close()
    finally:
        server.stop()


def test_rpc_deadline_fails_fast_on_hung_server(monkeypatch):
    """A hung pserver mid-round fails the trainer's rpc within the
    deadline (the reference's grpc_client.cc deadline)."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    ep = "127.0.0.1:%d" % srv.getsockname()[1]
    stop = threading.Event()
    threading.Thread(target=lambda: (srv.accept(), stop.wait(30)),
                     daemon=True).start()
    monkeypatch.setenv("PADDLE_PS_RPC_DEADLINE", "1.5")
    monkeypatch.setenv("PADDLE_PS_RPC_RETRIES", "1")
    c = PSClient(ep, trainer_id=0, timeout=3)
    t0 = time.time()
    with pytest.raises(RuntimeError, match="deadline"):
        c.send_barrier()
    assert time.time() - t0 < 8
    assert obs.counter("rpc.timeouts", method="send_barrier").value >= 1
    c.close()
    stop.set()
    srv.close()


def test_heartbeat_eviction_completes_the_survivors_round():
    """fanin 2, one trainer never speaks: after ``evict_after`` it leaves
    the fanin and the survivor's barrier applies its grad alone; the
    heartbeat names the evicted trainer."""
    w0 = np.zeros(3, "float32")
    server, ep, exe, scope = _sgd_server(fluid, w0, fanin=2,
                                         evict_after=0.4)
    try:
        c = PSClient(ep, trainer_id=0)
        c.send_grad("w@GRAD", np.ones(3, "float32"))
        t0 = time.time()
        c.send_barrier()  # blocks until trainer 1 is evicted
        assert time.time() - t0 < 30
        np.testing.assert_allclose(c.get_param("w"), w0 - 0.1)
        c.fetch_barrier()
        hb = c.heartbeat_full()
        assert hb["evicted"] == [1] and hb["effective_fanin"] == 1
        assert obs.counter("ps.evictions").value == 1
        c.shutdown_server()
        c.close()
    finally:
        server.stop()


# -- the launcher -------------------------------------------------------------

def _launch_args(**kw):
    base = dict(pserver_endpoints="", server_script="serve.py",
                pserver_shards=1, ps_witness_endpoints="",
                ps_durable_dir="", restore=False)
    base.update(kw)
    return argparse.Namespace(**base)


def test_launcher_one_primary_a_shard():
    eps, groups, witnesses = plaunch._pserver_groups(_launch_args(
        pserver_endpoints="a:1,b:2", pserver_shards=2))
    assert eps == ["a:1", "b:2"] and groups == [["a:1"], ["b:2"]]
    assert witnesses == []


# -- wire parity --------------------------------------------------------------

def _script(client_mod, ep, sparse_ep):
    """One rpc sequence; returns every answer (arrays as raw bytes)."""
    out = []
    c = client_mod.PSClient(ep, trainer_id=0)
    for r in range(2):
        c.send_grad("w@GRAD", np.linspace(-1, 1, 6).astype("float32")
                    * (r + 1))
        c.send_barrier()
        out.append(c.get_param("w").tobytes())
        c.fetch_barrier()
    hb = c.heartbeat_full()
    out.append((hb["fanin"], hb["effective_fanin"], hb["evicted"],
                hb["round"], hb["active"], hb["shard_map"]))
    c.shutdown_server()
    c.close()
    s = client_mod.PSClient(sparse_ep, trainer_id=1)
    rows = np.array([3, 0, 3, 7], dtype=np.int64)
    out.append(s.pull_sparse("t", rows).tobytes())
    s.push_sparse("t@GRAD", np.array([0, 3], dtype=np.int64),
                  np.full((2, 5), 0.5, "float32"), param="t")
    s.send_grad("w@GRAD", np.ones(6, "float32"))  # async: applied now
    out.append(s.pull_sparse("t", np.arange(8)).tobytes())
    out.append(s.get_param("w").tobytes())
    s.shutdown_server()
    s.close()
    return out


def _parity_run(server_pkg, client_mod):
    w0 = np.linspace(0, 1, 6).astype("float32")
    t0 = np.arange(40, dtype="float32").reshape(8, 5) / 7
    sync, ep, _, _ = _sgd_server(server_pkg, w0, fanin=1)
    asy, sep, _, _ = _sgd_server(server_pkg, w0, fanin=1, sync=False,
                                 table0=t0)
    try:
        return _script(client_mod, ep, sep)
    finally:
        sync.stop()
        asy.stop()


def _ulps(a: bytes, b: bytes) -> int:
    x = np.frombuffer(a, np.float32).view(np.int32).astype(np.int64)
    y = np.frombuffer(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(x - y).max()) if x.size else 0


def test_wire_parity_between_the_packages():
    """A client of either package gets the same bits from one server; the
    two servers' sgd updates agree within 4 ulps (XLA contracts
    ``p - lr * g`` into one FMA on the CPU, torch rounds twice: the
    4-ULP FMA bound of ROADMAP.md's North star)."""
    want_j = _parity_run(jfluid, jrpc)
    assert _parity_run(jfluid, ps_rpc) == want_j  # port client, JAX server
    want_p = _parity_run(fluid, ps_rpc)
    assert _parity_run(fluid, jrpc) == want_p     # JAX client, port server
    assert len(want_j) == len(want_p)
    for a, b in zip(want_j, want_p):
        if isinstance(a, bytes):
            assert len(a) == len(b) and _ulps(a, b) <= 4
        else:
            assert a == b


def test_snapshot_files_load_in_the_jax_package(tmp_path):
    """The checkpoint rpc's tensor files cross between the packages
    through ``core/proto_format.py``."""
    from paddle_tpu.core import proto_format as jpf

    w0 = np.linspace(0, 1, 6).astype("float32")
    server, ep, exe, scope = _sgd_server(fluid, w0)
    try:
        c = PSClient(ep, trainer_id=0)
        c.checkpoint(str(tmp_path))
        c.shutdown_server()
        c.close()
    finally:
        server.stop()
    with open(tmp_path / "w", "rb") as f:
        arr = jpf.parse_lod_tensor(f.read())[0]
    np.testing.assert_array_equal(np.asarray(arr), w0)
    assert (tmp_path / "__manifest__.json").exists()


# -- the sharded client -------------------------------------------------------

def test_shard_routing_is_the_jax_package_s():
    from paddle_tpu.distributed import ps_shard as jshard

    names = ["fc_%d.w_0" % i for i in range(20)] + ["emb@GRAD", "emb"]
    for n in (1, 2, 3, 5):
        assert [ps_shard.shard_for_key(k, n) for k in names] == \
            [jshard.shard_for_key(k, n) for k in names]
        for h in (7, 100, 1000):
            for s in range(n):
                assert ps_shard.row_range(s, h, n) == \
                    jshard.row_range(s, h, n)
            rows = np.arange(h)
            for dt in (np.int32, np.int64):
                np.testing.assert_array_equal(
                    ps_shard.shard_for_rows(rows.astype(dt), h, n),
                    jshard.shard_for_rows(rows.astype(dt), h, n))
    eps = ["a:1", "b:2", "c:3", "d:4"]
    assert ps_shard.split_endpoint_groups(eps, 2) == \
        jshard.split_endpoint_groups(eps, 2)
    with pytest.raises(ValueError):
        ps_shard.split_endpoint_groups(eps, 3)


def _sharded_script(shard_mod, eps):
    """A sync round and sparse traffic through a sharded client of
    ``shard_mod`` over two servers holding ``w`` (2 rows each of an
    8-row global table ``t``)."""
    c = shard_mod.ShardedPSClient(eps, trainer_id=0)
    out = []
    c.send_grad("w@GRAD", np.linspace(-1, 1, 6).astype("float32"))
    c.send_barrier()
    out.append(c.get_param("w").tobytes())
    c.fetch_barrier()
    rows = np.array([7, 0, 3, 4, 7], dtype=np.int64)
    out.append(c.pull_sparse("t", rows, 8).tobytes())
    c.push_sparse("t@GRAD", np.array([0, 5], dtype=np.int64),
                  np.full((2, 5), 0.25, "float32"), 8, param="t")
    out.append(c.pull_sparse("t", np.arange(8), 8).tobytes())
    c.close()
    return out


def test_the_sharded_client_gives_the_jax_client_s_bits():
    """Two port servers (w on both, each its row half of t); the port's
    ShardedPSClient and the JAX package's send the same rpcs and read the
    same bits."""
    from paddle_tpu.distributed import ps_shard as jshard

    got = []
    for mod in (jshard, ps_shard):
        servers = []
        for k in range(2):
            t0 = (np.arange(20, dtype="float32").reshape(4, 5) + 20 * k) / 9
            servers.append(_sgd_server(fluid, np.zeros(6, "float32"),
                                       table0=t0))
        try:
            got.append(_sharded_script(mod, [s[1] for s in servers]))
        finally:
            for s in servers:
                s[0].stop()
    assert got[0] == got[1]
