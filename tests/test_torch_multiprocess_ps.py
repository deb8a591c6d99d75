"""The port's parameter server across processes, over the real socket RPC
(``tests/dist_worker_ps_torch.py`` as pserver and trainer).

- Two processes in sync mode (one pserver, one trainer): the losses and
  the final weight are bitwise those of the untranspiled one-process run,
  as ``tests/test_multiprocess_ps.py`` holds the JAX package (constant
  starts; the server's SGD is the trainer's own op on the same grad).
- The sliced case: w [16, 8] as one row block on each of two pservers
  under Momentum, bitwise against the one-process run too (the split, the
  block-wise Momentum and the concat are exact), after
  ``tests/test_sliced_ps.py``.
- Narrow Wide&Deep with its tables row-sliced over two pservers, two
  trainers, through the port's launcher (``--server_script``,
  ``--pserver_endpoints``, ``--pserver_shards``), after
  ``tests/test_multiprocess_sparse_ps.py``: in sync mode held against the
  untranspiled program (``chip_smoke.py`` phase 67 at narrow width); in
  async mode through the Communicator, fed by globally shuffled
  InMemoryDatasets, beside two serving replicas of the launcher's serving
  role (phase 68 at narrow width).

Every subprocess runs on the CPU under its own timeout.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "dist_worker_ps_torch.py")


def _ep():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return "127.0.0.1:%d" % port


def _env(net, role="", pservers=(), ep="", **extra):
    env = dict(os.environ)
    for k in ("PADDLE_ROLE", "PADDLE_PSERVER_ENDPOINTS",
              "PADDLE_PSERVER_SHARDS", "PADDLE_TRAINER_ID",
              "PADDLE_TRAINERS_NUM", "PADDLE_TPU_METRICS_DIR"):
        env.pop(k, None)
    env.update({"PS_TEST_NET": net, "PADDLE_TRAINING_ROLE": role,
                "PS_TEST_PSERVERS": ",".join(pservers),
                "PSERVER_ENDPOINT": ep,
                "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH",
                                                          "")})
    env.update(extra)
    return env


def _oracle(net):
    """The worker's one-process run, in this process."""
    sys.path.insert(0, os.path.dirname(WORKER))
    try:
        import dist_worker_ps_torch as W
    finally:
        sys.path.pop(0)
    W.NET, W.STEPS = net, 5
    return W.oracle()


def _run_by_hand(net, n_servers, tmp_path):
    eps = [_ep() for _ in range(n_servers)]
    servers = [subprocess.Popen(
        [sys.executable, WORKER], env=_env(net, "PSERVER", eps, ep),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for ep in eps]
    out = tmp_path / ("trainer_%s.json" % net)
    try:
        tr = subprocess.run([sys.executable, WORKER, str(out)],
                            env=_env(net, "TRAINER", eps),
                            capture_output=True, text=True, timeout=120)
        assert tr.returncode == 0, tr.stderr[-3000:]
        for p in servers:
            p.wait(timeout=30)  # the trainer sent shutdown
            assert p.returncode == 0, p.stderr.read()[-3000:]
    finally:
        for p in servers:
            if p.poll() is None:
                p.kill()
            p.communicate(timeout=10)
    return json.loads(out.read_text()), eps


def test_two_process_sync_training_is_bitwise_the_one_process_run(
        tmp_path):
    got, _ = _run_by_hand("dense", 1, tmp_path)
    want = _oracle("dense")
    assert got["losses"] == want["losses"]
    assert got["w"] == want["w"]
    assert got["losses"][-1] < got["losses"][0]


def test_sliced_weight_over_two_pserver_processes(tmp_path):
    got, eps = _run_by_hand("sliced", 2, tmp_path)
    want = _oracle("sliced")
    assert sorted(got["block_eps"]) == sorted(eps)
    assert got["losses"] == want["losses"]
    assert got["w"] == want["w"]


WD_WORKER = os.path.join(REPO, "tests", "dist_worker_wide_deep_ps_torch.py")
SERVING_WORKER = os.path.join(REPO, "tests", "dist_worker_serving_torch.py")
# narrow Wide&Deep (bench.py's model, cut): global batch 64, vocab 1000;
# its first fc weight (45 x 16) sliced into a row block a server, as the
# full width's (429 x 64) is
WD_CFG = dict(batch=64, vocab=1000, slots=4, dense_dim=13, embed=8,
              hidden=[16, 8], lr=1e-3, min_block_size=256)


def _wd_module():
    import importlib.util

    spec = importlib.util.spec_from_file_location("wd_ps_worker", WD_WORKER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.CFG.update(WD_CFG)
    return mod


def _launch_wide_deep(tmp_path, mode, extra_env=None, extra_args=()):
    """2 pservers and 2 CPU trainers of the Wide&Deep worker through the
    port's launcher; returns each trainer's result."""
    eps = [_ep(), _ep()]
    env = _env("", pservers=eps, PS_WD_CFG=json.dumps(WD_CFG),
               PS_WD_MODE=mode, PS_WD_STEPS="4", PS_WD_DEVICE="cpu",
               PS_WD_OUT=str(tmp_path), **(extra_env or {}))
    env.pop("PADDLE_TRAINING_ROLE")
    logs = tmp_path / "logs"
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node=2", "--started_port=%s" % _ep().split(":")[1],
           "--log_dir", str(logs), "--server_script", WD_WORKER,
           "--pserver_endpoints", ",".join(eps), "--pserver_shards=2",
           *extra_args, WD_WORKER]
    res = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                         text=True, timeout=180)
    text = "".join(p.read_text() for p in sorted(logs.iterdir()))
    assert res.returncode == 0, res.stderr[-2000:] + text[-4000:]
    return [json.loads((tmp_path / ("trainer%d.json" % r)).read_text())
            for r in range(2)], sorted(p.name for p in logs.iterdir())


def test_wide_deep_sync_over_two_sparse_pservers_through_the_launcher(
        tmp_path):
    """Two trainers and two pservers in sync mode through the launcher's
    pserver role (``chip_smoke.py`` phase 67 at narrow width, on the CPU):
    the trainers' mean loss a round against the untranspiled program over
    the global batch from the servers' start, within 2e-4 (a table takes
    each trainer's push as its own Adam step, and a push is round-free:
    the other trainer's may land before a pull, the first round's too).
    Each trainer's first round, loss and pushes, within 1e-5 of the
    untranspiled program at its half batch on the rows it pulled. The
    losses see few pushed rows, so every pushed row on its server, with
    its moments, is held to a replay of the recorded pushes; the replay
    without one push must fail on every table and server."""
    import paddle_tpu_torch as fluid

    ranks, logs = _launch_wide_deep(tmp_path, "sync")
    assert logs == ["serverlog.0", "serverlog.1", "workerlog.0",
                    "workerlog.1"]
    mod = _wd_module()
    exe = fluid.Executor(fluid.CPUPlace())
    ref = mod.reference_run(exe, 4, str(tmp_path))
    got = np.mean([r["losses"] for r in ranks], axis=0)
    gaps = [abs(a - b) / abs(b) for a, b in zip(got, ref)]
    assert max(gaps) < 2e-4, (got, ref)
    # each trainer's first round: its loss and its pushes are the
    # untranspiled program's at its half batch on the rows it pulled
    loss_gap, grad_gap, _moved = mod.check_first_round(
        exe, str(tmp_path), [r["losses"][0] for r in ranks])
    assert loss_gap < 1e-5 and grad_gap < 1e-5, (loss_gap, grad_gap)
    # every pushed row on its server, with its moments and the beta powers,
    # is the replay of both trainers' pushes, each its own Adam step: to
    # float32 rounding (in Adam steps of lr; moments relative)
    score = mod.check_table_pushes(str(tmp_path), 2, 4)
    assert score["pairs"] == 2 * WD_CFG["slots"], score
    assert score["rows"] < 1e-3 and score["pows"] < 1e-6, score
    # a planted fault: trainer 1's last push left out of the replay
    planted = mod.check_table_pushes(str(tmp_path), 2, 4, drop={(1, 3)})
    assert planted["rows_least"] > 0.1 and planted["pows"] > 1e-4, planted
    for r in ranks:
        ps = r["per_step"]
        # a trainer's half batch: 32 rows x 4 slots pulled a step
        assert ps["rows_pulled"] == 32 * 4
        assert 0 < ps["rows_pushed"] <= 32 * 4 and ps["rpc_bytes"] > 0


def test_wide_deep_async_with_the_dataset_and_serving_roles(tmp_path):
    """``chip_smoke.py`` phase 68's job at narrow width on the CPU: async
    pservers through the Communicator, each trainer's InMemoryDataset
    globally shuffled between the two trainers (every record kept once)
    and trained by ``train_from_dataset``, and beside them the launcher's
    serving role: two replicas of a saved model behind a FleetRouter,
    their answers the predictor's own."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.inference import (AnalysisConfig,
                                            create_paddle_predictor)

    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.RandomState(0)
    n = 128
    for part in range(2):
        with open(data / ("part-%d" % part), "w") as f:
            for i in range(n):
                ids = rng.randint(0, WD_CFG["vocab"], WD_CFG["slots"])
                ids[-1] = part * n + i
                f.write("13 %s 4 %s 1 %d\n" % (
                    " ".join("%.4f" % v for v in rng.rand(13)),
                    " ".join(str(v) for v in ids), ids[0] % 2))
    model = tmp_path / "model"
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data(name="x", shape=[-1, 6], dtype="float32")
        y = fluid.layers.fc(fluid.layers.fc(x, 8, act="relu"), 3,
                            act="softmax")
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(str(model), ["x"], [y], exe,
                                      main_program=main)
    reqs = [rng.rand(k, 6).astype("float32") for k in (1, 3, 2, 4)]
    np.savez(tmp_path / "requests.npz",
             **{"%d/x" % i: r for i, r in enumerate(reqs)})
    ranks, logs = _launch_wide_deep(
        tmp_path, "async",
        {"PS_WD_DATA": str(data),
         "PADDLE_SHUFFLE_ENDPOINTS": "%s,%s" % (_ep(), _ep()),
         "PS_SERVING_MODEL": str(model), "PS_SERVING_DEVICE": "cpu",
         "PS_SERVING_REQUESTS": str(tmp_path / "requests.npz")},
        ["--serving_script", SERVING_WORKER, "--serving_replicas=2",
         "--serving_started_port=%s" % _ep().split(":")[1]])
    assert logs == ["serverlog.0", "serverlog.1", "servinglog.0",
                    "servinglog.1", "workerlog.0", "workerlog.1"]
    ids = sorted(ranks[0]["record_ids"] + ranks[1]["record_ids"])
    assert ids == list(range(2 * n))
    for r in ranks:
        assert {i // n for i in r["record_ids"]} == {0, 1}
        assert r["steps"] == len(r["record_ids"]) // 32
        assert len(r["losses"]) == r["steps"]
        assert np.isfinite(r["losses"]).all()
        assert r["communicator_pushes"] > 0
    assert ranks[0]["serving"]["requests"] == len(reqs)
    served = np.load(tmp_path / "serving_out.npz")
    cfg = AnalysisConfig(str(model))
    cfg.disable_gpu()
    pred = create_paddle_predictor(cfg)
    for i, r in enumerate(reqs):
        (t,) = pred.run({"x": r})
        np.testing.assert_allclose(served["%d/%s" % (i, t.name)],
                                   np.asarray(t.data), rtol=1e-6)
