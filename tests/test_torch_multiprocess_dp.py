"""Multi-process data parallelism through the port: 2 OS processes over a
gloo ``torch.distributed`` group, started by
``paddle_tpu_torch.distributed.launch``. The twin of
tests/test_multiprocess_dp.py: per-step losses of the 2-process run (the
mean of the ranks' equal-size shard losses) equal the single-process
full-batch run within 1e-5 relative (float32 sums in another order), and
both ranks hold bitwise-equal parameters afterwards, for the dygraph
``DataParallel`` model and for the static program through
``CompiledProgram.with_data_parallel``. Each subprocess has a 120 s
timeout of its own.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "dist_worker_dp_torch.py")
TIMEOUT_S = 120


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _clean_env():
    env = dict(os.environ)
    for k in list(env):
        if k.startswith(("PADDLE_", "FLAGS_selected", "MASTER_")):
            env.pop(k, None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_two_process_dp_matches_single_process(tmp_path):
    env = _clean_env()
    single_dir = tmp_path / "single"
    single_dir.mkdir()
    single = subprocess.run([sys.executable, WORKER, str(single_dir)],
                            env=env, capture_output=True, text=True,
                            timeout=TIMEOUT_S)
    assert single.returncode == 0, single.stderr[-2000:]
    oracle = json.loads((single_dir / "rank0.json").read_text())
    assert oracle["nranks"] == 1

    out = tmp_path / "mp"
    out.mkdir()
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node=2", "--started_port=%d" % _free_port(),
         WORKER, str(out)],
        env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, (proc.stdout[-1000:], proc.stderr[-3000:])
    ranks = [json.loads((out / ("rank%d.json" % r)).read_text())
             for r in (0, 1)]
    assert [r["nranks"] for r in ranks] == [2, 2]
    assert [r["backend"] for r in ranks] == ["gloo", "gloo"]
    np.testing.assert_allclose(np.mean([r["losses"] for r in ranks], 0),
                               oracle["losses"], rtol=1e-5, atol=0)
    for r in ranks:
        np.testing.assert_allclose(r["static_losses"],
                                   oracle["static_losses"], rtol=1e-5,
                                   atol=0)
    params = [np.load(out / ("rank%d.npz" % r)) for r in (0, 1)]
    want = np.load(single_dir / "rank0.npz")
    assert sorted(params[0].files) == sorted(want.files)
    for k in want.files:
        assert np.array_equal(params[0][k], params[1][k]), k
        np.testing.assert_allclose(params[0][k], want[k], rtol=0,
                                   atol=1e-6, err_msg=k)


def test_a_failed_rank_fails_the_launch(tmp_path):
    """A rank that exits nonzero brings the job down with its code."""
    script = tmp_path / "die.py"
    script.write_text(
        "import os, sys, time\n"
        "if os.environ['PADDLE_TRAINER_ID'] == '1':\n"
        "    sys.exit(3)\n"
        "time.sleep(60)\n")
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node=2", "--started_port=%d" % _free_port(),
         str(script)], env=_clean_env(), capture_output=True, text=True,
        timeout=TIMEOUT_S)
    assert proc.returncode == 3, proc.stderr[-2000:]
    assert "rank 1 exited 3" in proc.stderr


_SYNC_BN_RANK = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from paddle_tpu_torch.core.registry import OpInfoMap
from paddle_tpu_torch.ops.collective_ops import (ProcessGroupAxis,
                                                 ring_axis_guard)

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + port,
                        world_size=2, rank=rank)
d = np.load(out + "/inputs.npz")
info = OpInfoMap.instance().get("batch_norm_grad")
attrs = dict(info.attrs, data_layout="NHWC", _sync_stats=True)
ins = {"X": torch.from_numpy(d["x"][rank]),
       "Scale": torch.from_numpy(d["scale"]),
       "Bias": torch.from_numpy(d["bias"]),
       "Mean": torch.zeros(3), "Variance": torch.ones(3),
       "Y@GRAD": torch.from_numpy(d["dy"][rank])}
with ring_axis_guard({0: ProcessGroupAxis()}):
    g = info.fn(ins, attrs)
np.savez(out + "/rank%d.npz" % rank,
         **{k.replace("@", "_"): v.numpy() for k, v in g.items()})
dist.destroy_process_group()
"""


def test_sync_batch_norm_grad_over_two_processes(tmp_path):
    """batch_norm_grad under sync statistics over 2 gloo processes (its
    psum differentiates as a psum of the cotangents) gives each rank the
    grads the in-process group form gives its replica: within 1e-6
    relative of the largest (float32 sums in another order)."""
    import torch

    from paddle_tpu_torch.core.registry import OpInfoMap
    from paddle_tpu_torch.ops.collective_ops import ReplicaGroup

    rng = np.random.RandomState(7)
    x = (rng.randn(2, 4, 3, 3, 3) * 2 + 3).astype("float32")
    dy = rng.randn(2, 4, 3, 3, 3).astype("float32")
    scale = (rng.rand(3) + 0.5).astype("float32")
    bias = rng.randn(3).astype("float32")
    np.savez(tmp_path / "inputs.npz", x=x, dy=dy, scale=scale, bias=bias)
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _SYNC_BN_RANK, str(r),
                               port, str(tmp_path)], env=_clean_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in (0, 1)]
    for p in procs:
        _, err = p.communicate(timeout=TIMEOUT_S)
        assert p.returncode == 0, err[-2000:]
    info = OpInfoMap.instance().get("batch_norm_grad")
    attrs = dict(info.attrs, data_layout="NHWC", _sync_stats=True)
    want = info.group_fn(
        [{"X": torch.from_numpy(x[r]), "Scale": torch.from_numpy(scale),
          "Bias": torch.from_numpy(bias), "Mean": torch.zeros(3),
          "Variance": torch.ones(3), "Y@GRAD": torch.from_numpy(dy[r])}
         for r in (0, 1)], attrs, ReplicaGroup(["cpu", "cpu"]))
    for r in (0, 1):
        got = np.load(tmp_path / ("rank%d.npz" % r))
        for k, v in want[r].items():
            v = v.numpy()
            np.testing.assert_allclose(got[k.replace("@", "_")], v,
                                       rtol=0,
                                       atol=1e-6 * np.abs(v).max(),
                                       err_msg="rank %d %s" % (r, k))
