"""The port's Dataset, trainer stack and AsyncExecutor against the JAX
package (``dataset_module.py``, ``trainer_factory.py``,
``async_executor.py``, ``distributed/record_shuffle.py``).

- ``DatasetFactory``: a QueueDataset's batches and an InMemoryDataset's
  records equal the JAX package's, value for value, ragged (LoD) slots
  included; every record serializes to the JAX package's bytes, so the
  global shuffle routes it to the same worker.
- A two-process ``global_shuffle`` (after
  ``tests/test_multiprocess_global_shuffle.py``): records move between
  the processes, none is lost or repeated, and each worker trains what it
  owns through ``train_from_dataset``.
- ``MultiTrainer``: one worker trains the parameters the JAX package's
  one worker trains (within 1e-5: float32 through XLA's and torch's
  kernels); two Hogwild workers share the parameters and split the
  shards; the dump fields are written a worker; ``infer_from_dataset``
  changes nothing (after ``tests/test_trainer_stack.py``).
- ``AsyncExecutor`` trains from a filelist through a ``DataFeedDesc``
  whose prototext round-trips as the JAX package's does.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import async_executor as jae
from paddle_tpu.distributed import record_shuffle as jrs

import paddle_tpu_torch as fluid
from paddle_tpu_torch import async_executor as pae
from paddle_tpu_torch.distributed import record_shuffle as prs
from paddle_tpu_torch.trainer_factory import (MultiTrainer, TrainerDesc,
                                              TrainerFactory)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHUFFLE_WORKER = os.path.join(REPO, "tests", "dist_worker_shuffle_torch.py")


def _write_multislot(path, n, seed=0, ragged=False):
    """x: 4 floats whose sum decides y; with ``ragged`` a third slot of
    1-3 ids a record."""
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for _ in range(n):
            x = rng.rand(4)
            line = "4 " + " ".join("%.6f" % v for v in x) \
                + " 1 %d" % int(x.sum() > 2.0)
            if ragged:
                k = rng.randint(1, 4)
                line += " %d " % k + " ".join(
                    str(v) for v in rng.randint(0, 9, k))
            f.write(line + "\n")


def _vars(pkg, B, ragged=False):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        vs = [pkg.data(name="x", shape=[B, 4], dtype="float32"),
              pkg.data(name="y", shape=[B, 1], dtype="int64")]
        if ragged:
            vs.append(pkg.data(name="ids", shape=[-1, 1], dtype="int64",
                               lod_level=1))
    return vs


def _dataset(pkg, cls, files, B, ragged=False):
    ds = pkg.DatasetFactory().create_dataset(cls)
    ds.set_batch_size(B)
    ds.set_use_var(_vars(pkg, B, ragged))
    ds.set_filelist(list(files))
    return ds


def _plain(v):
    """(values, lod) of a feed value of either package."""
    lod = []
    if hasattr(v, "lod") and callable(v.lod):
        lod = [list(map(int, l)) for l in (v.lod() or [])]
        v = v.array if hasattr(v, "array") else v
    if isinstance(v, torch.Tensor):
        v = v.numpy()
    return np.asarray(v), lod


def _same_feeds(jb, pb):
    assert sorted(jb) == sorted(pb)
    for k in jb:
        (ja, jl), (pa, pl) = _plain(jb[k]), _plain(pb[k])
        np.testing.assert_array_equal(pa, ja.astype(pa.dtype))
        assert pl == jl, k


@pytest.mark.parametrize("ragged", [False, True])
def test_dataset_batches_and_records_equal_the_jax_package(tmp_path,
                                                           ragged):
    files = []
    for i in range(2):
        p = tmp_path / ("part-%d" % i)
        _write_multislot(p, 10, seed=i, ragged=ragged)
        files.append(str(p))
    jq = list(_dataset(jfluid, "QueueDataset", files, 4,
                       ragged)._iter_batches())
    pq = list(_dataset(fluid, "QueueDataset", files, 4,
                       ragged)._iter_batches())
    assert len(pq) == len(jq) == 5
    for jb, pb in zip(jq, pq):
        _same_feeds(jb, pb)
    jm = _dataset(jfluid, "InMemoryDataset", files, 4, ragged)
    pm = _dataset(fluid, "InMemoryDataset", files, 4, ragged)
    jm.load_into_memory()
    pm.load_into_memory()
    assert pm.get_memory_data_size() == jm.get_memory_data_size() == 20
    for jr, pr in zip(jm._records, pm._records):
        _same_feeds(jr, pr)
        # the same payload bytes: the global shuffle's routing agrees
        assert prs._serialize_record(pr)[1] == \
            jrs._serialize_record(jr)[1]
    before = sorted(float(_plain(r["x"])[0].ravel()[0])
                    for r in pm._records)
    pm.local_shuffle()
    assert sorted(float(_plain(r["x"])[0].ravel()[0])
                  for r in pm._records) == before
    for jb, pb in zip(jm._iter_batches(), pm._iter_batches()):
        assert sorted(jb) == sorted(pb)
    with pytest.raises(ValueError):
        fluid.DatasetFactory().create_dataset("NoSuchDataset")


def _ep():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return "127.0.0.1:%d" % port


def test_global_shuffle_moves_records_between_two_processes(tmp_path):
    n_rec = 40
    files = []
    for k in range(2):
        p = tmp_path / ("part-%d" % k)
        with open(p, "w") as f:
            for i in range(n_rec):
                f.write("4 0.1 0.2 0.3 0.4 1 %d\n" % (k * 1000 + i))
        files.append(str(p))
    eps = [_ep(), _ep()]
    outs = [tmp_path / ("out%d.json" % k) for k in range(2)]
    procs = []
    for k in range(2):
        env = dict(os.environ)
        env["PADDLE_SHUFFLE_ENDPOINTS"] = ",".join(eps)
        env["PADDLE_TRAINER_ID"] = str(k)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        procs.append(subprocess.Popen(
            [sys.executable, SHUFFLE_WORKER, str(outs[k]), files[k]],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    try:
        for p in procs:
            _, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    results = [json.loads(o.read_text()) for o in outs]
    for k, r in enumerate(results):
        assert r["before"] == [k * 1000 + i for i in range(n_rec)]
        assert {v // 1000 for v in r["after"]} == {0, 1}, r["after"]
        assert r["steps"] == len(r["after"]) // 2
    merged = sorted(results[0]["after"] + results[1]["after"])
    assert merged == sorted(results[0]["before"] + results[1]["before"])


def _program(pkg, B):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.data(name="x", shape=[B, 4], dtype="float32")
        y = pkg.data(name="y", shape=[B, 1], dtype="int64")
        pred = pkg.layers.fc(x, 2, act="softmax")
        loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, y))
        pkg.optimizer.SGD(0.2).minimize(loss)
    return main, startup, x, y, loss


def _files(tmp_path, n_files=4, rows=32):
    out = []
    for i in range(n_files):
        p = tmp_path / ("part-%d" % i)
        _write_multislot(p, rows, seed=i)
        out.append(str(p))
    return out


def _train(pkg, files, thread, start=None, dump=None, B=8):
    main, startup, x, y, loss = _program(pkg, B)
    if dump:
        main._fleet_opt = {"dump_fields": [loss.name],
                           "dump_fields_path": dump}
    ds = pkg.DatasetFactory().create_dataset("QueueDataset")
    ds.set_batch_size(B)
    ds.set_use_var([x, y])
    ds.set_filelist(files)
    scope = pkg.Scope()
    place = jfluid.CPUPlace() if pkg is jfluid else fluid.CPUPlace()
    exe = pkg.Executor(place)
    names = [p.name for p in main.global_block().all_parameters]
    with pkg.scope_guard(scope):
        exe.run(startup)
        if start is not None:
            for n in names:
                scope.var(n).get_tensor().set(torch.from_numpy(start[n]))
        before = {n: np.array(scope.find_var(n).get_tensor())
                  for n in names}
        stats = exe.train_from_dataset(main, ds, thread=thread,
                                       fetch_list=[loss])
        after = {n: np.array(scope.find_var(n).get_tensor())
                 for n in names}
    return stats, before, after


def test_one_worker_trains_as_the_jax_package(tmp_path):
    files = _files(tmp_path)
    jstats, jbefore, jafter = _train(jfluid, files, 1)
    pstats, _, pafter = _train(fluid, files, 1, start=jbefore)
    assert pstats == jstats == {"steps_per_worker": [16],
                                "total_steps": 16}
    for n in jafter:
        np.testing.assert_allclose(pafter[n], jafter[n], rtol=1e-5,
                                   atol=1e-6)
        assert not np.allclose(pafter[n], jbefore[n])


def test_two_hogwild_workers_share_the_parameters(tmp_path):
    dump = tmp_path / "dump"
    stats, before, after = _train(fluid, _files(tmp_path), 2,
                                  dump=str(dump))
    assert stats == {"steps_per_worker": [8, 8], "total_steps": 16}
    assert any(not np.allclose(before[n], after[n]) for n in before)
    assert sorted(os.listdir(dump)) == ["worker_0.txt", "worker_1.txt"]
    lines = (dump / "worker_1.txt").read_text().strip().splitlines()
    assert lines and all(len(ln.split("\t")) == 3 for ln in lines)


def test_trainer_desc_and_infer_from_dataset(tmp_path):
    desc = TrainerDesc()
    desc.class_name = "NoSuchTrainer"
    with pytest.raises(ValueError):
        TrainerFactory().create_trainer(desc)
    desc = TrainerDesc()
    desc.device_worker = "Downpour"
    assert isinstance(TrainerFactory().create_trainer(desc), MultiTrainer)
    files = _files(tmp_path, 1)
    main, startup, x, y, loss = _program(fluid, 8)
    ds = fluid.DatasetFactory().create_dataset("QueueDataset")
    ds.set_batch_size(8)
    ds.set_use_var([x, y])
    ds.set_filelist(files)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)
        w = main.global_block().all_parameters[0].name
        before = scope.find_var(w).get_tensor().numpy().copy()
        stats = exe.infer_from_dataset(main, ds, thread=2)
        after = scope.find_var(w).get_tensor().numpy()
    assert stats["total_steps"] == 4
    np.testing.assert_array_equal(before, after)


_PROTO = """
name: "MultiSlotDataFeed"
batch_size: 8
multi_slot_desc {
  slots {
    name: "x"
    type: "float"
    is_dense: true
    is_used: true
  }
  slots {
    name: "y"
    type: "uint64"
    is_dense: true
    is_used: true
  }
}
"""


def test_async_executor_trains_from_a_filelist(tmp_path):
    part = tmp_path / "part-0"
    _write_multislot(part, 64, seed=3)
    proto = tmp_path / "feed.prototxt"
    proto.write_text(_PROTO)
    desc = pae.DataFeedDesc(str(proto))
    jdesc = jae.DataFeedDesc(str(proto))
    desc.set_batch_size(8)
    jdesc.set_batch_size(8)
    desc.set_use_slots(["x"])
    jdesc.set_use_slots(["x"])
    assert desc.desc() == jdesc.desc()
    assert [s["name"] for s in desc.slots] == ["x", "y"]
    main, startup, x, y, loss = _program(fluid, 8)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        ae = fluid.AsyncExecutor(fluid.CPUPlace())
        ae.executor.run(startup)
        w = main.global_block().all_parameters[0].name
        before = scope.find_var(w).get_tensor().numpy().copy()
        stats = ae.run(main, desc, [str(part)], thread_num=1,
                       fetch=[loss], scope=scope)
        after = scope.find_var(w).get_tensor().numpy()
    assert stats["total_steps"] == 8
    assert not np.allclose(before, after)
