"""The device trace's pure half through the port against the JAX package.

The JAX package folds an XPlane capture (device op events resolved to
their ``named_scope`` path through the HLO op names); the port folds the
kernel records of a ``torch.profiler`` chrome trace, each tied by its
correlation id to the ``record_function("<phase>/<op_type>")`` range that
launched it. The cases of ``tests/test_device_trace.py`` that need no
capture run through both: the same intervals, given to the JAX fold as an
XPlane fixture and to the port's as kernel records whose range is the op
name, fold to the same report (per-phase device time as the union of the
phase's intervals, overlap, critical path, unattributed time, the
``None`` of a trace with no phase). ``cross_check`` and the env switch
give the same answers. ``kernel_events`` resolves each kernel's range
through its launch on a constructed chrome trace, and
``device_profile_step`` on the CPU (no kernel records) returns None,
the fallback contract.
"""
import numpy as np
import pytest

import paddle_tpu_torch as fluid
from paddle_tpu.observability import device_trace as jdtr
from paddle_tpu_torch.observability import device_trace as dtr
from paddle_tpu_torch.observability import profiler as prof

MS = 1_000_000_000   # ps per ms


def both(events, steps=1, host=()):
    """``events``: (op name or None, ts_ms, dur_ms); the JAX fixture and
    the port's kernel records of the same intervals, folded."""
    hlo, jevs, pevs = {}, [], []
    for k, (name, ts, dur) in enumerate(events):
        ev = "k%d" % k
        if name is not None:
            hlo[ev] = "jit(f)/jit(main)/" + name
        jevs.append({"name": ev, "ts_ps": int(ts * MS),
                     "dur_ps": int(dur * MS), "stats": {}})
        pevs.append({"name": "kernel_%d" % k, "ts_us": ts * 1e3,
                     "dur_us": dur * 1e3, "range": name})
    for name, ts, dur in host:   # host machinery: no HLO op behind it
        jevs.append({"name": name, "ts_ps": int(ts * MS),
                     "dur_ps": int(dur * MS), "stats": {}})
    space = {"planes": [{"name": "/host:CPU", "hlo_op_names": hlo,
                         "lines": [{"name": "t0", "timestamp_ns": 0,
                                    "events": jevs}]}]}
    return (jdtr.fold_device_phases(space, steps=steps),
            dtr.fold_device_phases(pevs, steps=steps))


KEYS = ("device_phase_ms", "overlap_frac", "critical_path_ms",
        "compute_ms", "collective_ms", "exposed_collective_ms",
        "unattributed_ms", "n_attributed", "steps")


def assert_same(j, p):
    for k in KEYS:
        if isinstance(j[k], dict):
            assert set(p[k]) == set(j[k]), k
            for ph in j[k]:
                assert p[k][ph] == pytest.approx(j[k][ph]), (k, ph)
        elif j[k] is None:
            assert p[k] is None, k
        else:
            assert p[k] == pytest.approx(j[k]), k


def test_phase_of_op_name():
    for name in ("jit(step)/jit(main)/backward/mul_grad/dot_general",
                 "collective/c_bucket_allreduce/psum", "forward/mul",
                 "optimizer/fused_optimizer", "jit(f)/reduce_sum", "",
                 None):
        assert dtr.phase_of_op_name(name) == jdtr.phase_of_op_name(name)
    assert dtr.phase_of_op_name("backward/matmul_grad") == "backward"


def test_fold_overlapped_and_serialized_phases():
    # forward, a backward the collective overlaps, then an optimizer
    j, p = both([("forward/mul", 0.0, 2.0),
                 ("backward/mul_grad", 2.0, 3.0),
                 ("collective/c_bucket_allreduce", 3.0, 2.0),
                 ("optimizer/sgd", 5.0, 1.0)])
    assert_same(j, p)
    assert p["overlap_frac"] == pytest.approx(1.0)
    assert p["critical_path_ms"] == pytest.approx(6.0)
    # the collective after all compute: nothing hidden
    j, p = both([("forward/mul", 0.0, 2.0),
                 ("backward/mul_grad", 2.0, 3.0),
                 ("collective/c_allreduce_sum", 5.0, 4.0)])
    assert_same(j, p)
    assert p["overlap_frac"] == pytest.approx(0.0)
    assert p["exposed_collective_ms"] == pytest.approx(4.0)


def test_fold_is_the_union_of_concurrent_kernels():
    j, p = both([("forward/mul", 0.0, 2.0), ("forward/mul", 1.0, 2.0)])
    assert_same(j, p)
    assert p["device_phase_ms"]["forward"] == pytest.approx(3.0)


def test_fold_accounts_unattributed_time():
    # a kernel under a range that names no phase is counted apart
    j, p = both([("forward/mul", 0.0, 1.0), ("some_new_scope/op", 1.0, 5.0)],
                host=[("ThunkExecutor::Execute", 0.0, 9.0)])
    assert_same(j, p)
    assert p["unattributed_ms"] == pytest.approx(5.0)
    assert p["kernel_records"] == 2


def test_a_trace_with_no_phase_folds_to_none():
    assert jdtr.fold_device_phases({"planes": []}) is None
    assert dtr.fold_device_phases([]) is None
    j, p = both([("unknown/op", 0.0, 1.0)])
    assert j is None and p is None


def test_fold_divides_by_steps():
    j, p = both([("forward/mul", 0.0, 2.0), ("forward/mul", 10.0, 2.0)],
                steps=2)
    assert_same(j, p)
    assert p["device_phase_ms"]["forward"] == pytest.approx(2.0)


def test_cross_check_agreement_math():
    cases = [({"forward": 2.0, "backward": 4.0},
              {"forward": 2.0, "backward": 4.0}),
             ({"forward": 2.0, "backward": 4.0},
              {"forward": 2.0, "backward": 2.0}),
             ({"optimizer": 3.0}, {}), ({}, {})]
    for host, dev in cases:
        assert dtr.cross_check(host, dev) == jdtr.cross_check(host, dev)
    cc = dtr.cross_check(*cases[1])
    assert cc["agreement"] == pytest.approx((1.0 * 2 + 0.5 * 4) / 6)


def test_capture_enabled_env(monkeypatch):
    for raw in (None, "1", "0", "yes"):
        if raw is None:
            monkeypatch.delenv("PADDLE_TPU_DEVICE_TRACE", raising=False)
        else:
            monkeypatch.setenv("PADDLE_TPU_DEVICE_TRACE", raw)
        for default in (False, True):
            assert dtr.capture_enabled(default) == \
                jdtr.capture_enabled(default)


def test_kernel_events_tie_kernels_to_their_launching_range():
    """Two ranges on one thread, a kernel launched inside each (by
    correlation), one launched outside any range, a range on another
    thread that must not claim a launch its own thread's range holds, and
    a launch from a third thread (autograd's) inside a range of the
    walk's thread, which that range claims."""
    doc = {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": "forward/mul",
         "pid": 1, "tid": 7, "ts": 100.0, "dur": 50.0},
        {"ph": "X", "cat": "user_annotation", "name": "backward/mul_grad",
         "pid": 1, "tid": 7, "ts": 200.0, "dur": 50.0},
        {"ph": "X", "cat": "user_annotation", "name": "forward/relu",
         "pid": 1, "tid": 8, "ts": 290.0, "dur": 50.0},
        {"ph": "X", "cat": "user_annotation", "name": "compiled_step",
         "pid": 1, "tid": 7, "ts": 0.0, "dur": 1000.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 7, "ts": 110.0, "dur": 5.0,
         "args": {"correlation": 11}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 7, "ts": 210.0, "dur": 5.0,
         "args": {"correlation": 12}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 7, "ts": 300.0, "dur": 5.0,
         "args": {"correlation": 13}},
        {"ph": "X", "cat": "kernel", "name": "gemm_a", "pid": 0,
         "tid": 3, "ts": 120.0, "dur": 30.0, "args": {"correlation": 11}},
        {"ph": "X", "cat": "kernel", "name": "gemm_b", "pid": 0,
         "tid": 3, "ts": 220.0, "dur": 40.0, "args": {"correlation": 12}},
        {"ph": "X", "cat": "kernel", "name": "copy", "pid": 0,
         "tid": 3, "ts": 310.0, "dur": 10.0, "args": {"correlation": 13}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 9, "ts": 230.0, "dur": 5.0,
         "args": {"correlation": 14}},
        {"ph": "X", "cat": "kernel", "name": "gemm_grad", "pid": 0,
         "tid": 3, "ts": 236.0, "dur": 1.0, "args": {"correlation": 14}},
    ]}
    evs = dtr.kernel_events(doc)
    assert [(e["name"], e["range"]) for e in evs] == [
        ("gemm_a", "forward/mul"), ("gemm_b", "backward/mul_grad"),
        ("copy", "forward/relu"), ("gemm_grad", "backward/mul_grad")]
    evs[2]["range"] = None   # a launch outside every range
    rep = dtr.fold_device_phases(evs)
    assert rep["device_phase_ms"] == {"forward": pytest.approx(0.03),
                                      "backward": pytest.approx(0.04)}
    assert rep["unattributed_ms"] == pytest.approx(0.01)


def test_device_profile_step_on_the_cpu_falls_back_to_none():
    """The CPU has no kernel records: the fold is None, the caller keeps
    the host numbers; the state is untouched and annotation is put back
    off."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data(name="dx", shape=[16, 8], dtype="float32")
        lbl = fluid.data(name="dlbl", shape=[16, 1], dtype="int64")
        h = fluid.layers.fc(x, size=32, act="relu")
        pred = fluid.layers.fc(h, size=10, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, lbl))
        fluid.optimizer.MomentumOptimizer(0.1, 0.9).minimize(loss)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    feed = {"dx": rng.rand(16, 8).astype("float32"),
            "dlbl": rng.randint(0, 10, (16, 1)).astype("int64")}
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    names = [v.name for v in main.list_vars() if v.persistable]
    before = {n: np.array(scope.find_var(n).get_tensor()) for n in names
              if scope.find_var(n) is not None}
    assert not prof.annotating()
    assert dtr.device_profile_step(main, scope, feed, steps=2) is None
    assert not prof.annotating()
    for n, a in before.items():
        np.testing.assert_array_equal(np.array(
            scope.find_var(n).get_tensor()), a, err_msg=n)
