"""The step profiler and ``fluid.profiler`` through the port against the
JAX package, on the CPU.

- The pure half on the same programs built in both packages:
  ``classify_ops`` (a training MLP, and the same after the allreduce and
  bucket passes), ``build_phase_plan`` (phases, cuts, collectives,
  payloads), ``analyze_timeline`` on constructed overlapped, serialized
  and partial timelines, and ``program_flops`` (an MLP forward, its
  training step, a conv block, the narrow gpt's training step): equal
  answers. ``peak_flops`` is the H100's (bf16 989 TFLOP/s, float32
  494.7 / 3 TFLOP/s); the JAX package's TPU peaks are not the port's.
- ``profile_step`` on a small MLP (Momentum and Adam), on one replica and
  over a mesh of 2 CPU replicas: the report's keys and phases, its
  conservation identities, and the state (parameters and optimizer
  accumulators) bitwise as it was; armed, its histograms, gauges and
  phase spans.
- Phase annotation: disarmed, a step function carries no labels; armed,
  each op of the walk runs inside a ``"<phase>/<op_type>"`` range (a
  ``torch.profiler`` trace on the CPU shows them) and the program's ops
  are unchanged.
- ``fluid.profiler``: a session around two steps in each package records
  the same event names (``compiled_step``), prints the table, keeps its
  snapshot for ``get_trace_events``, and ``reset_profiler`` /
  ``RecordEvent`` behave as in the JAX package.
- The executor's counters in the registry: armed, ``/metrics``
  (``dump_prometheus``) carries ``executor.*``, ``fusion.*`` and
  ``lod_lowering.*``, and ``compiler_engine.counters()`` keeps its answers.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.observability import profiler as jprof
from paddle_tpu.parallel.collectives import \
    bucket_allreduce_ops as jbucket
from paddle_tpu.parallel.transpiler import \
    insert_allreduce_ops as jinsert
import paddle_tpu_torch as fluid
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.core import compiler_engine as ce
from paddle_tpu_torch.observability import profiler as prof
from paddle_tpu_torch.observability import tracing
from paddle_tpu_torch.parallel.collectives import bucket_allreduce_ops
from paddle_tpu_torch.parallel.mesh_utils import make_mesh
from paddle_tpu_torch.parallel.transpiler import insert_allreduce_ops


@pytest.fixture(autouse=True)
def _clean_obs():
    obs.reset()
    yield
    obs.reset()
    obs.disable()
    prof.disable_annotation()


def small_program(pkg, batch=64, hidden=64, opt="momentum"):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.data(name="px", shape=[batch, 32], dtype="float32")
        y = pkg.data(name="py", shape=[batch, 1], dtype="int64")
        h = pkg.layers.fc(x, hidden, act="relu")
        pred = pkg.layers.fc(h, 10, act="softmax")
        loss = pkg.layers.mean(pkg.layers.cross_entropy(pred, y))
        if opt == "adam":
            pkg.optimizer.AdamOptimizer(1e-3).minimize(loss)
        else:
            pkg.optimizer.MomentumOptimizer(0.1, 0.9).minimize(loss)
    return main, startup, loss


def small_feed(batch=64):
    rng = np.random.RandomState(0)
    return {"px": rng.rand(batch, 32).astype("float32"),
            "py": rng.randint(0, 10, (batch, 1)).astype("int64")}


# -- the pure half -------------------------------------------------------------

@pytest.mark.parametrize("rewrite", ["none", "allreduce", "bucket"])
def test_classify_ops_and_the_phase_plan_match_the_jax_package(rewrite):
    jmain = small_program(jfluid)[0]
    pmain = small_program(fluid)[0]
    if rewrite != "none":
        jinsert(jmain, 8)
        insert_allreduce_ops(pmain, 8)
    if rewrite == "bucket":
        jbucket(jmain, bucket_bytes=4 << 20)
        bucket_allreduce_ops(pmain, bucket_bytes=4 << 20)
    assert [o.type for o in pmain.global_block().ops] == \
        [o.type for o in jmain.global_block().ops]
    phases = prof.classify_ops(pmain.global_block())
    assert phases == jprof.classify_ops(jmain.global_block())
    order = {"forward": 0, "backward": 1, "optimizer": 2}
    ranks = [order[p] for p in phases if p != "collective"]
    assert ranks == sorted(ranks)
    jp, pp = (jprof.build_phase_plan(jmain),
              prof.build_phase_plan(pmain))
    for k in ("phases", "cuts", "n_compute", "skippable"):
        assert pp[k] == jp[k], k
    keys = ("index", "type", "bucket", "numel", "dtype", "kind", "bytes",
            "avail_pos", "bench_numel")
    assert [{k: c.get(k) for k in keys} for c in pp["collectives"]] == \
        [{k: c.get(k) for k in keys} for c in jp["collectives"]]
    if rewrite != "none":
        assert phases.count("collective") >= 1


TIMELINES = (
    [("forward", 0, 4), ("backward", 4, 6), ("collective", 5, 3, 0)],
    [{"phase": "forward", "ts": 0, "dur": 4},
     {"phase": "backward", "ts": 4, "dur": 6},
     {"phase": "collective", "ts": 10, "dur": 4, "bucket": 0}],
    [("backward", 0, 4), ("collective", 2, 4, "b0"),
     ("collective", 6, 2, "b1")],
)


@pytest.mark.parametrize("spans", TIMELINES)
def test_analyze_timeline_matches_the_jax_package(spans):
    assert prof.analyze_timeline(spans) == jprof.analyze_timeline(spans)


def test_analyze_timeline_overlap_and_errors():
    rep = prof.analyze_timeline(TIMELINES[2])
    assert rep["overlap_frac"] == pytest.approx(2.0 / 6.0)
    assert rep["critical_path_ms"] == pytest.approx(8.0)
    with pytest.raises(ValueError):
        prof.analyze_timeline([("forward", 0, -1)])


def mlp_forward(pkg, b=16):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.data(name="x", shape=[b, 784], dtype="float32")
        h = pkg.layers.fc(x, 256, act="relu")
        pkg.layers.fc(h, 10)
    return main


def mlp_train(pkg, b=16):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.data(name="x", shape=[b, 784], dtype="float32")
        y = pkg.data(name="y", shape=[b, 1], dtype="int64")
        h = pkg.layers.fc(x, 256, act="relu")
        p = pkg.layers.fc(h, 10, act="softmax")
        loss = pkg.layers.mean(pkg.layers.cross_entropy(p, y))
        pkg.optimizer.SGDOptimizer(0.1).minimize(loss)
    return main


def conv_block(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.data(name="x", shape=[2, 3, 16, 16], dtype="float32")
        pkg.layers.conv2d(x, 8, 3, padding=1, bias_attr=False)
    return main


def narrow_gpt(pkg):
    import test_torch_training as GT

    return GT.build_gpt(pkg)[0]


@pytest.mark.parametrize("build", [mlp_forward, mlp_train, conv_block,
                                   narrow_gpt])
def test_program_flops_match_the_jax_package(build):
    got = prof.program_flops(build(fluid))
    assert got == jprof.program_flops(build(jfluid))
    assert got["total"] > 0


def test_flops_hand_computed_and_formulas():
    b = 16
    fwd = 2 * b * 784 * 256 + 2 * b * 256 * 10
    assert prof.program_flops(mlp_forward(fluid))["by_category"][
        "matmul"] == fwd
    assert prof.program_flops(mlp_train(fluid))["by_category"][
        "matmul"] == 3 * fwd
    assert prof.program_flops(conv_block(fluid))["by_category"][
        "conv"] == 2 * (2 * 8 * 16 * 16) * 3 * 3 * 3
    for args in ((1, (10, 20), False), (4, (10, 20, 30), True)):
        assert prof.flops_mlp(*args) == jprof.flops_mlp(*args)
    for train in (False, True):
        assert prof.flops_transformer_lm(1, 128, 64, 2, 1000, train) == \
            jprof.flops_transformer_lm(1, 128, 64, 2, 1000, train)


def test_peak_flops_and_mfu_are_the_h100s():
    assert prof.peak_flops(True) == 989e12
    assert prof.peak_flops(False) == pytest.approx(494.7e12 / 3)
    assert prof.peak_flops(True) != jprof.peak_flops(True)  # a TPU's
    assert prof.mfu_est(prof.peak_flops(False, 1), 1.0) == \
        pytest.approx(1.0)
    assert prof.mfu_est(prof.peak_flops(True, 8), 2.0, bf16=True,
                        n_devices=8) == pytest.approx(0.5)
    assert prof.mfu_est(0, 1.0) is None


# -- profile_step --------------------------------------------------------------

def state_of(main, scope):
    out = {}
    for v in main.list_vars():
        var = scope.find_var(v.name) if v.persistable else None
        if var is not None and var.is_initialized():
            out[v.name] = np.array(var.get_tensor())
    return out


def assert_bitwise(before, after):
    assert set(before) == set(after)
    for n, a in before.items():
        np.testing.assert_array_equal(after[n], a, err_msg=n)


@pytest.mark.parametrize("opt", ["momentum", "adam"])
def test_profile_step_on_one_replica_leaves_the_state(opt):
    main, startup, loss = small_program(fluid, opt=opt)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    feed = small_feed()
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    before = state_of(main, scope)
    assert any("moment" in n or "velocity" in n for n in before)
    rep = prof.profile_step(main, scope, feed)
    assert_bitwise(before, state_of(main, scope))
    assert set(rep["phase_ms"]) == {"forward", "backward", "optimizer"}
    assert [label for label, _ in rep["segments_ms"]] == \
        ["forward", "backward", "optimizer"]
    assert sum(ms for _, ms in rep["segments_ms"]) == \
        pytest.approx(rep["compute_ms"])
    assert rep["collective_ms"] == 0.0 and rep["overlap_frac"] is None
    assert rep["critical_path_ms"] == pytest.approx(
        rep["compute_ms"] + rep["exposed_collective_ms"])
    assert rep["step_ms"] > 0 and not rep["truncated"]
    assert rep["timing"] == "eager walk, host clock"
    for k in ("feed_ms", "optimizer_ms", "serialized_ms", "per_bucket",
              "backward_segments", "n_compute", "nranks", "n_ops"):
        assert k in rep, k
    # the run after the profile is the run it would have been
    out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert np.isfinite(np.asarray(out[0])).all()


def test_profile_step_over_a_mesh_reports_the_overlap():
    main, startup, loss = small_program(fluid)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    mesh = make_mesh([2], ["dp"], [fluid.CPUPlace()] * 2)
    cp = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, places=mesh)
    feed = small_feed()
    exe.run(cp, feed=feed, fetch_list=[loss], scope=scope)
    assert any(op.type.startswith("c_") for op in main.global_block().ops)
    before = state_of(main, scope)
    rep = prof.profile_step(main, scope, feed, mesh=mesh)
    assert_bitwise(before, state_of(main, scope))
    assert rep["collective_ms"] > 0 and rep["nranks"] == 2
    assert rep["overlap_frac"] is not None
    assert 0.0 <= rep["overlap_frac"] <= 1.0
    assert rep["per_bucket"] and all(
        0.0 <= b["max_hideable_frac"] <= 1.0 for b in rep["per_bucket"])
    assert rep["critical_path_ms"] == pytest.approx(
        rep["compute_ms"] + rep["exposed_collective_ms"])
    assert rep["serialized_ms"] == pytest.approx(
        rep["compute_ms"] + rep["collective_ms"])


def test_profile_step_emits_metrics_and_phase_spans():
    obs.enable()
    main, startup, loss = small_program(fluid)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    feed = small_feed()
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    prof.profile_step(main, scope, feed)
    snap = obs.metrics().snapshot()
    assert any(k.startswith("profile.phase_ms") for k in snap["histograms"])
    assert "profile.critical_path_ms" in snap["gauges"]
    assert "phase" in {ev[4] for ev in tracing.trace_events()}


# -- phase annotation ----------------------------------------------------------

def test_annotation_off_is_inert_and_on_labels_the_walk():
    main, startup, loss = small_program(fluid, batch=8)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    feed = small_feed(8)
    types = [op.type for op in main.global_block().ops]
    assert not prof.annotating()
    assert prof.trace_annotation(main.global_block(),
                                 main.global_block().ops) is None
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    step = list(exe._core.steps.values())[-1]
    assert step.block.labels is None
    prof.enable_annotation()
    exe2 = fluid.Executor(fluid.CPUPlace())   # builds labelled steps
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        exe2.run(main, feed=feed, fetch_list=[loss], scope=scope)
    step = list(exe2._core.steps.values())[-1]
    assert step.block.labels == ["%s/%s" % (ph, t) for ph, t in zip(
        prof.classify_ops(main.global_block()), types)]
    names = {e.key for e in p.key_averages()}
    assert {"forward/mul", "backward/mul_grad"} <= names
    assert [op.type for op in main.global_block().ops] == types


# -- fluid.profiler --------------------------------------------------------------

def run_session(pkg, capsys):
    main, startup, loss = small_program(pkg, batch=8)
    exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
    feed = small_feed(8)
    with pkg.scope_guard(scope):
        exe.run(startup)
        with pkg.profiler.profiler("All", "total"):
            with pkg.profiler.RecordEvent("user_region"):
                for _ in range(2):
                    exe.run(main, feed=feed, fetch_list=[loss])
    return capsys.readouterr().out, pkg.profiler.get_trace_events()


def test_fluid_profiler_session_matches_the_jax_package(capsys):
    jout, jev = run_session(jfluid, capsys)
    out, ev = run_session(fluid, capsys)
    assert sorted(n for n, _, _ in ev) == sorted(n for n, _, _ in jev)
    assert [n for n, _, _ in ev].count("compiled_step") == 2
    assert "user_region" in {n for n, _, _ in ev}
    assert all(dur >= 0 for _, _, dur in ev)
    assert "Event" in out and "Calls" in out and "Device(ms)" in out
    assert "compiled_step" in out
    assert not fluid.profiler.is_profiler_enabled()
    # the snapshot joins the chrome trace; a reset empties it
    assert any(e["name"] == "compiled_step"
               for e in obs.chrome_trace()["traceEvents"])
    obs.reset()
    assert fluid.profiler.get_trace_events() == []


def test_reset_profiler_drops_the_live_sessions_spans():
    fluid.profiler.start_profiler("CPU")
    with fluid.profiler.RecordEvent("a"):
        pass
    assert [n for n, _, _ in fluid.profiler.get_trace_events()] == ["a"]
    fluid.profiler.reset_profiler()
    assert fluid.profiler.get_trace_events() == []
    with fluid.profiler.record_event("b"):
        pass
    fluid.profiler.stop_profiler()
    assert [n for n, _, _ in fluid.profiler.get_trace_events()] == ["b"]


# -- the executor's counters in the registry -------------------------------------

def test_metrics_carry_the_executor_fusion_and_lowering_families(
        monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FUSED_OPTIMIZER", "1")
    monkeypatch.setenv("PADDLE_TPU_FUSED_EPILOGUE", "1")
    obs.enable()
    ce.reset_counters()
    main, startup, loss = small_program(fluid, batch=8, opt="adam")
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    for _ in range(2):
        exe.run(main, feed=small_feed(8), fetch_list=[loss], scope=scope)
    ce.count_decline("lookup_table: a test decline")
    text = obs.dump_prometheus()
    for family in ("executor_compiles", "executor_steps",
                   "executor_step_ms", "executor_feed_ms",
                   "fusion_optimizer_groups", "lod_lowering_declines"):
        assert family in text.replace(".", "_"), family
    c = ce.counters()
    assert c["executor.steps"] >= 2 and c["fusion.optimizer_groups"] == 1
    assert obs.counter_value("executor.steps", path="compiled") >= 2
    assert ce.declines()["lookup_table: a test decline"] == 1
    assert any(ev[0] == "compiled_step" for ev in tracing.trace_events())
