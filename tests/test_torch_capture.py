"""The sampled capture (``observability/capture.py``) through the port
against the JAX package, on the CPU.

- The knob: ``PADDLE_TPU_SAMPLE_EVERY`` parsed as the JAX package parses
  it; disarmed, the hook returns None and counts nothing.
- With the step profiler replaced by a stub (the JAX package's cases of
  ``tests/test_steering_runtime.py``): every Nth call samples, the report
  rolls into ``<role>-<rank>.profile.json`` with its bounded history, a
  failing profile never breaks the step and is counted in
  ``capture.errors``.
- On a real executor: ``Executor.run`` samples every Nth step, the report
  file holds the profile, and the training run is bit for bit the one
  with sampling off.
- ``PADDLE_TPU_DEVICE_TRACE``: set, each sample also runs
  ``device_trace.device_profile_step`` and carries the device phases and
  their agreement with the host's (``cross_check``); on the CPU the trace
  holds no kernel and the report says so; during a ``fluid.profiler``
  session holding the trace it is skipped; unset, the device profile
  never runs.
"""
import json

import numpy as np
import pytest

from paddle_tpu.observability import capture as jcapture
import paddle_tpu_torch as fluid
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.observability import capture, device_trace, flight
from paddle_tpu_torch.observability import profiler as prof

KNOBS = ("PADDLE_TPU_SAMPLE_EVERY", "PADDLE_TPU_METRICS_DIR",
         "PADDLE_TPU_DEVICE_TRACE", "PADDLE_TPU_TIMESERIES")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    obs.reset()
    obs.enable()
    flight.clear()
    capture._reset_for_tests()
    jcapture._reset_for_tests()
    yield
    obs.reset()
    obs.disable()
    flight.clear()
    capture._reset_for_tests()
    jcapture._reset_for_tests()


def stub_profile(monkeypatch, calls=None, report=None):
    def fake(program, scope, feed, **kw):
        if calls is not None:
            calls.append(kw)
        return dict(report or {"step_ms": 5.0, "overlap_frac": 0.5,
                               "phase_ms": {"forward": 2.0,
                                            "backward": 2.5,
                                            "optimizer": 0.5}})

    monkeypatch.setattr(prof, "profile_step", fake)
    monkeypatch.setattr(prof, "_emit_profile", lambda rep: None)


@pytest.mark.parametrize("raw", ["", "0", "-3", "nope", "7", " 4 "])
def test_sample_every_parse_matches_the_jax_package(raw, monkeypatch):
    if raw:
        monkeypatch.setenv("PADDLE_TPU_SAMPLE_EVERY", raw)
    capture._reset_for_tests()
    jcapture._reset_for_tests()
    assert capture.sample_every() == jcapture.sample_every()
    assert capture.sampling_enabled() == jcapture.sampling_enabled()


def test_disabled_hook_returns_none_without_counting():
    assert capture.maybe_sample_step("t", object(), object(), {}) is None
    assert capture._counts == {}


def test_sampling_cadence_and_rolling_report(tmp_path, monkeypatch):
    calls = []
    stub_profile(monkeypatch, calls)
    monkeypatch.setenv("PADDLE_TPU_SAMPLE_EVERY", "3")
    monkeypatch.setenv("PADDLE_TPU_METRICS_DIR", str(tmp_path))
    capture._reset_for_tests()
    reports = [capture.maybe_sample_step("eng", object(), object(), {})
               for _ in range(7)]
    assert [r is not None for r in reports] == \
        [False, False, True, False, False, True, False]
    assert len(calls) == 2 and calls[0]["repeats"] == 1
    assert calls[0]["budget_s"] == capture.SAMPLE_BUDGET_S
    assert obs.counter_value("capture.samples", engine="eng") == 2
    files = list(tmp_path.glob("*.profile.json"))
    assert len(files) == 1
    doc = json.loads(files[0].read_text())
    assert doc["schema"] == capture.SAMPLED_PROFILE_SCHEMA == \
        jcapture.SAMPLED_PROFILE_SCHEMA
    assert doc["samples"] == 2 and len(doc["history"]) == 2
    assert doc["profile"]["step_ms"] == 5.0
    assert "device_trace" not in doc["profile"]


def test_capture_failure_never_breaks_the_step(monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("profiler exploded")

    monkeypatch.setattr(prof, "profile_step", boom)
    monkeypatch.setenv("PADDLE_TPU_SAMPLE_EVERY", "1")
    capture._reset_for_tests()
    assert capture.maybe_sample_step("eng", object(), object(), {}) is None
    assert obs.counter_value("capture.errors", engine="eng") == 1
    assert "capture.error" in [k for _, k, _ in flight.events()]


def test_history_bounded(tmp_path, monkeypatch):
    stub_profile(monkeypatch)
    monkeypatch.setenv("PADDLE_TPU_SAMPLE_EVERY", "1")
    monkeypatch.setenv("PADDLE_TPU_METRICS_DIR", str(tmp_path))
    capture._reset_for_tests()
    for _ in range(capture.HISTORY_CAP + 9):
        capture.maybe_sample_step("eng", object(), object(), {})
    doc = json.loads(next(tmp_path.glob("*.profile.json")).read_text())
    assert len(doc["history"]) == capture.HISTORY_CAP == jcapture.HISTORY_CAP


def mlp():
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 3
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data(name="x", shape=[32, 16], dtype="float32")
        y = fluid.data(name="y", shape=[32, 1], dtype="int64")
        h = fluid.layers.fc(x, 32, act="relu")
        pred = fluid.layers.fc(h, 4, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, y))
        fluid.optimizer.AdamOptimizer(1e-2).minimize(loss)
    rng = np.random.RandomState(7)
    feed = {"x": rng.rand(32, 16).astype("float32"),
            "y": rng.randint(0, 4, (32, 1)).astype("int64")}
    return main, startup, loss, feed


def train(steps=4):
    main, startup, loss, feed = mlp()
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    losses = [np.asarray(exe.run(main, feed=feed, fetch_list=[loss],
                                 scope=scope)[0]) for _ in range(steps)]
    params = {p.name: np.array(scope.find_var(p.name).get_tensor())
              for p in main.all_parameters()}
    exe.close()
    return losses, params


def test_executor_samples_every_nth_step_and_leaves_the_run(tmp_path,
                                                            monkeypatch):
    plain = train()
    monkeypatch.setenv("PADDLE_TPU_SAMPLE_EVERY", "2")
    monkeypatch.setenv("PADDLE_TPU_METRICS_DIR", str(tmp_path))
    capture.rearm()
    sampled = train()
    assert obs.counter_value("capture.samples", engine="executor") == 2
    assert not obs.counter_value("capture.errors", engine="executor")
    hist = capture.history("executor")
    assert [h["step"] for h in hist] == [2, 4]
    doc = json.loads(next(tmp_path.glob("*.profile.json")).read_text())
    assert set(doc["profile"]["phase_ms"]) >= {"forward", "backward",
                                               "optimizer"}
    for a, b in zip(plain[0], sampled[0]):
        assert np.array_equal(a, b)
    for n, p in plain[1].items():
        assert np.array_equal(p, sampled[1][n]), n


def test_device_trace_knob_on_the_cpu_says_the_trace_is_empty(monkeypatch,
                                                              tmp_path):
    monkeypatch.setenv("PADDLE_TPU_SAMPLE_EVERY", "2")
    monkeypatch.setenv("PADDLE_TPU_DEVICE_TRACE", "1")
    monkeypatch.setenv("PADDLE_TPU_METRICS_DIR", str(tmp_path))
    calls = []
    real = device_trace.device_profile_step

    def counted(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(device_trace, "device_profile_step", counted)
    capture.rearm()
    main, startup, loss, feed = mlp()
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    for _ in range(2):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    exe.close()
    assert len(calls) == 1 and calls[0]["steps"] == \
        capture.SAMPLE_TRACE_STEPS
    assert not obs.counter_value("capture.errors", engine="executor")
    (summary,) = capture.history("executor")
    assert "host_device_agreement" not in summary
    doc = json.loads(next(tmp_path.glob("*.profile.json")).read_text())
    assert doc["profile"]["device_trace"] == {"status": "empty",
                                              "fallback": "host"}
    assert not prof.annotating()


def test_device_trace_knob_adds_the_device_phases_and_agreement(
        monkeypatch, tmp_path):
    stub_profile(monkeypatch)
    fold = {"device_phase_ms": {"forward": 1.5, "backward": 2.5,
                                "optimizer": 1.0},
            "overlap_frac": 0.0, "critical_path_ms": 5.0,
            "exposed_collective_ms": 0.0, "n_events": 9, "n_attributed": 8,
            "unattributed_ms": 0.1, "kernel_records": 9, "steps": 1,
            "source": "torch.profiler",
            "launches": {"fused_optimizer_update": 1},
            "own_kernel_records": {"fused_optimizer_update": 1}}
    monkeypatch.setattr(device_trace, "device_profile_step",
                        lambda *a, **kw: dict(fold))
    monkeypatch.setenv("PADDLE_TPU_SAMPLE_EVERY", "1")
    monkeypatch.setenv("PADDLE_TPU_DEVICE_TRACE", "1")
    monkeypatch.setenv("PADDLE_TPU_METRICS_DIR", str(tmp_path))
    capture._reset_for_tests()
    rep = capture.maybe_sample_step("eng", object(), object(), {})
    want = device_trace.cross_check(
        {"forward": 2.0, "backward": 2.5, "optimizer": 0.5},
        fold["device_phase_ms"])
    assert rep["device_phase_ms"] == fold["device_phase_ms"]
    assert rep["host_device_agreement"] == pytest.approx(want["agreement"])
    assert rep["agreement_per_phase"] == want["per_phase"]
    assert rep["device_trace"]["launches"] == fold["launches"]
    (summary,) = capture.history("eng")
    assert summary["host_device_agreement"] == pytest.approx(
        want["agreement"])
    assert summary["device_launches"] == fold["launches"]
    doc = json.loads(next(tmp_path.glob("*.profile.json")).read_text())
    assert doc["profile"]["device_trace"]["n_attributed"] == 8


def test_device_trace_off_or_held_by_a_session_runs_no_device_profile(
        monkeypatch):
    stub_profile(monkeypatch)

    def never(*a, **kw):
        raise AssertionError("device_profile_step ran")

    monkeypatch.setattr(device_trace, "device_profile_step", never)
    monkeypatch.setenv("PADDLE_TPU_SAMPLE_EVERY", "1")
    capture._reset_for_tests()
    rep = capture.maybe_sample_step("eng", object(), object(), {})
    assert "device_trace" not in rep
    monkeypatch.setenv("PADDLE_TPU_DEVICE_TRACE", "1")
    monkeypatch.setattr(prof, "_torch_prof", object())
    rep = capture.maybe_sample_step("eng", object(), object(), {})
    assert rep["device_trace"]["status"] == "skipped"
    assert not obs.counter_value("capture.errors", engine="eng")
