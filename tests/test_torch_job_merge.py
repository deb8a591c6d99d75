"""The job-level merge of per-process dumps, the clock handshake, the flight
ring's crash hook and the launcher's steering and merge, the port against
the JAX package.

Twins of ``tests/test_distributed_obs.py``'s merge cases (its PS rpc cases
wait with the parameter server) and of ``tests/test_steering_runtime.py``'s
sampled-profile merge cases:

- the port's ``merge_job_dir`` of a directory and the JAX package's of the
  same directory write the same ``metrics.json`` (but its merge stamp) and
  the same ``trace.json``: the JAX merge reads the port's dumps and gives
  the same ``counters_total``;
- a host whose clock is off by more than the handshake's uncertainty is
  rebased onto the launcher's clock, one within it is left alone;
- ``install_excepthook`` prints the ring's tail to stderr in a child
  process that raises, and dumps it where a metrics directory is set;
- two gloo ranks launched with a metrics directory, ``--steering``, the
  tree spelling and the async split: their losses are the one process's
  full batch's within 1e-5, their parameters bitwise equal, and at
  teardown every process's spans and flight events (the launcher's, both
  ranks', the daemon's) land in one ``trace.json`` on one clock, which the
  JAX merge and ``tools/torch_ft_timeline.py`` read.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu  # noqa: F401
from paddle_tpu import observability as jobs
from paddle_tpu.observability import distributed as jdist
from paddle_tpu.observability import flight as jflight

import paddle_tpu_torch  # noqa: F401
from paddle_tpu_torch import observability as pobs
from paddle_tpu_torch.observability import capture as pcapture
from paddle_tpu_torch.observability import distributed as pdist
from paddle_tpu_torch.observability import flight as pflight

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "dist_worker_dp_torch.py")
TIMEOUT_S = 180


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("PADDLE_TPU_METRICS_DIR", "PADDLE_ROLE", "PADDLE_TRAINER_ID",
              "PADDLE_RESTART_COUNT", "PADDLE_INCARNATION",
              pdist.CLOCK_PING_ENV):
        monkeypatch.delenv(k, raising=False)
    for o, f in ((jobs, jflight), (pobs, pflight)):
        o.reset()
        o.enable()
        f.clear()
    yield
    for o, f in ((jobs, jflight), (pobs, pflight)):
        o.reset()
        o.disable()
        f.clear()
    pdist._identity = None


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _merged(dist, d):
    """Both merged documents of ``d`` by ``dist``, less the merge stamp."""
    mpath, tpath = dist.merge_job_dir(d)
    if mpath is None:
        return None
    merged = json.load(open(mpath))
    merged.pop("merged_at")
    return merged, json.load(open(tpath))


def test_the_api_is_the_jax_package_s():
    for name in ("set_identity", "job_incarnation", "fleet_round_args",
                 "write_clock_ping", "record_clock_offset",
                 "load_clock_offsets", "applied_clock_skew_us",
                 "doc_flight_events", "sampled_profile_drift",
                 "merge_job_dir", "MERGED_METRICS_NAME",
                 "MERGED_TRACE_NAME", "CLOCK_PING_ENV"):
        assert name in pdist.__all__, name
        if name.isupper():
            assert getattr(pdist, name) == getattr(jdist, name)
    for name in ("tail_lines", "install_excepthook"):
        assert name in pflight.__all__


# -- the flight ring -----------------------------------------------------------------


def test_flight_ring_records_bounds_and_tails():
    lines = []
    for f in (jflight, pflight):
        f.record("canary.promoted", steerer="lazy_policy", pairs=3)
        evs = f.events()
        assert evs[-1][1] == "canary.promoted"
        assert evs[-1][2] == {"steerer": "lazy_policy", "pairs": 3}
        for i in range(f._RING_CAP + 100):
            f.record("x", i=i)
        st = f.stats()
        assert st["buffered"] == f._RING_CAP and st["dropped"] >= 100
        f.record("rpc.send", kind="send_grad")
        assert f.events()[-1][2] == {"kind": "send_grad"}
        tail = f.tail_lines(5)
        assert len(tail) == 5
        lines.append([ln.split("] ", 1)[1] for ln in tail])
    assert lines[1] == lines[0]
    assert pflight._RING_CAP == jflight._RING_CAP


_CRASH = r"""
import os, sys
from paddle_tpu_torch.observability import distributed, flight
flight.install_excepthook()
flight.install_excepthook()  # once a process
flight.record("steering.proposed", steerer="lazy_policy", poll=3)
flight.record("canary.rolled_back", plan_digest="abc")
raise RuntimeError("worker died")
"""


def test_the_crash_hook_prints_the_ring_s_tail_in_a_child(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, PADDLE_TPU_METRICS_DIR=str(
        tmp_path), PADDLE_ROLE="trainer", PADDLE_TRAINER_ID="3",
        PADDLE_TPU_FLIGHT_RING="64")
    res = subprocess.run([sys.executable, "-c", _CRASH], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    err = res.stderr
    assert err.count("-- flight recorder (last") == 1
    assert "steering.proposed poll=3 steerer=lazy_policy" in err
    assert "canary.rolled_back plan_digest=abc" in err
    assert err.index("flight recorder") < err.index("RuntimeError")
    doc = json.load(open(tmp_path / "trainer-3.json"))
    assert doc["flight_stats"]["capacity"] == 64
    assert [ev[1] for ev in doc["flight"]][-2:] == [
        "steering.proposed", "canary.rolled_back"]


# -- dumps and the merge ---------------------------------------------------------------


def _write_dump(d, role, rank, monkeypatch, restart=0):
    monkeypatch.setenv("PADDLE_ROLE", role)
    monkeypatch.setenv("PADDLE_TRAINER_ID", str(rank))
    monkeypatch.setenv("PADDLE_RESTART_COUNT", str(restart))
    pdist._identity = None
    name = "%s-%d%s.json" % (role, rank, ".r%d" % restart if restart else "")
    return pdist.dump_process(os.path.join(d, name))


def test_the_jax_merge_reads_the_port_s_dumps(tmp_path, monkeypatch):
    d = str(tmp_path)
    pobs.counter("parallel.collective_ops", kind="allreduce").inc(3)
    with pdist.trace("round"):
        pass
    pflight.record("launch.spawn", role="trainer", rank=0)
    p1 = _write_dump(d, "trainer", 0, monkeypatch)
    pobs.counter("parallel.collective_ops", kind="allreduce").inc(2)
    pflight.record("canary.promoted", plan_digest="d")
    _write_dump(d, "trainer", 1, monkeypatch)
    _write_dump(d, "trainer", 1, monkeypatch, restart=1)
    doc = json.load(open(p1))
    assert doc["schema"] == 1 and doc["role"] == "trainer"
    assert doc["spans"] and doc["flight"] and doc["incarnation"] == 0
    port = _merged(pdist, d)
    jax = _merged(jdist, d)
    assert port == jax
    merged, trace = port
    assert set(merged["processes"]) == {"trainer-0", "trainer-1",
                                        "trainer-1.r1"}
    assert merged["counters_total"][
        "parallel.collective_ops{kind=allreduce}"] == 13
    names = [e["name"] for e in trace["traceEvents"]]
    assert {"process_name", "round", "launch.spawn",
            "canary.promoted"} <= set(names)
    ts = [e["ts"] for e in trace["traceEvents"] if e["ph"] != "M"]
    assert ts == sorted(ts)


def test_clear_stale_dumps(tmp_path, monkeypatch):
    d = str(tmp_path)
    _write_dump(d, "trainer", 0, monkeypatch)
    pdist.merge_job_dir(d)
    (tmp_path / "trainer-0.clockping").write_text("{}")
    pdist.record_clock_offset(d, "trainer-0", 1.0, 0.0, 2.0)
    (tmp_path / "not_a_dump.txt").write_text("keep me")
    (tmp_path / "job.json").write_text("{}")
    assert pdist.clear_stale_dumps(d) >= 5
    assert sorted(os.listdir(d)) == ["job.json", "not_a_dump.txt"]
    assert pdist.merge_job_dir(d) == (None, None)
    assert pdist.clear_stale_dumps(str(tmp_path / "missing")) == 0


def test_a_later_incarnation_merges_alone(tmp_path, monkeypatch):
    d = str(tmp_path)
    _write_dump(d, "trainer", 0, monkeypatch)
    monkeypatch.setenv("PADDLE_INCARNATION", "1")
    assert pdist.job_incarnation() == 1
    assert pdist._dump_basename() == "trainer-0.i1.json"
    pdist.dump_process()  # no directory: nothing
    pdist.dump_process(os.path.join(d, pdist._dump_basename()))
    for dist in (pdist, jdist):
        merged, _ = _merged(dist, d)
        assert set(merged["processes"]) == {"trainer-0.i1"}
        assert merged["incarnation"] == 1


def test_set_identity_names_the_dump(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_METRICS_DIR", str(tmp_path))
    pdist.set_identity("launcher", 2)
    assert pdist.process_identity()[:2] == ("launcher", 2)
    assert pdist.dump_path() == os.path.join(str(tmp_path),
                                             "launcher-2.json")
    monkeypatch.setenv(pdist.JOB_TRACE_ENV, "feedc0de")
    assert pdist.fleet_round_args(4) == {"trace_id": "feedc0de",
                                         "parent_span": "dpround-4"}
    pobs.disable()
    assert pdist.fleet_round_args(4) == {}


def _synthetic_dump(d, proc, spans, clock_offset_us=0.0, flight_evs=()):
    doc = {"schema": 1, "proc": proc, "role": proc.split("-")[0],
           "rank": 0, "restart": 0, "pid": sum(map(ord, proc)),
           "wrote_at": 0.0, "clock_offset_us": clock_offset_us,
           "metrics": {"counters": {"c": 1}},
           "spans": [list(s) for s in spans],
           "flight": [list(f) for f in flight_evs]}
    with open(os.path.join(d, proc + ".json"), "w") as f:
        json.dump(doc, f)


def test_the_clock_handshake_round_trips(tmp_path, monkeypatch):
    ping = str(tmp_path / "trainer-0.clockping")
    monkeypatch.setenv(pdist.CLOCK_PING_ENV, ping)
    assert pdist.write_clock_ping() == ping
    doc = json.load(open(ping))
    assert doc["wall_us"] > 0 and doc["pid"] == os.getpid()
    monkeypatch.delenv(pdist.CLOCK_PING_ENV)
    assert pdist.write_clock_ping() is None
    for i, dist in enumerate((pdist, jdist)):
        d = tmp_path / str(i)
        d.mkdir()
        skew, unc = dist.record_clock_offset(
            str(d), "trainer-0", child_wall_us=15_000_000.0,
            t0_us=10_000_000.0, t1_us=10_002_000.0)
        assert skew == pytest.approx(5_000_000.0 - 1_000.0)
        assert unc == pytest.approx(1_000.0)
        assert dist.applied_clock_skew_us(400.0, 1_000.0) == 0.0
    # each package reads the other's records
    assert pdist.load_clock_offsets(str(tmp_path / "1")) == \
        jdist.load_clock_offsets(str(tmp_path / "0"))


def test_a_skewed_host_is_rebased_onto_the_launcher_s_clock(tmp_path):
    """trainer-1's wall clock runs 5 s ahead; both record one instant. The
    merge lines them up within the handshake's uncertainty, and the JAX
    merge of the same directory writes the same documents."""
    d = str(tmp_path)
    step = [["step", 1_000_000.0, 10.0, 0, "step", None]]
    _synthetic_dump(d, "trainer-0", step,
                    flight_evs=[[1_000_000.0, "launch.spawn", {}]])
    _synthetic_dump(d, "trainer-1", step, clock_offset_us=5_000_000.0,
                    flight_evs=[[1_000_000.0, "launch.spawn", {}]])
    pdist.record_clock_offset(d, "trainer-1", child_wall_us=5_000_000.0,
                              t0_us=0.0, t1_us=2_000.0)
    port = _merged(pdist, d)
    assert port == _merged(jdist, d)
    merged, trace = port
    pids = {e["args"]["name"]: e["pid"] for e in trace["traceEvents"]
            if e.get("ph") == "M"}
    steps = {e["pid"]: e["ts"] for e in trace["traceEvents"]
             if e.get("ph") == "X"}
    assert abs(steps[pids["trainer-1"]] - steps[pids["trainer-0"]]) <= 2000
    flights = {e["pid"]: e["ts"] for e in trace["traceEvents"]
               if e.get("cat") == "flight"}
    assert abs(flights[pids["trainer-1"]]
               - flights[pids["trainer-0"]]) <= 2000
    assert abs(merged["processes"]["trainer-1"]["clock_skew_us"][
        "applied"]) > 4_000_000.0
    assert merged["processes"]["trainer-0"]["clock_skew_us"] is None


def test_a_skew_within_its_uncertainty_is_left_alone(tmp_path):
    d = str(tmp_path)
    _synthetic_dump(d, "trainer-0", [["step", 1_000_000.0, 10.0, 0, "step",
                                      None]])
    pdist.record_clock_offset(d, "trainer-0", child_wall_us=300.0,
                              t0_us=-1_000.0, t1_us=1_000.0)
    _, trace = _merged(pdist, d)
    (ev,) = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    assert ev["ts"] == pytest.approx(1_000_000.0)


def test_the_launcher_s_worker_runs_the_handshake(tmp_path):
    from paddle_tpu_torch.distributed.launch import _Worker

    w = _Worker(2, ["true"], {}, None, role="trainer",
                metrics_dir=str(tmp_path), global_rank=10)
    w.restarts = 1
    w.spawned_at_us = 1_000_000.0
    w.clock_proc = w._proc_base()
    assert w.clock_proc == "trainer-10.r1"
    w.clock_ping_path = os.path.join(str(tmp_path),
                                     w.clock_proc + ".clockping")
    w.poll_clock_ping()
    assert w.last_absent_poll_us > w.spawned_at_us
    with open(w.clock_ping_path, "w") as f:
        json.dump({"wall_us": 9_000_000.0, "pid": 1}, f)
    w.poll_clock_ping()
    offs = pdist.load_clock_offsets(str(tmp_path))
    assert offs["trainer-10.r1"][1] < 1_000_000.0
    assert not os.path.exists(os.path.join(str(tmp_path),
                                           "trainer-10.r1.clockping"))
    w.poll_clock_ping()


def _write_profile(d, proc, step_ms):
    doc = {"schema": pcapture.SAMPLED_PROFILE_SCHEMA, "proc": proc,
           "wrote_at": 1.0,
           "profile": {"step_ms": step_ms, "overlap_frac": 0.5,
                       "phase_ms": {"forward": step_ms / 2}}}
    (d / ("%s.profile.json" % proc)).write_text(json.dumps(doc))


def test_sampled_profiles_and_their_drift_merge(tmp_path, monkeypatch):
    _write_profile(tmp_path, "trainer-0", 10.0)
    _write_profile(tmp_path, "trainer-1", 12.0)
    (tmp_path / "trainer-2.profile.json").write_text("{torn")
    for dist in (pdist, jdist):
        sampled = dist.load_sampled_profiles(str(tmp_path))
        assert set(sampled) == {"trainer-0", "trainer-1"}
        drift = dist.sampled_profile_drift(sampled)
        assert drift["step_ms"]["spread"] == pytest.approx(2.0)
        assert drift["phase_ms.forward"]["max"] == 6.0
    assert pdist.sampled_profile_drift(pdist.load_sampled_profiles(
        str(tmp_path))) == jdist.sampled_profile_drift(
        jdist.load_sampled_profiles(str(tmp_path)))
    _write_dump(str(tmp_path), "trainer", 0, monkeypatch)
    port = _merged(pdist, str(tmp_path))
    assert port == _merged(jdist, str(tmp_path))
    merged = port[0]
    assert merged["processes"]["trainer-0"]["sampled_profile"][
        "profile"]["step_ms"] == 10.0
    assert "step_ms" in merged["sampled_profile_drift"]


def test_the_timeline_tool_reads_ordered_events(tmp_path, monkeypatch):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import torch_ft_timeline
    finally:
        sys.path.pop(0)
    d = str(tmp_path)
    pflight.record("steering.proposed", steerer="serving_ladder")
    _write_dump(d, "steering", 0, monkeypatch)
    pflight.record("canary.promoted", plan_digest="abc")
    _write_dump(d, "trainer", 0, monkeypatch)
    events = torch_ft_timeline.load_events(d)
    assert [e["t_us"] for e in events] == sorted(e["t_us"] for e in events)
    lines = torch_ft_timeline.format_events(events)
    assert any("canary.promoted" in ln for ln in lines)
    from paddle_tpu_torch.observability import canary

    canary.run_ab_canary({"plan": [8], "steerer": "t_ab"},
                         lambda plan: {"extras": {"s": {"rows_per_s": 1.0 if
                                                       plan is None else 2.0}}},
                         pairs=1, audit=canary.AuditTrail(d))
    import io

    out = io.StringIO()
    assert torch_ft_timeline.print_postmortem(d, out=out) == len(lines)
    text = out.getvalue()
    assert "span sources:" in text and "A/B canary windows" in text
    assert "pair0 B candidate" in text


# -- the launcher: two gloo ranks, the daemon, the merge at teardown -----------------


def _clean_env():
    env = dict(os.environ)
    for k in list(env):
        if k.startswith(("PADDLE_", "FLAGS_selected", "MASTER_")):
            env.pop(k, None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_two_ranks_with_steering_merge_into_one_trace(tmp_path):
    env = _clean_env()
    single_dir = tmp_path / "single"
    single_dir.mkdir()
    single = subprocess.run([sys.executable, WORKER, str(single_dir)],
                            env=env, capture_output=True, text=True,
                            timeout=TIMEOUT_S)
    assert single.returncode == 0, single.stderr[-2000:]
    oracle = json.loads((single_dir / "rank0.json").read_text())
    metrics = tmp_path / "metrics"
    (metrics / "stale.json").parent.mkdir()
    (metrics / "stale.json").write_text(json.dumps({"schema": 1,
                                                    "proc": "stale-9"}))
    out = tmp_path / "mp"
    out.mkdir()
    env.update({"PADDLE_TPU_METRICS_DIR": str(metrics),
                "PADDLE_TPU_DUMP_PERIOD": "0.2",
                "PADDLE_TPU_ASYNC_COLLECTIVES": "1",
                "PADDLE_TPU_REDUCE_STRATEGY": "tree",
                "PADDLE_TPU_BUCKET_MB": "0.00001"})
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node=2", "--started_port=%d" % _free_port(),
         "--steering", "--steering_interval", "0.2",
         "--log_dir", str(tmp_path / "logs"), WORKER, str(out)],
        env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, (proc.stdout[-1000:], proc.stderr[-3000:])
    assert "merged job telemetry" in proc.stderr
    ranks = [json.loads((out / ("rank%d.json" % r)).read_text())
             for r in (0, 1)]
    for r in ranks:
        assert r["backend"] == "gloo"
        c_ops = r["static_c_ops"]
        assert c_ops.count("c_bucket_allreduce_start") >= 1
        assert c_ops.count("c_bucket_allreduce_await") == \
            c_ops.count("c_bucket_allreduce_start")
        np.testing.assert_allclose(r["static_losses"],
                                   oracle["static_losses"], rtol=1e-5,
                                   atol=0)
    params = [np.load(out / ("rank%d.npz" % r)) for r in (0, 1)]
    for k in params[0].files:
        assert np.array_equal(params[0][k], params[1][k]), k

    merged = json.load(open(metrics / "metrics.json"))
    procs = set(merged["processes"])
    assert {"launcher-0", "trainer-0", "trainer-1", "steering-0"} <= procs
    assert "stale-9" not in procs
    # each child's clock was taken at spawn
    for p in ("trainer-0", "trainer-1"):
        assert merged["processes"][p]["clock_skew_us"] is not None
    trace = json.load(open(metrics / "trace.json"))
    pids = {e["args"]["name"]: e["pid"] for e in trace["traceEvents"]
            if e.get("ph") == "M"}
    by_pid = {}
    for e in trace["traceEvents"]:
        if e.get("ph") != "M":
            by_pid.setdefault(e["pid"], []).append(e)
    flight_kinds = {e["name"] for e in by_pid[pids["launcher-0"]]}
    assert {"launch.spawn", "launch.clock_sync", "launch.done"} <= \
        flight_kinds
    for p in ("trainer-0", "trainer-1"):
        assert any(e["ph"] == "X" for e in by_pid[pids[p]]), p
        sched = [e for e in by_pid[pids[p]] if e["name"] ==
                 "parallel.schedule"]
        assert sched and sched[0]["args"]["strategy"] == "tree"
        assert sched[0]["args"]["async_split"] >= 1
    ts = [e["ts"] for e in trace["traceEvents"] if e["ph"] != "M"]
    assert ts == sorted(ts)
    # one clock: every event within the launcher's first and last
    launcher = [e["ts"] for e in by_pid[pids["launcher-0"]]]
    assert min(ts) >= min(launcher) - 60e6 and max(ts) <= max(launcher)
    # the JAX package's merge reads the port's dumps alike
    before = merged["counters_total"]
    jmerged = _merged(jdist, str(metrics))[0]
    assert jmerged["counters_total"] == before
    assert before.get("executor.steps{path=parallel}", 0) >= 2 * 3
    assert before.get("parallel.async_buckets{state=split}", 0) >= 2
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "torch_ft_timeline.py"),
         str(metrics)], env=_clean_env(), capture_output=True, text=True,
        timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "launch.done" in res.stdout and "trainer-1" in res.stdout
