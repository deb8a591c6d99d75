"""Windowed time series, the span spool and the per-process dumper through
the port against the JAX package.

The cases of ``tests/test_timeseries.py`` and the spool cases of
``tests/test_profiler.py`` run through both packages' modules on the same
inputs and must give the same answers: the arming knobs, the bounded
ring, counter resets clamped at zero, rates over a trailing window,
histograms as sum / count pairs, job windows rebased by clock skew; the
spool's size-bounded segments, the exact head, the seeded weighted (and
uniform) reservoir keeping the same spans, rare long spans surviving, a
torn tail line skipped. The port's dumper writes the file
``dump_path()`` names (the path ``/healthz`` reports), with the registry,
the spans, the flight ring and the series, and ``load_dumps`` reads it
back; ``clear_stale_dumps`` removes dumps and segments.
"""
import json
import os

import pytest

from paddle_tpu.observability import spool as jspool
from paddle_tpu.observability import timeseries as jts
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.observability import distributed as dist
from paddle_tpu_torch.observability import spool as spool_mod
from paddle_tpu_torch.observability import timeseries as ts
from paddle_tpu_torch.observability import tracing

BOTH = (ts, jts)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("PADDLE_TPU_METRICS_DIR", "PADDLE_TPU_TIMESERIES",
              "PADDLE_TPU_TIMESERIES_WINDOWS", "PADDLE_TPU_SPOOL_POLICY"):
        monkeypatch.delenv(k, raising=False)
    obs.reset()
    obs.enable()
    for m in BOTH:
        m._reset_for_tests()
    yield
    obs.reset()
    obs.disable()
    tracing._set_spool(None)
    for m in BOTH:
        m._reset_for_tests()


def reset_both():
    for m in BOTH:
        m._reset_for_tests()


# -- knobs and the ring --------------------------------------------------------

def test_disabled_without_metrics_dir():
    for m in BOTH:
        assert not m.series_enabled()
        m.record_point("a.b", 1.0)
        assert m.record_samples({"counters": {"x": 1}}) == 0
        assert m.process_series() == {}


def test_armed_by_metrics_dir_and_forced_off(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_METRICS_DIR", str(tmp_path))
    reset_both()
    for m in BOTH:
        assert m.series_enabled()
        m.record_point("a.b", 1.0, wall_ts=10.0)
        m.record_point("a.b", "nope")
        m.record_point("a.b", True)
    assert ts.process_series() == jts.process_series() == {
        "a.b": {"kind": "gauge", "points": [[10.0, 1.0]]}}
    monkeypatch.setenv("PADDLE_TPU_TIMESERIES", "0")
    reset_both()
    for m in BOTH:
        assert not m.series_enabled()


@pytest.mark.parametrize("raw", [None, "bogus", "1", "7"])
def test_window_cap_parsing(raw, monkeypatch):
    if raw is not None:
        monkeypatch.setenv("PADDLE_TPU_TIMESERIES_WINDOWS", raw)
    reset_both()
    assert ts.window_cap() == jts.window_cap()


def test_ring_evicts_oldest_at_the_bound(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_METRICS_DIR", str(tmp_path))
    monkeypatch.setenv("PADDLE_TPU_TIMESERIES_WINDOWS", "4")
    reset_both()
    for m in BOTH:
        for i in range(10):
            m.record_point("c", float(i), wall_ts=float(i), kind="counter")
    assert ts.process_series() == jts.process_series()
    assert ts.process_series()["c"]["points"][0] == [6.0, 6.0]


# -- window queries ------------------------------------------------------------

POINTS = ([[1.0, 100.0], [2.0, 150.0], [3.0, 10.0], [4.0, 30.0]],
          [[1.0, 100.0], [2.0, 40.0]], [[1.0, 100.0]], [],
          [[0.0, 0.0], [10.0, 100.0], [20.0, 400.0]],
          [[2.0, 5.0], [1.0, 3.0]])


@pytest.mark.parametrize("pts", POINTS)
def test_counter_deltas_rates_and_windows(pts):
    for window in (None, 0.0, 10.0):
        assert ts.counter_delta(pts, window_s=window) == \
            jts.counter_delta(pts, window_s=window)
        assert ts.counter_rate(pts, window_s=window) == \
            jts.counter_rate(pts, window_s=window)
    assert ts.window_span(pts) == jts.window_span(pts)
    assert ts.last_value(pts) == jts.last_value(pts)


def test_counter_reset_clamps_at_zero():
    assert ts.counter_delta(POINTS[0]) == pytest.approx(70.0)
    assert ts.counter_delta(POINTS[1]) == 0.0
    assert ts.counter_rate(POINTS[4], window_s=10.0) == pytest.approx(30.0)


def test_record_samples_ships_histograms_as_counter_pairs(
        tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_METRICS_DIR", str(tmp_path))
    reset_both()
    snaps = [{"counters": {"c{x=1}": 5.0}, "gauges": {"g": 2.5},
              "histograms": {"h{s=0}": {"count": 4, "sum": 40.0}}},
             {"counters": {"c{x=1}": 9.0}, "gauges": {"g": 3.5},
              "histograms": {"h{s=0}": {"count": 6, "sum": 100.0}}}]
    for m in BOTH:
        assert [m.record_samples(s, wall_ts=float(i + 1))
                for i, s in enumerate(snaps)] == [3, 3]
    assert ts.process_series() == jts.process_series()
    ser = ts.process_series()
    assert ts.counter_delta(ser["h{s=0}#sum"]["points"]) == 60.0


def _series(points, kind="counter"):
    return {"m": {"kind": kind, "points": points}}


JOBS = (({"a": _series([[100.0, 0.0], [110.0, 50.0]]),
          "b": _series([[105.0, 0.0], [115.0, 100.0]])},
         {"b": 5_000_000.0}),
        ({"a": _series([[100.0, 0.0], [110.0, 50.0]]),
          "b": _series([[105.0, 0.0], [115.0, 100.0]])}, None),
        ({"a": _series([[0.0, 0.0], [10.0, 40.0]]),
          "b": _series([[3.0, 7.0]])}, None),
        ({"b": _series([[3.0, 7.0]])}, None), ({}, None),
        ({"a": _series([[0.0, 1.0], [5.0, 2.0]], kind="gauge"),
          "b": _series([[1.0, 9.0]], kind="gauge")}, None))


@pytest.mark.parametrize("per,skews", JOBS)
def test_job_windows(per, skews):
    assert ts.job_windows(per, skews_us=skews) == \
        jts.job_windows(per, skews_us=skews)


def test_job_windows_rebase_a_skewed_rank():
    win = ts.job_windows(*JOBS[0])["m"]
    assert win["delta"] == pytest.approx(150.0)
    assert win["t1"] == pytest.approx(110.0)
    assert ts.job_windows(JOBS[1][0])["m"]["t1"] == pytest.approx(115.0)


# -- the span spool ------------------------------------------------------------

def spool_both(tmp_path, base, spans, **kw):
    """The same spans through both spools (same knobs): each one's
    spooled spans, read back."""
    out = []
    for i, (cls, mod) in enumerate(((spool_mod.SpanSpool, spool_mod),
                                    (jspool.SpanSpool, jspool))):
        d = tmp_path / ("port" if i == 0 else "jax")
        d.mkdir(exist_ok=True)
        sp = cls(str(d), base, **kw)
        for ev in spans:
            sp.offer(ev)
        sp.flush()
        out.append((sp, mod.load_spooled_spans(str(d), base)))
    return out


def test_spool_rotates_segments_at_size_bound(tmp_path):
    spans = [("span%04d" % i, float(i), 1.0, 7, "op", None)
             for i in range(400)]
    (p, pev), (j, jev) = spool_both(tmp_path, "p-0", spans, head=10000,
                                    reservoir=0, segment_bytes=2048,
                                    flush_every=16)
    assert pev == jev
    assert [e[0] for e in pev] == ["span%04d" % i for i in range(400)]
    assert len(spool_mod.spool_files(str(tmp_path / "port"), "p-0")) > 1


def test_spool_head_exact_and_reservoir_as_the_jax_spool(tmp_path):
    """A 50k-span run: the head verbatim, the reservoir the same spans
    as the JAX spool keeps with the same seed."""
    spans = [("s", float(i), 1.0, 0, "op", {"i": i}) for i in range(50_000)]
    (p, pev), (j, jev) = spool_both(tmp_path, "t-0", spans, head=5000,
                                    reservoir=2000, segment_bytes=1 << 20,
                                    seed=0, flush_every=1024)
    assert pev == jev
    idxs = [e[5]["i"] for e in pev]
    assert idxs[:5000] == list(range(5000))
    tail = idxs[5000:]
    assert len(set(tail)) == 2000 and min(tail) >= 5000
    assert p.stats()["reservoir_kept"] == 2000


@pytest.mark.parametrize("policy", ["weighted", "uniform"])
def test_spool_seeded_reservoirs_keep_the_jax_spans(tmp_path, policy):
    spans = [("s%d" % i, float(i), float(1 + i % 37), 0,
              ("op", "rpc", "step")[i % 3], {"i": i}) for i in range(5000)]
    (p, pev), (j, jev) = spool_both(tmp_path, "w-0", spans, head=10,
                                    reservoir=20, segment_bytes=1 << 20,
                                    seed=42, policy=policy)
    assert p.policy == policy
    assert pev == jev


def test_spool_weighted_rare_long_spans_survive(tmp_path):
    head, res, n = 100, 64, 60_000
    rare = set(range(head + 500, n, 3_000))
    spans = [("stall%d" % i, float(i), 50_000.0, 0, "stall", {"i": i})
             if i in rare else ("s", float(i), 5.0, 0, "op", {"i": i})
             for i in range(n)]
    (p, pev), (j, jev) = spool_both(tmp_path, "w-0", spans, head=head,
                                    reservoir=res, segment_bytes=1 << 20,
                                    seed=3, flush_every=512)
    assert pev == jev and len(pev) == head + res
    assert {"stall%d" % i for i in rare} <= {e[0] for e in pev}


def test_spool_policy_env_opt_out(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_SPOOL_POLICY", "uniform")
    assert spool_mod.SpanSpool(str(tmp_path), "u-0").policy == "uniform"
    assert spool_mod.SpanSpool(str(tmp_path), "u-2",
                               policy="weighted").policy == "weighted"
    monkeypatch.delenv("PADDLE_TPU_SPOOL_POLICY")
    assert spool_mod.SpanSpool(str(tmp_path), "u-1").policy == "weighted"


def test_spool_tolerates_torn_tail_line(tmp_path):
    seg = tmp_path / "k-0.spans-000.jsonl"
    good = json.dumps(["ok", 0.0, 1.0, 0, "op", None])
    seg.write_text(good + "\n" + '["torn", 1.0')
    assert spool_mod.load_spooled_spans(str(tmp_path), "k-0") == \
        jspool.load_spooled_spans(str(tmp_path), "k-0")
    assert [e[0] for e in spool_mod.load_spooled_spans(
        str(tmp_path), "k-0")] == ["ok"]


def test_tracing_record_feeds_spool(tmp_path):
    sp = spool_mod.SpanSpool(str(tmp_path), "r-0", head=100, reservoir=10,
                             segment_bytes=1 << 20, flush_every=1)
    tracing._set_spool(sp)
    with tracing.span("wired_span", cat="op"):
        pass
    tracing._set_spool(None)
    events = spool_mod.load_spooled_spans(str(tmp_path), "r-0") or []
    assert any(e[0] == "wired_span" for e in events)


# -- the per-process dumper ----------------------------------------------------

def test_dump_process_writes_the_healthz_path(tmp_path, monkeypatch):
    """The file ``dump_path()`` names, with the registry, the spans, the
    flight ring and the series; ``load_dumps`` reads it back."""
    monkeypatch.setenv("PADDLE_TPU_METRICS_DIR", str(tmp_path))
    monkeypatch.setenv("PADDLE_ROLE", "trainer")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
    ts._reset_for_tests()
    obs.inc("executor.steps", 2, path="compiled")
    with tracing.span("compiled_step", cat="step"):
        pass
    path = dist.dump_path()
    assert path == str(tmp_path / "trainer-3.json")
    assert dist.dump_process() == path
    (doc,) = dist.load_dumps(str(tmp_path))
    assert doc["proc"] == "trainer-3" and doc["rank"] == 3
    assert doc["metrics"]["counters"]["executor.steps{path=compiled}"] == 2
    assert any(s[0] == "compiled_step" for s in doc["spans"])
    assert "executor.steps{path=compiled}" in doc["series"]
    assert dist.load_sampled_profiles(str(tmp_path)) == {}


def test_clear_stale_dumps_removes_dumps_and_segments(tmp_path):
    (tmp_path / "trainer-0.json").write_text("{}")
    (tmp_path / "trainer-0.spans-000.jsonl").write_text("[]\n")
    (tmp_path / "job.json").write_text("{}")
    assert dist.clear_stale_dumps(str(tmp_path)) == 2
    assert os.listdir(str(tmp_path)) == ["job.json"]
