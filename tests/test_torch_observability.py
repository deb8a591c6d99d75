"""The port's observability layer against the JAX package's, on the CPU.

- The same records (counters with and without labels, gauges,
  histograms under and over the 512-value reservoir, label values that
  need escaping) give the same ``dump_prometheus()`` text and the same
  JSON ``dump()`` in both packages. Percentiles past the reservoir depend
  on each histogram's own seeded stream, which both packages derive
  alike in one process.
- The guarded helpers record only while the layer is armed; the direct
  handles always do; ``FLAGS_tpu_metrics`` and ``enable()`` agree.
- Trace context: ids survive ``inject`` / ``extract`` across the two
  packages in both directions; ``child_span`` nests under an explicit,
  an ambient or no parent; ``record_span`` and ``trace`` record under
  their context; disarmed, nothing records and nothing is injected.
- ``serving.metrics`` records into the process registry as the JAX
  package's does, and an engine's own view stays its own.
"""
import numpy as np
import pytest

from paddle_tpu import observability as jobs
from paddle_tpu.observability import distributed as jdt

import paddle_tpu_torch as fluid
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.observability import distributed as dt
from paddle_tpu_torch.observability import tracing
from paddle_tpu_torch.serving import metrics as sm


@pytest.fixture(autouse=True)
def _clean():
    for o in (obs, jobs):
        o.reset()
        o.enable()
    yield
    for o in (obs, jobs):
        o.reset()
        o.disable()


def _record(o, seed, n_hist):
    rng = np.random.RandomState(seed)
    o.counter("serving.requests").inc(7)
    o.counter("serving.shed", **{"class": "low"}).inc(3)
    o.counter("serving.shed", **{"class": "high"}).inc()
    o.counter("fault.injected", side="send", kind="close").inc(2)
    o.gauge("serving.queue_depth").set(5)
    o.gauge("device.live_bytes", device='cu"da\\0\n').set(1.5)
    o.gauge("serving.kv_occupancy").inc(0.25)
    for v in rng.exponential(3.0, n_hist):
        o.histogram("serving.total_ms").observe(float(v))
    o.histogram("serving.ttft_ms", lane="a b").observe(2.0)
    o.inc("executor.steps", path="compiled")
    o.observe("executor.step_ms", 1.25, path="compiled")
    o.set_gauge("pipeline.bubble_fraction", 0.125)


def _without_memory(text):
    """The JAX dump samples its device-memory gauges (``memory.*``) at
    dump time; the port keeps no such pull gauges."""
    out, skip = [], False
    for ln in text.splitlines(keepends=True):
        if ln.startswith("# TYPE "):
            skip = ln.split()[2].startswith("paddle_tpu_memory_")
        if not skip:
            out.append(ln)
    return "".join(out)


@pytest.mark.parametrize("n_hist", [0, 1, 100, 512, 2000])
def test_same_records_give_the_same_dumps(n_hist):
    _record(obs, n_hist, n_hist)
    _record(jobs, n_hist, n_hist)
    assert obs.dump_prometheus() == _without_memory(jobs.dump_prometheus())
    jdump = jobs.dump()
    for kind in ("counters", "gauges", "histograms"):
        jdump[kind] = {k: v for k, v in jdump[kind].items()
                       if not k.startswith("memory.")}
    assert obs.dump() == {**jdump, "spans": obs.dump()["spans"]}
    assert obs.dump()["enabled"] is True


def test_guarded_helpers_record_only_while_armed():
    obs.disable()
    obs.inc("a.b")
    obs.observe("a.h", 1.0)
    obs.set_gauge("a.g", 3)
    assert obs.dump_prometheus() == ""
    assert obs.counter_value("a.b") == 0 and obs.gauge_value("a.g") == 0
    sm.inc(sm.REQUESTS)          # the serving families are always on
    assert obs.counter_value(sm.REQUESTS) == 1
    obs.enable()
    obs.inc("a.b", 2)
    assert obs.counter_value("a.b") == 2
    with pytest.raises(ValueError, match="cannot decrease"):
        obs.counter("a.b").inc(-1)
    with pytest.raises(TypeError, match="already registered"):
        obs.gauge("a.b")
    with pytest.raises(ValueError, match="unknown dump format"):
        obs.dump("xml")


def test_flag_and_enable_agree():
    fluid.set_flags({"FLAGS_tpu_metrics": False})
    assert not obs.enabled() and not tracing.active()
    assert fluid.get_flags(["FLAGS_tpu_metrics"])[
        "FLAGS_tpu_metrics"] is False
    obs.enable()
    assert fluid.get_flags(["FLAGS_tpu_metrics"])["FLAGS_tpu_metrics"]
    fluid.set_flags({"FLAGS_tpu_metrics": True})
    assert obs.enabled() and tracing.active()


def test_trace_ids_survive_inject_and_extract_across_packages():
    with dt.trace("root") as ctx:
        hdr = dt.inject({"method": "x"})
    assert hdr["trace_id"] == ctx.trace_id
    assert hdr["parent_span"] == ctx.span_id
    assert jdt.extract(hdr) == (ctx.trace_id, ctx.span_id)
    assert dt.extract(hdr) == (ctx.trace_id, ctx.span_id)
    with jdt.trace("jroot") as jctx:
        jhdr = jdt.inject({})
    assert dt.extract(jhdr) == (jctx.trace_id, jctx.span_id)
    # a child span under the extracted ids joins the caller's trace
    with dt.child_span("server", cat="rpc", trace_id=jhdr["trace_id"],
                       parent_span=jhdr["parent_span"]) as c:
        assert dt.current() is c
        assert c.trace_id == jctx.trace_id
        with dt.child_span("inner") as inner:   # ambient parent
            assert inner.trace_id == jctx.trace_id
        again = dt.inject({})
        assert again == {"trace_id": c.trace_id, "parent_span": c.span_id}
    assert dt.current() is None
    assert dt.extract({}) == (None, None)
    assert dt.extract("not a dict") == (None, None)
    spans = {ev[0]: ev for ev in tracing.trace_events()}
    assert spans["server"][5]["parent_span"] == jctx.span_id
    assert spans["inner"][5]["parent_span"] == spans["server"][5]["span_id"]
    assert spans["root"][5]["trace_id"] == ctx.trace_id
    # no header, no ambient context: a fresh trace with no parent
    with dt.child_span("fresh", parent_span="orphan") as f:
        assert f.trace_id not in (ctx.trace_id, jctx.trace_id)
    fresh = [ev for ev in tracing.trace_events() if ev[0] == "fresh"][0]
    assert "parent_span" not in fresh[5]


def test_record_span_and_the_disarmed_layer(monkeypatch):
    ctx = dt.TraceContext("t" * 32, "s" * 16)
    dt.record_span("post_hoc", 0.0, cat="serving", ctx=ctx, bucket=4)
    (ev,) = tracing.trace_events()
    assert ev[0] == "post_hoc" and ev[4] == "serving"
    assert ev[5] == {"bucket": 4, "trace_id": "t" * 32,
                     "parent_span": "s" * 16}
    obs.disable()
    with dt.trace("off") as a, dt.child_span("off2") as b:
        assert a is None and b is None
        assert dt.inject({}, ctx=ctx) == {}
    dt.record_span("off3", 0.0, ctx=ctx)
    assert len(tracing.trace_events()) == 1
    monkeypatch.setenv(dt.JOB_TRACE_ENV, " job123 ")
    assert dt.job_trace_id() == "job123" == jdt.job_trace_id()
    monkeypatch.delenv("PADDLE_TPU_METRICS_DIR", raising=False)
    assert dt.dump_path() is None
    monkeypatch.setenv("PADDLE_TPU_METRICS_DIR", "/m")
    monkeypatch.setenv("PADDLE_ROLE", "serving")
    monkeypatch.setenv("PADDLE_SERVING_REPLICA_INDEX", "3")
    assert dt.dump_path() == jdt.dump_path() == "/m/serving-3.json"


def test_serving_metrics_record_into_the_process_registry():
    view_a, view_b = sm.EngineMetrics(), sm.EngineMetrics()
    view_a.inc(sm.REQUESTS, 2)
    view_b.inc(sm.REQUESTS)
    view_a.observe_many(sm.TTFT_MS, [1.0, 2.0, 3.0])
    view_b.set_queue_depth(4)
    assert view_a.snapshot()[sm.REQUESTS] == 2
    assert view_b.snapshot()[sm.REQUESTS] == 1
    assert view_a.snapshot()[sm.TTFT_MS]["count"] == 3
    assert view_b.snapshot()[sm.QUEUE_DEPTH] == 4
    proc = sm.snapshot()
    assert proc[sm.REQUESTS] == 3 and proc[sm.TTFT_MS]["count"] == 3
    assert proc[sm.QUEUE_DEPTH] == 4
    # the process registry's keys are the JAX snapshot's, plus one family
    from paddle_tpu.serving import metrics as jsm

    assert set(proc) == set(jsm.snapshot()) | {sm.PREFILL_CHUNKS}
    obs.reset()   # the next write lands in the fresh registry
    view_a.inc(sm.REQUESTS)
    assert obs.counter_value(sm.REQUESTS) == 1
    assert view_a.snapshot()[sm.REQUESTS] == 3
