"""The port's replica fleet (``paddle_tpu_torch/serving/fleet.py``) on the
CPU, over real loopback HTTP replicas.

- The 19 cases of ``tests/test_serving_fleet.py`` through the port:
  config validation, round trip and spread, unknown cost class, the hard
  admission bound, shedding by class, the priority lanes' dispatch order,
  typed queue expiry, deadline inheritance by a hedge, a straggler hedged
  exactly once, request-id dedup at the router and at the replica, retry
  and ejection of a dead replica, draining beating connection refusal,
  rejoin after replacement, the typed ``ReplicaUnavailable``, injected RPC
  faults absorbed, and the HTTP front over a fleet (a round trip, the typed
  504, the typed 503 shed).
- The fleet cases of ``tests/test_serving_decode.py:406-564``: cost-unit
  pricing, a long low stream shed before a short high one, one-shot
  admission unchanged, the probe learning ``engine_kind``, exactly-once
  failover bit-identical to the survivor's own stream, and ``/generate``
  through an HTTP front on the router.
- Wire parity in both directions: the port's router in front of JAX
  replicas, and the JAX router in front of port replicas (one-shot and
  decode, a stream failed over between two port replicas).

No case depends on timing. Where the JAX tests give a replica a sleep, a
``threading.Event`` gate holds it here and the case waits on the router's
own state (queue depth, replica state, in-flight counts) before it goes
on; the RPC faults come from the seeded injector with the prober off, so
their roll sequence replays. Every server binds ``127.0.0.1:0`` and is
closed by its fixture or ``finally``; every socket has a timeout.
"""
import http.server
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu.serving as jserving
from paddle_tpu import observability as jobs
from paddle_tpu.serving.decode import (DecodeConfig as JDecodeConfig,
                                       DecodeEngine as JDecodeEngine)

import paddle_tpu_torch as fluid
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import serving
from paddle_tpu_torch.distributed import fault
from paddle_tpu_torch.serving import metrics as sm
from paddle_tpu_torch.serving.decode import DecodeConfig, DecodeEngine

TIMEOUT = 30


@pytest.fixture(autouse=True)
def _clean_registry():
    for o in (obs, jobs):
        o.reset()
        o.enable()
    yield
    for o in (obs, jobs):
        o.reset()
        o.disable()


def _until(cond, what, timeout=TIMEOUT):
    """Wait for ``cond()`` (the router's or an engine's own state)."""
    end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > end:
            raise AssertionError("timed out waiting for " + what)
        threading.Event().wait(0.005)


class _StubTensor:
    def __init__(self, name, data):
        self.name, self.data = name, data


class _StubPredictor:
    """y = 2x; each run waits for ``gate`` (open unless a case closes it)
    and counts itself in ``entered``."""

    def __init__(self, gate=None):
        self.gate = gate
        self.calls = []
        self.entered = 0

    def get_input_names(self):
        return ["x"]

    def run(self, feed):
        self.entered += 1
        if self.gate is not None:
            assert self.gate.wait(TIMEOUT)
        x = np.asarray(feed["x"])
        self.calls.append(x.shape[0])
        return [_StubTensor("y", x * 2.0)]


class _Replica:
    """A port ``ServingEngine`` over a stub, behind its HTTP front."""

    def __init__(self, gate=None, **cfg):
        cfg.setdefault("max_batch_size", 8)
        cfg.setdefault("num_workers", 2)
        cfg.setdefault("warmup", False)
        self.stub = _StubPredictor(gate)
        self.eng = serving.ServingEngine(
            self.stub, serving.ServingConfig(**cfg),
            sample_feed={"x": np.zeros((1, 3), "float32")}).start()
        self.srv, _ = serving.start_http_server(self.eng, port=0)
        self.endpoint = "127.0.0.1:%d" % self.srv.server_address[1]

    def kill(self):
        try:
            self.srv.shutdown()
            self.srv.server_close()
        except OSError:
            pass
        self.eng.stop()


@pytest.fixture()
def replicas():
    made = []

    def make(gate=None, **cfg):
        r = _Replica(gate, **cfg)
        made.append(r)
        return r

    yield make
    for r in made:
        if r.stub.gate is not None:
            r.stub.gate.set()
        r.kill()


def _router(endpoints, **cfg):
    cfg.setdefault("max_queue", 32)
    cfg.setdefault("num_dispatchers", 4)
    cfg.setdefault("health_interval_ms", 40)
    cfg.setdefault("hedge_after_ms", 100)
    return serving.FleetRouter(endpoints, serving.FleetConfig(**cfg)).start()


X = np.arange(6, dtype="float32").reshape(2, 3)
ONE = np.ones((1, 3), "f4")


def _state(fr, ep):
    return {r["endpoint"]: r["state"] for r in fr.stats()["replicas"]}[ep]


# -- config ------------------------------------------------------------------

def test_fleet_config_validation():
    with pytest.raises(ValueError, match="admit fraction"):
        serving.FleetConfig(cost_classes=[("a", 0.0)])
    with pytest.raises(ValueError, match="duplicate"):
        serving.FleetConfig(cost_classes=[("a", 1.0), ("a", 0.5)])
    with pytest.raises(ValueError, match="default_class"):
        serving.FleetConfig(default_class="nope")
    cfg = serving.FleetConfig(max_queue=100)
    assert cfg.admit_depth("high") == 100
    assert cfg.admit_depth("low") == 50
    assert cfg.class_rank("high") < cfg.class_rank("low")
    with pytest.raises(ValueError, match="unknown cost class"):
        cfg.class_rank("bulk")


# -- routing and results -----------------------------------------------------

def test_fleet_roundtrip_and_spread(replicas):
    eps = [replicas().endpoint, replicas().endpoint]
    fr = _router(eps)
    try:
        for _ in range(12):
            out = fr.predict({"x": X}, timeout=TIMEOUT)
            np.testing.assert_array_equal(out["y"], X * 2)
        served = {r["endpoint"]: r["served"]
                  for r in fr.stats()["replicas"]}
        assert all(v > 0 for v in served.values()), served
    finally:
        fr.stop()


def test_fleet_unknown_cost_class_rejected(replicas):
    fr = _router([replicas().endpoint])
    try:
        with pytest.raises(ValueError, match="unknown cost class"):
            fr.submit({"x": X}, cost_class="bulk")
    finally:
        fr.stop()


def test_fleet_admission_hard_bound(replicas):
    """A full shared queue rejects with the typed ServerOverloaded (not a
    shed) and counts serving.rejected."""
    gate = threading.Event()
    rep = replicas(gate, num_workers=1, max_batch_size=1)
    fr = _router([rep.endpoint], max_queue=2, num_dispatchers=1,
                 cost_classes=[("only", 1.0)], hedge_after_ms=None)
    try:
        futures, rejected = [], 0
        for _ in range(12):
            try:
                futures.append(fr.submit({"x": ONE}, cost_class="only"))
            except serving.RequestShed:
                pytest.fail("the hard bound must raise ServerOverloaded, "
                            "not RequestShed")
            except serving.ServerOverloaded:
                rejected += 1
        assert rejected >= 12 - 3   # one in flight at most, two queued
        assert obs.counter_value("serving.rejected") == rejected
        gate.set()
        for f in futures:
            f.result(TIMEOUT)
    finally:
        gate.set()
        fr.stop()


def test_fleet_shed_by_class_under_overload(replicas):
    """Under a burst the low lane sheds strictly more than the high
    lane, high admits outnumber low admits, and sheds are typed and
    counted by class."""
    gate = threading.Event()
    rep = replicas(gate, num_workers=1, max_batch_size=4)
    fr = _router([rep.endpoint], max_queue=12, num_dispatchers=2,
                 hedge_after_ms=None)
    try:
        shed = {"high": 0, "normal": 0, "low": 0}
        admitted = dict(shed)
        futures = []
        classes = ("high", "normal", "low")
        for i in range(90):
            cls = classes[i % 3]
            try:
                futures.append(fr.submit({"x": ONE}, cost_class=cls))
                admitted[cls] += 1
            except serving.ServerOverloaded:  # RequestShed included
                shed[cls] += 1
        gate.set()
        for f in futures:
            f.result(TIMEOUT)
        assert shed["low"] > shed["high"], (shed, admitted)
        assert admitted["high"] > admitted["low"], (shed, admitted)
        assert obs.counter_value("serving.shed", **{"class": "low"}) > 0
    finally:
        gate.set()
        fr.stop()


def test_fleet_priority_lane_dispatch_order(replicas):
    """Admitted high-priority work leaves the queue before admitted
    low-priority work that arrived earlier."""
    gate = threading.Event()
    rep = replicas(gate, num_workers=1, max_batch_size=1)
    fr = _router([rep.endpoint], num_dispatchers=1, hedge_after_ms=None)
    try:
        order = []
        lock = threading.Lock()

        def track(f, tag):
            def done(_):
                with lock:
                    order.append(tag)
            f.add_done_callback(done)

        busy = fr.submit({"x": ONE}, cost_class="high")
        _until(lambda: rep.stub.entered == 1, "the busy request to run")
        track(fr.submit({"x": ONE}, cost_class="low"), "low")
        track(fr.submit({"x": ONE}, cost_class="high"), "high")
        assert fr.stats()["queue_depth"] == 2
        gate.set()
        busy.result(TIMEOUT)
        _until(lambda: len(order) == 2, "both lanes to finish")
        assert order == ["high", "low"], order
    finally:
        gate.set()
        fr.stop()


# -- deadlines ---------------------------------------------------------------

def test_fleet_queue_expiry_is_typed_not_silent(replicas):
    """A request whose deadline passes while queued fails with the typed
    DeadlineExpired (counted), never dispatched."""
    gate = threading.Event()
    rep = replicas(gate, num_workers=1, max_batch_size=1)
    fr = _router([rep.endpoint], num_dispatchers=1, hedge_after_ms=None)
    try:
        busy = fr.submit({"x": ONE})
        _until(lambda: rep.stub.entered == 1, "the busy request to run")
        doomed = fr.submit({"x": ONE}, deadline_ms=0.001)
        gate.set()
        with pytest.raises(serving.DeadlineExpired, match="queued"):
            doomed.result(TIMEOUT)
        busy.result(TIMEOUT)
        assert obs.counter_value("serving.deadline_expired") >= 1
        assert len(rep.stub.calls) == 1   # the doomed one never ran
    finally:
        gate.set()
        fr.stop()


class _RecordingReplica(threading.Thread):
    """A bare HTTP replica that records each /predict body (the deadline
    the fleet sent) and, given a closed gate, holds its answer until the
    gate opens."""

    def __init__(self, gate=None, healthz="serving"):
        super().__init__(daemon=True)
        self.bodies = []
        self.gate = gate
        self.answered = threading.Event()
        outer = self

        class H(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            timeout = TIMEOUT

            def log_message(self, *a):  # noqa: A003
                pass

            def do_GET(self):
                body = json.dumps({"status": healthz}).encode()
                self.send_response(200 if healthz == "serving" else 503)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                doc = json.loads(self.rfile.read(n) or b"{}")
                outer.bodies.append(doc)
                if outer.gate is not None:
                    outer.gate.wait(TIMEOUT)
                x = np.asarray(doc["inputs"]["x"], "float32")
                body = json.dumps(
                    {"outputs": {"y": (x * 2).tolist()}}).encode()
                try:
                    self.send_response(200)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except OSError:
                    pass  # a hedge loser: the client already hung up
                finally:
                    outer.answered.set()

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.server.daemon_threads = True
        self.endpoint = "127.0.0.1:%d" % self.server.server_address[1]

    def run(self):
        self.server.serve_forever()

    def close(self):
        if self.gate is not None:
            self.gate.set()
        self.server.shutdown()
        self.server.server_close()


def test_hedged_attempt_inherits_remaining_deadline():
    """The hedge's wire deadline_ms is the budget left when it launched:
    at least hedge_after_ms below the original attempt's."""
    slow = _RecordingReplica(gate=threading.Event())
    fast = _RecordingReplica()
    slow.start()
    fast.start()
    fr = _router([slow.endpoint, fast.endpoint], num_dispatchers=1,
                 hedge_after_ms=80, max_hedges=1,
                 health_interval_ms=60_000)
    try:
        out = fr.predict({"x": ONE}, deadline_ms=5000, timeout=TIMEOUT)
        assert out["y"].shape == (1, 3)
        assert slow.bodies and fast.bodies, "the hedge never fired"
        first = slow.bodies[0]["deadline_ms"]
        hedge = fast.bodies[0]["deadline_ms"]
        assert hedge < first - 50, (first, hedge)
        assert obs.counter_value("serving.hedges") == 1
    finally:
        fr.stop()
        slow.close()
        fast.close()


# -- hedging and exactly once ------------------------------------------------

def test_fleet_hedge_straggler_exactly_once(replicas):
    """One replica straggles: the hedge wins on the other, the result
    surfaces once with the right values, and the request counts once on
    the fleet."""
    slow = _RecordingReplica(gate=threading.Event())
    slow.start()
    fast = replicas()
    fr = _router([slow.endpoint, fast.endpoint], num_dispatchers=1,
                 hedge_after_ms=60, max_hedges=1,
                 health_interval_ms=60_000)
    try:
        results = []
        f = fr.submit({"x": X}, deadline_ms=8000)
        f.add_done_callback(lambda fut: results.append(fut.result()))
        out = f.result(TIMEOUT)
        np.testing.assert_array_equal(out["y"], X * 2)
        slow.gate.set()
        assert slow.answered.wait(TIMEOUT)
        _until(lambda: all(r["inflight"] == 0
                           for r in fr.stats()["replicas"]),
               "the losing attempt to end")
        assert len(results) == 1          # the latch: one surface, ever
        assert obs.counter_value("serving.hedges") >= 1
        # one fleet admission and one winning-replica execution
        assert obs.counter_value("serving.requests") == 2
    finally:
        fr.stop()
        slow.close()


def test_fleet_request_id_dedup(replicas):
    fr = _router([replicas().endpoint, replicas().endpoint])
    try:
        f1 = fr.submit({"x": X}, request_id="req-7")
        f2 = fr.submit({"x": X}, request_id="req-7")
        assert f1 is f2
        f1.result(TIMEOUT)
        f3 = fr.submit({"x": X}, request_id="req-7")  # a late duplicate
        assert f3 is f1
        assert obs.counter_value("serving.requests") == 2
        assert obs.counter_value("serving.dedup_hits") == 2
    finally:
        fr.stop()


def test_engine_request_id_dedup_never_reruns_predictor():
    stub = _StubPredictor()
    eng = serving.ServingEngine(
        stub, serving.ServingConfig(max_batch_size=4, num_workers=1,
                                    warmup=False),
        sample_feed={"x": np.zeros((1, 3), "float32")}).start()
    try:
        f1 = eng.submit({"x": X}, request_id="r1")
        f2 = eng.submit({"x": X}, request_id="r1")
        assert f1 is f2
        np.testing.assert_array_equal(f1.result(TIMEOUT)["y"], X * 2)
        f3 = eng.submit({"x": X}, request_id="r1")
        assert f3 is f1
        assert len(stub.calls) == 1
        assert obs.counter_value("serving.requests") == 1
        assert obs.counter_value("serving.dedup_hits") == 2
        assert eng.stats()["serving.dedup_hits"] == 2
    finally:
        eng.stop()


# -- health-checked routing --------------------------------------------------

def test_fleet_retry_on_dead_replica_and_ejection(replicas):
    r1, r2 = replicas(), replicas()
    r1.kill()
    fr = _router([r1.endpoint, r2.endpoint], eject_after=2,
                 hedge_after_ms=None, max_attempts=4)
    try:
        for _ in range(6):
            out = fr.predict({"x": X}, timeout=TIMEOUT)
            np.testing.assert_array_equal(out["y"], X * 2)
        _until(lambda: _state(fr, r1.endpoint) == "dead", "the ejection")
        assert obs.counter_value("serving.replica_ejections",
                                 cause="dead") >= 1
    finally:
        fr.stop()


def test_fleet_stops_routing_at_draining_not_refusal(replicas):
    r1, r2 = replicas(), replicas()
    fr = _router([r1.endpoint, r2.endpoint], health_interval_ms=30)
    try:
        fr.predict({"x": X}, timeout=TIMEOUT)
        r1.eng.stop()          # its HTTP server still answers
        _until(lambda: _state(fr, r1.endpoint) == "draining",
               "the draining replica to leave rotation")
        n2 = len(r2.stub.calls)
        for _ in range(6):
            out = fr.predict({"x": X}, timeout=TIMEOUT)
            np.testing.assert_array_equal(out["y"], X * 2)
        assert len(r2.stub.calls) >= n2 + 6   # all on the survivor
        assert obs.counter_value("serving.replica_ejections",
                                 cause="draining") == 1
    finally:
        fr.stop()


def test_fleet_rejoin_after_replacement(replicas):
    r1, r2 = replicas(), replicas()
    port = int(r1.endpoint.rsplit(":", 1)[1])
    fr = _router([r1.endpoint, r2.endpoint], eject_after=2,
                 health_interval_ms=30, hedge_after_ms=None)
    try:
        fr.predict({"x": X}, timeout=TIMEOUT)
        r1.kill()
        _until(lambda: _state(fr, r1.endpoint) == "dead", "the ejection")
        # relaunch on the same endpoint
        stub = _StubPredictor()
        eng3 = serving.ServingEngine(
            stub, serving.ServingConfig(max_batch_size=8, num_workers=1,
                                        warmup=False),
            sample_feed={"x": np.zeros((1, 3), "float32")}).start()
        srv3 = serving.ServingHTTPServer(eng3, "127.0.0.1", port)
        t = threading.Thread(target=srv3.serve_forever, daemon=True)
        t.start()
        try:
            _until(lambda: _state(fr, r1.endpoint) == "serving",
                   "the rejoin")
            assert obs.counter_value("serving.replica_rejoins") == 1
            for _ in range(8):
                fr.predict({"x": X}, timeout=TIMEOUT)
                if stub.calls:
                    break
            assert stub.calls
        finally:
            srv3.shutdown()
            srv3.server_close()
            eng3.stop()
    finally:
        fr.stop()


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_fleet_no_replica_fails_typed():
    fr = _router(["127.0.0.1:%d" % _free_port()], max_attempts=2,
                 hedge_after_ms=None, request_timeout_s=1.5,
                 eject_after=1000)
    try:
        with pytest.raises((serving.ReplicaUnavailable,
                            serving.DeadlineExpired)):
            fr.predict({"x": X}, deadline_ms=800, timeout=TIMEOUT)
    finally:
        fr.stop()


# -- faults on the fleet RPC path -------------------------------------------

def test_fleet_absorbs_injected_rpc_faults(replicas, monkeypatch):
    """close / dup / delay on the dispatch path: every request still
    succeeds (retried, or joined by the replica's request-id dedup), the
    faults are counted, nothing is lost."""
    monkeypatch.setenv("PADDLE_TPU_FAULTS",
                       "send.close:0.2,send.dup:0.2,recv.close:0.1,"
                       "any.delay:0.1:2")
    monkeypatch.setenv("PADDLE_TPU_FAULT_SEED", "7")
    fault.reset_injector()
    try:
        # the prober off and one dispatcher: the injector's rolls replay
        fr = _router([replicas().endpoint, replicas().endpoint],
                     hedge_after_ms=None, max_attempts=8,
                     num_dispatchers=1, health_interval_ms=60_000,
                     eject_after=1000)
        try:
            for i in range(20):
                out = fr.predict({"x": X}, deadline_ms=20000,
                                 timeout=TIMEOUT)
                np.testing.assert_array_equal(out["y"], X * 2)
        finally:
            fr.stop()
        assert obs.counter_value("serving.errors") == 0
        kinds = {m.qualified_name: m.value
                 for m in obs.metrics().all_metrics()
                 if m.kind == "counter" and m.name == "fault.injected"}
        assert sum(kinds.values()) > 0
        assert kinds.get("fault.injected{kind=close,side=send}", 0) > 0
        assert obs.counter_value("serving.fleet_retries") > 0
    finally:
        fault.reset_injector()


# -- the HTTP front over a fleet ---------------------------------------------

def _post(url, payload, headers=()):
    hdrs = {"Content-Type": "application/json"}
    hdrs.update(dict(headers))
    req = urllib.request.Request(url, json.dumps(payload).encode(), hdrs)
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return r.status, json.loads(r.read())


@pytest.fixture()
def fleet_http(replicas):
    fr = _router([replicas().endpoint, replicas().endpoint])
    server, _ = serving.start_http_server(fr, port=0)
    yield fr, "http://127.0.0.1:%d" % server.server_address[1]
    server.shutdown()
    server.server_close()
    fr.stop()


def test_http_front_serves_fleet(fleet_http):
    fr, base = fleet_http
    with urllib.request.urlopen(base + "/healthz", timeout=TIMEOUT) as r:
        assert r.status == 200
        assert json.loads(r.read())["status"] == "serving"
    status, body = _post(base + "/predict",
                         {"inputs": {"x": [[1, 2, 3]]}, "cost_class": "low"},
                         headers=[("X-Request-Id", "http-1")])
    assert status == 200
    np.testing.assert_array_equal(np.asarray(body["outputs"]["y"]),
                                  [[2, 4, 6]])
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/predict", {"inputs": {"x": [[1, 2, 3]]},
                                  "cost_class": 3})
    assert ei.value.code == 400


def test_http_fleet_deadline_expired_504_typed():
    """A black-hole replica (accepts, never answers): the fleet request's
    deadline expires and surfaces as a typed 504."""
    sink = socket.socket()
    sink.bind(("127.0.0.1", 0))
    sink.listen(8)
    fr = _router(["127.0.0.1:%d" % sink.getsockname()[1]],
                 hedge_after_ms=None, max_attempts=1, eject_after=1000)
    server, _ = serving.start_http_server(fr, port=0)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post("http://127.0.0.1:%d/predict" % server.server_address[1],
                  {"inputs": {"x": [[1, 2, 3]]}, "deadline_ms": 300})
        assert ei.value.code == 504
        assert json.loads(ei.value.read())["type"] == "DeadlineExpired"
    finally:
        server.shutdown()
        server.server_close()
        fr.stop()
        sink.close()


def test_http_fleet_shed_503_typed(replicas):
    """A shed lane surfaces as a 503 with type RequestShed and a
    Retry-After, told apart from the hard bound."""
    gate = threading.Event()
    rep = replicas(gate, num_workers=1, max_batch_size=1)
    fr = _router([rep.endpoint], max_queue=4, num_dispatchers=1,
                 hedge_after_ms=None)
    server, _ = serving.start_http_server(fr, port=0)
    base = "http://127.0.0.1:%d" % server.server_address[1]
    threads = []
    try:
        for _ in range(3):   # one in flight, two queued
            t = threading.Thread(target=_post, args=(
                base + "/predict", {"inputs": {"x": [[1, 2, 3]]},
                                    "cost_class": "high"}))
            t.start()
            threads.append(t)
        _until(lambda: fr.stats()["queue_depth"] == 2,
               "two queued high requests")
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base + "/predict", {"inputs": {"x": [[1, 2, 3]]},
                                      "cost_class": "low"})
        assert ei.value.code == 503
        assert ei.value.headers.get("Retry-After") == "1"
        assert json.loads(ei.value.read())["type"] == "RequestShed"
    finally:
        gate.set()
        for t in threads:
            t.join(TIMEOUT)
        server.shutdown()
        server.server_close()
        fr.stop()


# -- decode streams through the fleet ----------------------------------------

class TestFleetCostAdmission:
    def test_stream_units_pricing(self):
        cfg = serving.FleetConfig(cost_unit_tokens=16,
                                  default_stream_tokens=16)
        assert cfg.stream_units(None) == 1
        assert cfg.stream_units(1) == 1
        assert cfg.stream_units(16) == 1
        assert cfg.stream_units(17) == 2
        assert cfg.stream_units(512) == 32

    def test_long_low_sheds_before_short_high(self):
        r = serving.FleetRouter(["127.0.0.1:1"], serving.FleetConfig(
            max_queue=32, cost_unit_tokens=16, num_dispatchers=1,
            health_interval_ms=60_000)).start()
        try:
            with pytest.raises(serving.RequestShed):
                r.generate([1, 2], max_tokens=512, cost_class="low")
            short_low = r.generate([1, 2], max_tokens=16, cost_class="low")
            long_high = r.generate([1, 2], max_tokens=496,
                                   cost_class="high")
            assert r.stats()["queue_units"] == 32
            with pytest.raises(serving.RequestShed):
                r.submit({"x": np.zeros((1, 1))}, cost_class="low")
            assert obs.counter_value(sm.SHED, **{"class": "low"}) >= 1
            short_low.close()
            long_high.close()
            assert r.stats()["queue_units"] == 0
        finally:
            r.stop()

    def test_oneshot_admission_unchanged(self):
        cfg = serving.FleetConfig(max_queue=4, num_dispatchers=1,
                                  health_interval_ms=60_000)
        r = serving.FleetRouter(["127.0.0.1:1"], cfg)
        r._dispatch_loop = lambda: None   # pin the queue: nothing drains
        r.start()
        try:
            for _ in range(2):  # low watermark = round(0.5 * 4) = 2
                r.submit({"x": [1.0]}, cost_class="low", deadline_ms=60_000)
            with pytest.raises(serving.RequestShed):
                r.submit({"x": [1.0]}, cost_class="low", deadline_ms=60_000)
        finally:
            r.stop()


def _decode_kw():
    return dict(kv_blocks=256, max_tokens_cap=1024, eos_token=None)


class _Held:
    """A decode engine whose stream ``hold_rid`` (its first attempt only)
    pauses before token index ``hold_at`` until ``gate`` opens: a case
    can kill the replica while it still owes that stream tokens. Once
    ``dead`` is set the held stream's connection drops, as a killed
    replica's would (the HTTP front closes it without the last chunk)."""

    def __init__(self, engine, hold_rid=None, hold_at=5):
        self.engine = engine
        self.hold_rid, self.hold_at = hold_rid, hold_at
        self.gate = threading.Event()
        self.holding = threading.Event()
        self.dead = False

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def generate(self, prompt, **kw):
        stream = self.engine.generate(prompt, **kw)
        if kw.get("request_id") != self.hold_rid or kw.get("resume_from"):
            return stream

        def events():
            for ev in stream:
                if ev.get("index") == self.hold_at:
                    self.holding.set()
                    assert self.gate.wait(TIMEOUT)
                    if self.dead:
                        raise ConnectionResetError("the replica was killed")
                yield ev
        return events()


class _Fleet:
    """n port DecodeEngines on the CPU, each behind its HTTP front (held
    on stream ``hold_rid``, see ``_Held``), and a router over them."""

    def __init__(self, n=2, hold_rid=None, router=True, **cfg_kw):
        self.engines, self.held, self.servers, eps = [], [], [], []
        for _ in range(n):
            eng = DecodeEngine(DecodeConfig(place=fluid.CPUPlace(),
                                            **_decode_kw())).start()
            held = _Held(eng, hold_rid)
            srv, _ = serving.start_http_server(held, port=0)
            self.engines.append(eng)
            self.held.append(held)
            self.servers.append(srv)
            eps.append("127.0.0.1:%d" % srv.server_address[1])
        self.endpoints = eps
        self.router = None
        if router:
            cfg_kw.setdefault("health_interval_ms", 50)
            cfg_kw.setdefault("request_timeout_s", 60)
            cfg_kw.setdefault("stream_stall_s", 5.0)
            self.router = serving.FleetRouter(
                eps, serving.FleetConfig(**cfg_kw)).start()
            _until(lambda: self.router.healthy_count() == n, "the fleet up")

    def kill_held(self):
        """Stop the replica holding the stream: its server, its engine,
        then the held connection. Returns its index."""
        _until(lambda: any(h.holding.is_set() for h in self.held),
               "a held stream")
        j = next(i for i, h in enumerate(self.held) if h.holding.is_set())
        self.servers[j].shutdown()
        self.engines[j].stop(drain=False)
        self.held[j].dead = True
        self.held[j].gate.set()
        return j

    def wait_rotation(self, dead):
        """Wait until the router routes to every replica but ``dead``: a
        loaded host can time out two health probes of a live replica in
        a row, and the router then ejects it until its next good probe;
        a stream started in that window finds no replica and ends with
        ``replica_unavailable`` after ``max_attempts`` short naps (the
        router's own behaviour, the same in the JAX package)."""
        _until(lambda: all(r.routable != (i == dead) for i, r in
                           enumerate(self.router.replicas)),
               "the router's rotation without replica %d" % dead)

    def close(self):
        if self.router is not None:
            self.router.stop()
        for h, s, e in zip(self.held, self.servers, self.engines):
            h.gate.set()
            s.shutdown()
            s.server_close()
            e.stop(drain=False)


class TestFleetStreaming:
    def test_probe_learns_engine_kind(self):
        f = _Fleet(n=1)
        try:
            _until(lambda: f.router.replicas[0].kind == "decode",
                   "the probe")
            snap = f.router.replicas[0].snapshot()
            assert snap["kind"] == "decode"
            assert snap["kv_occupancy"] is not None
        finally:
            f.close()

    def test_exactly_once_failover_bit_identical(self):
        """Kill the replica mid-stream: the router resumes on the
        survivor with no token lost, repeated or changed."""
        f = _Fleet(n=2, hold_rid="f1")
        try:
            n = 120
            got, fin, killed = [], None, None
            for ev in f.router.generate([5, 6, 7], max_tokens=n,
                                        request_id="f1"):
                if ev["type"] == "token":
                    got.append(ev)
                    if len(got) == 5 and killed is None:
                        killed = f.kill_held()
                else:
                    fin = ev
            assert killed is not None
            assert [t["index"] for t in got] == list(range(n))
            assert fin["reason"] == "max_tokens"
            f.wait_rotation(killed)
            redo = list(f.router.generate([5, 6, 7], max_tokens=n,
                                          request_id="f2"))
            assert redo[-1]["type"] == "finish"
            assert redo[-1]["reason"] == "max_tokens", redo[-1]
            assert [t["token"] for t in got] == \
                [x["token"] for x in redo if x["type"] == "token"]
            assert f.router.stats()[sm.STREAM_RESUMES] >= 1
        finally:
            f.close()

    def test_http_front_streams_via_fleet(self):
        f = _Fleet(n=1)
        front, _ = serving.start_http_server(f.router, port=0)
        base = "http://127.0.0.1:%d" % front.server_address[1]
        try:
            body = json.dumps({"prompt": [9, 8], "max_tokens": 4}).encode()
            req = urllib.request.Request(base + "/generate", data=body,
                                         method="POST")
            with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
                evs = [json.loads(ln) for ln in resp if ln.strip()]
            toks = [e for e in evs if e["type"] == "token"]
            assert [t["index"] for t in toks] == [0, 1, 2, 3]
            assert evs[-1]["reason"] == "max_tokens"
        finally:
            front.shutdown()
            front.server_close()
            f.close()


# -- wire parity with the JAX package ----------------------------------------

class _JaxReplica:
    def __init__(self, engine):
        self.eng = engine.start()
        self.srv, _ = jserving.start_http_server(self.eng, port=0)
        self.endpoint = "127.0.0.1:%d" % self.srv.server_address[1]

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        if isinstance(self.eng, JDecodeEngine):
            self.eng.stop(drain=False)
        else:
            self.eng.stop()


def test_port_router_in_front_of_jax_replicas():
    oneshot = _JaxReplica(jserving.ServingEngine(
        _StubPredictor(), jserving.ServingConfig(max_batch_size=8,
                                                 num_workers=1,
                                                 warmup=False),
        sample_feed={"x": np.zeros((1, 3), "float32")}))
    decode = _JaxReplica(JDecodeEngine(JDecodeConfig(**_decode_kw())))
    fr = _router([oneshot.endpoint], health_interval_ms=30)
    dr = _router([decode.endpoint], health_interval_ms=30)
    try:
        out = fr.predict({"x": X}, request_id="w1", timeout=TIMEOUT)
        np.testing.assert_array_equal(out["y"], X * 2)
        assert fr.submit({"x": X}, request_id="w1").result(TIMEOUT) is out
        _until(lambda: fr.replicas[0].kind == "oneshot", "the probe")
        _until(lambda: dr.replicas[0].kind == "decode", "the probe")
        want = list(decode.eng.submit([4, 5, 6], max_tokens=12,
                                      request_id="ref"))
        got = list(dr.generate([4, 5, 6], max_tokens=12, request_id="w2"))
        assert got == want
    finally:
        fr.stop()
        dr.stop()
        oneshot.close()
        decode.close()


def test_jax_router_in_front_of_port_replicas(replicas):
    rep = replicas()
    jfr = jserving.FleetRouter([rep.endpoint], jserving.FleetConfig(
        max_queue=32, num_dispatchers=2, health_interval_ms=30)).start()
    f = _Fleet(n=2, hold_rid="jf", router=False)
    jdr = jserving.FleetRouter(f.endpoints, jserving.FleetConfig(
        health_interval_ms=30, request_timeout_s=60,
        stream_stall_s=5.0)).start()
    try:
        out = jfr.predict({"x": X}, request_id="j1", timeout=TIMEOUT)
        np.testing.assert_array_equal(out["y"], X * 2)
        jfr.predict({"x": X}, request_id="j1", timeout=TIMEOUT)
        assert len(rep.stub.calls) == 1   # the replica deduped the id
        _until(lambda: jfr.healthy_count() == 1, "the JAX probe")
        assert jfr.replicas[0].kind == "oneshot"
        _until(lambda: jdr.healthy_count() == 2, "the JAX probe")
        assert {r.kind for r in jdr.replicas} == {"decode"}
        # a stream failed over between two port replicas by the JAX router
        n = 60
        got, killed = [], None
        for ev in jdr.generate([5, 6, 7], max_tokens=n, request_id="jf"):
            if ev["type"] == "token":
                got.append(ev)
                if len(got) == 5 and killed is None:
                    killed = f.kill_held()
        assert killed is not None
        assert [t["index"] for t in got] == list(range(n))
        survivor = f.engines[1 - killed]
        want = list(survivor.submit([5, 6, 7], max_tokens=n,
                                    request_id="ref"))
        assert [t["token"] for t in got] == [
            e["token"] for e in want if e["type"] == "token"]
    finally:
        jfr.stop()
        jdr.stop()
        f.close()
