"""The port's HTTP front (``paddle_tpu_torch/serving/http.py``) on the CPU.

- The HTTP cases of ``tests/test_serving.py:629-745`` through the port:
  ``/predict`` and ``/healthz``, ``/metrics`` as Prometheus text, the
  error mapping (400, 404), ``/healthz`` 503 after stop, the lifecycle
  states, the machine-readable ``/healthz`` body, and the typed 504 of a
  request whose deadline passed while queued.
- The same requests to a JAX server and to a port server, each over a
  predictor of one model saved by the JAX package (an fc -> relu -> fc ->
  softmax net), give the same status codes and JSON keys, and answers
  within ``TOL`` = 1e-5; ``/generate`` on either package's CPU decode
  engine gives the same codes and event schema.
- ``/generate`` on the CPU decode engine matches its in-process stream
  bit for bit, ``resume_from`` included; ``X-Trace-Id`` is echoed and the
  engine's ``serving.dispatch`` span lands under it.

No case depends on timing: a gated stub predictor (``threading.Event``)
holds the only worker where a case needs a queue, every server binds
``127.0.0.1:0`` and is closed by its fixture, and every socket has a
timeout.
"""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.inference as jinf
import paddle_tpu.serving as jserving
from paddle_tpu import observability as jobs
from paddle_tpu.serving.decode import (DecodeConfig as JDecodeConfig,
                                       DecodeEngine as JDecodeEngine)

import paddle_tpu_torch as fluid
import paddle_tpu_torch.inference as pinf
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import serving
from paddle_tpu_torch.observability import tracing
from paddle_tpu_torch.serving.decode import DecodeConfig, DecodeEngine

TOL = 1e-5
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


class _StubTensor:
    def __init__(self, name, data):
        self.name, self.data = name, data


class _StubPredictor:
    """y = 2x. With a ``gate``, each run waits for it (and sets
    ``entered`` first), so a case can hold the worker deterministically."""

    def __init__(self, gate=None):
        self.gate = gate
        self.entered = threading.Event()
        self.calls = []

    def get_input_names(self):
        return ["x"]

    def run(self, feed):
        self.entered.set()
        if self.gate is not None:
            assert self.gate.wait(TIMEOUT)
        x = np.asarray(feed["x"])
        self.calls.append(x.shape[0])
        return [_StubTensor("y", x * 2.0)]


def _serve(engine):
    server, _ = serving.start_http_server(engine, host="127.0.0.1", port=0)
    return server, "http://127.0.0.1:%d" % server.server_address[1]


def _close(server):
    server.shutdown()
    server.server_close()


@pytest.fixture()
def http_server():
    eng = serving.ServingEngine(
        _StubPredictor(), serving.ServingConfig(max_batch_size=4,
                                                num_workers=1),
        sample_feed={"x": np.zeros((1, 3), "float32")}).start()
    server, base = _serve(eng)
    yield eng, base
    _close(server)
    eng.stop()


def _post(url, payload, headers=()):
    hdrs = {"Content-Type": "application/json"}
    hdrs.update(dict(headers))
    req = urllib.request.Request(url, json.dumps(payload).encode(), hdrs)
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return r.status, json.loads(r.read())


def _call(method, url, payload=None, headers=()):
    """(status, headers, body) of any reply, error statuses included."""
    data = None if payload is None else json.dumps(payload).encode()
    hdrs = {"Content-Type": "application/json"}
    hdrs.update(dict(headers))
    req = urllib.request.Request(url, data, hdrs, method=method)
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


# -- tests/test_serving.py's HTTP cases --------------------------------------

def test_http_predict_and_healthz(http_server):
    eng, base = http_server
    with urllib.request.urlopen(base + "/healthz", timeout=TIMEOUT) as r:
        assert r.status == 200
    status, body = _post(base + "/predict",
                         {"inputs": {"x": [[1, 2, 3], [4, 5, 6]]}})
    assert status == 200
    np.testing.assert_array_equal(np.asarray(body["outputs"]["y"]),
                                  [[2, 4, 6], [8, 10, 12]])
    assert body["latency_ms"] > 0


def test_http_metrics_prometheus_text(http_server):
    eng, base = http_server
    _post(base + "/predict", {"inputs": {"x": [[1, 2, 3]]}})
    with urllib.request.urlopen(base + "/metrics", timeout=TIMEOUT) as r:
        text = r.read().decode()
    assert "# TYPE paddle_tpu_serving_requests counter" in text
    assert "paddle_tpu_serving_batch_size" in text


def test_http_error_mapping(http_server):
    eng, base = http_server
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/predict", {"not_inputs": 1})
    assert ei.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/predict", {"inputs": {"x": [[1, 2, 3]]},
                                  "deadline_ms": "soon"})
    assert ei.value.code == 400  # a client error, not a 500
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/nowhere", {})
    assert ei.value.code == 404


def test_http_healthz_unhealthy_after_stop(http_server):
    eng, base = http_server
    eng.stop()
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(base + "/healthz", timeout=TIMEOUT)
    assert ei.value.code == 503
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/predict", {"inputs": {"x": [[1, 2, 3]]}})
    assert ei.value.code == 503


def test_engine_lifecycle_states():
    """starting -> warming (seen from inside the warm-up dispatch) ->
    serving -> draining -> stopped."""
    states = []

    class Watching(_StubPredictor):
        def __init__(self, engine_ref):
            super().__init__()
            self.engine_ref = engine_ref

        def run(self, feed):
            if self.engine_ref:
                states.append(self.engine_ref[0].health())
            return super().run(feed)

    ref = []
    eng = serving.ServingEngine(
        Watching(ref), serving.ServingConfig(max_batch_size=2,
                                             num_workers=1, warmup=True),
        sample_feed={"x": np.zeros((1, 3), "float32")})
    ref.append(eng)
    assert eng.health() == "starting"
    eng.start()
    assert states and all(s == "warming" for s in states), states
    assert eng.health() == "serving"
    assert eng.stats()["state"] == "serving"
    assert eng.health_doc() == {"status": "serving",
                                "engine_kind": "oneshot", "queue_depth": 0}
    eng.stop()
    assert eng.health() == "stopped"


def test_http_healthz_body_is_machine_readable(http_server):
    eng, base = http_server
    with urllib.request.urlopen(base + "/healthz", timeout=TIMEOUT) as r:
        doc = json.loads(r.read())
    assert doc["status"] == "serving" and doc["engine_kind"] == "oneshot"
    assert "metrics_dump" in doc
    eng.stop()
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(base + "/healthz", timeout=TIMEOUT)
    assert json.loads(ei.value.read())["status"] in ("draining", "stopped")


def test_http_deadline_expired_504_typed_body():
    """A request whose deadline passes while it is queued behind a held
    worker is a typed 504, never a silent drop."""
    gate = threading.Event()
    stub = _StubPredictor(gate)
    eng = serving.ServingEngine(
        stub, serving.ServingConfig(max_batch_size=1, num_workers=1,
                                    warmup=False),
        sample_feed={"x": np.zeros((1, 3), "float32")}).start()
    server, base = _serve(eng)
    try:
        occupier = eng.submit({"x": np.ones((1, 3), "f4")})
        assert stub.entered.wait(TIMEOUT)   # the worker is held
        reply = {}

        def doomed():
            reply["r"] = _call("POST", base + "/predict",
                               {"inputs": {"x": [[1, 2, 3]]},
                                "deadline_ms": 0.001})

        t = threading.Thread(target=doomed)
        t.start()
        while eng.stats()["queue_depth"] == 0 and t.is_alive():
            threading.Event().wait(0.001)
        gate.set()
        t.join(TIMEOUT)
        status, _, body = reply["r"]
        assert status == 504
        assert json.loads(body)["type"] == "DeadlineExpired"
        occupier.result(TIMEOUT)
        assert eng.stats()["serving.deadline_expired"] == 1
    finally:
        gate.set()
        _close(server)
        eng.stop()


def test_http_generate_on_a_one_shot_engine_is_501(http_server):
    eng, base = http_server
    status, _, body = _call("POST", base + "/generate", {"prompt": [1, 2]})
    assert status == 501 and json.loads(body)["type"] == "NotStreaming"


# -- parity with the JAX package's server ------------------------------------

def _save_jax_mlp(dirname, dim=6, classes=3):
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.unique_name.guard(), jfluid.program_guard(main, startup):
        x = jfluid.data(name="x", shape=[-1, dim], dtype="float32")
        pred = jfluid.layers.fc(jfluid.layers.fc(x, 8, act="relu"),
                                classes, act="softmax")
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        jfluid.io.save_inference_model(dirname, ["x"], [pred], exe,
                                       main_program=main)


@pytest.fixture()
def twin_servers(tmp_path):
    """(JAX base url, port base url, port predictor) over one JAX-saved
    model, each behind its package's engine and HTTP front."""
    _save_jax_mlp(str(tmp_path))
    jcfg = jinf.AnalysisConfig(str(tmp_path))
    jcfg.disable_gpu()
    jeng = jserving.ServingEngine(
        jinf.create_paddle_predictor(jcfg),
        jserving.ServingConfig(max_batch_size=4, num_workers=1)).start()
    pcfg = pinf.AnalysisConfig(str(tmp_path))
    pcfg.disable_gpu()
    ppred = pinf.create_paddle_predictor(pcfg)
    peng = serving.ServingEngine(
        ppred, serving.ServingConfig(max_batch_size=4, num_workers=1)).start()
    jsrv, _ = jserving.start_http_server(jeng, host="127.0.0.1", port=0)
    psrv, pbase = _serve(peng)
    yield "http://127.0.0.1:%d" % jsrv.server_address[1], pbase, ppred
    for srv in (jsrv, psrv):
        _close(srv)
    jeng.stop()
    peng.stop()


REQUESTS = [
    ("POST", "/predict", {"inputs": {"x": [[0.1 * i for i in range(6)]]}}),
    ("POST", "/predict", {"inputs": {"x": [[1, 2, 3, 4, 5, 6],
                                           [-1, 0, 1, 2, 3, 4],
                                           [6, 5, 4, 3, 2, 1]]},
                          "cost_class": "low", "deadline_ms": 30000}),
    ("POST", "/predict", {"not_inputs": 1}),
    ("POST", "/predict", {"inputs": {"x": [[1, 2, 3]]}}),
    ("POST", "/predict", {"inputs": {"z": [[1, 2, 3, 4, 5, 6]]}}),
    ("POST", "/predict", {"inputs": {"x": [[1, 2, 3, 4, 5, 6]]},
                          "deadline_ms": "soon"}),
    ("POST", "/predict", {"inputs": {"x": [[1] * 6] * 5}}),
    ("POST", "/predict", {"inputs": {"x": [[1] * 6]}, "cost_class": 3}),
    ("POST", "/nowhere", {}),
    ("GET", "/nowhere", None),
    ("GET", "/healthz", None),
    ("POST", "/generate", {"prompt": [1, 2]}),
]


def test_port_and_jax_servers_answer_alike(twin_servers):
    jbase, pbase, ppred = twin_servers
    # the port's predictor applied the passes: fc, as the JAX one
    assert [op.type for op in ppred._program.global_block().ops] == [
        "fc", "fc", "softmax"]
    for method, path, payload in REQUESTS:
        js, jh, jb = _call(method, jbase + path, payload)
        ps, ph, pb = _call(method, pbase + path, payload)
        assert ps == js, (path, payload, ps, js, pb, jb)
        assert ph.get("Content-Type") == jh.get("Content-Type"), path
        jdoc, pdoc = json.loads(jb), json.loads(pb)
        assert sorted(pdoc) == sorted(jdoc), (path, pdoc, jdoc)
        if ps == 200 and path == "/predict":
            got = np.asarray(pdoc["outputs"][sorted(pdoc["outputs"])[0]])
            want = np.asarray(jdoc["outputs"][sorted(jdoc["outputs"])[0]])
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
        if path == "/healthz":
            assert pdoc == {**jdoc, "queue_depth": pdoc["queue_depth"]}
        if "type" in jdoc:
            assert pdoc["type"] == jdoc["type"]
    # both /metrics carry the JAX package's serving families
    _, _, jm = _call("GET", jbase + "/metrics")
    _, _, pm = _call("GET", pbase + "/metrics")
    jfam = {ln.split()[2] for ln in jm.decode().splitlines()
            if ln.startswith("# TYPE paddle_tpu_serving_")}
    pfam = {ln.split()[2] for ln in pm.decode().splitlines()
            if ln.startswith("# TYPE paddle_tpu_serving_")}
    assert jfam and jfam <= pfam, jfam - pfam


def _decode_kw():
    return dict(kv_blocks=64, max_tokens_cap=256, eos_token=None)


def _stream_http(base, payload, headers=()):
    """(status, events) of one ``/generate`` call."""
    data = json.dumps(payload).encode()
    req = urllib.request.Request(base + "/generate", data, dict(headers),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            assert r.headers["Content-Type"] == "application/x-ndjson"
            return r.status, [json.loads(ln) for ln in r if ln.strip()]
    except urllib.error.HTTPError as e:
        return e.code, [json.loads(e.read())]


@pytest.fixture()
def decode_server():
    eng = DecodeEngine(DecodeConfig(place=fluid.CPUPlace(),
                                    **_decode_kw())).start()
    server, base = _serve(eng)
    yield eng, base
    _close(server)
    eng.stop(drain=False)


def test_generate_matches_the_in_process_stream_bitwise(decode_server):
    eng, base = decode_server
    ref = DecodeEngine(DecodeConfig(place=fluid.CPUPlace(),
                                    **_decode_kw())).start()
    try:
        for i, (prompt, n) in enumerate((([5, 6, 7], 24), ([1] * 40, 9),
                                         ([3, 1, 4, 1, 5], 1))):
            want = list(ref.submit(prompt, max_tokens=n,
                                   request_id="ref-%d" % i))
            status, got = _stream_http(base, {"prompt": prompt,
                                              "max_tokens": n},
                                       [("X-Request-Id", "h-%d" % i)])
            assert status == 200
            assert got == want
            assert [e["index"] for e in got[:-1]] == list(range(n))
            assert got[-1]["type"] == "finish"
            # a resumed duplicate replays from the LRU, exactly once
            status, tail = _stream_http(
                base, {"prompt": prompt, "max_tokens": n,
                       "resume_from": n // 2},
                [("X-Request-Id", "h-%d" % i)])
            assert status == 200 and tail[:-1] == want[n // 2:-1]
    finally:
        ref.stop(drain=False)
    # typed refusals before the stream starts
    status, (doc,) = _stream_http(base, {"prompt": []})
    assert status == 400 and doc["type"] == "ValueError"
    status, (doc,) = _stream_http(base, {"prompt": [1],
                                         "deadline_ms": "x"})
    assert status == 400


def test_generate_codes_and_schema_match_the_jax_server(decode_server):
    eng, pbase = decode_server
    jeng = JDecodeEngine(JDecodeConfig(**_decode_kw())).start()
    jsrv, _ = jserving.start_http_server(jeng, host="127.0.0.1", port=0)
    jbase = "http://127.0.0.1:%d" % jsrv.server_address[1]
    try:
        for payload in ({"prompt": [9, 8, 7], "max_tokens": 6},
                        {"prompt": [2], "max_tokens": 1,
                         "cost_class": "low"},
                        {"prompt": []}, {"prompt": "abc"},
                        {"prompt": [1], "deadline_ms": "x"}):
            js, jev = _stream_http(jbase, payload)
            ps, pev = _stream_http(pbase, payload)
            assert ps == js, payload
            assert [sorted(e) for e in pev] == [sorted(e) for e in jev]
            assert [e.get("type") for e in pev] == [e.get("type")
                                                    for e in jev]
        for b in (jbase, pbase):
            _, _, body = _call("GET", b + "/healthz")
            doc = json.loads(body)
            assert doc["engine_kind"] == "decode"
        jdoc = json.loads(_call("GET", jbase + "/healthz")[2])
        pdoc = json.loads(_call("GET", pbase + "/healthz")[2])
        assert sorted(pdoc) == sorted(jdoc)
    finally:
        _close(jsrv)
        jeng.stop(drain=False)


def test_trace_id_is_echoed_and_the_dispatch_joins_it(http_server):
    eng, base = http_server
    status, headers, body = _call(
        "POST", base + "/predict", {"inputs": {"x": [[1, 2, 3]]}},
        headers=[("X-Trace-Id", "feedbeef" * 4),
                 ("X-Parent-Span", "0123abcd")])
    assert status == 200
    assert headers["X-Trace-Id"] == "feedbeef" * 4
    spans = {ev[0]: ev[5] for ev in tracing.trace_events()}
    assert spans["serving.request"]["trace_id"] == "feedbeef" * 4
    assert spans["serving.request"]["parent_span"] == "0123abcd"
    # the worker's dispatch span parents to the request's span
    assert spans["serving.dispatch"]["trace_id"] == "feedbeef" * 4
    assert spans["serving.dispatch"]["parent_span"] == \
        spans["serving.request"]["span_id"]
    # an error the engine raises echoes the trace too
    status, headers, _ = _call("POST", base + "/predict",
                               {"inputs": {"z": [[1, 2, 3]]}},
                               headers=[("X-Trace-Id", "ab" * 16)])
    assert status == 400 and headers["X-Trace-Id"] == "ab" * 16
    # disarmed, nothing is echoed
    obs.disable()
    status, headers, _ = _call("POST", base + "/predict",
                               {"inputs": {"x": [[1, 2, 3]]}},
                               headers=[("X-Trace-Id", "cd" * 16)])
    assert status == 200 and "X-Trace-Id" not in headers
