"""Stdlib HTTP front end for a serving engine, a decode engine or a fleet.

Counterpart of ``paddle_tpu/serving/http.py``. ``ThreadingHTTPServer``
(one thread per connection) is the right shape: client threads block on
their request's future while the engine batches across them, so
concurrency at the HTTP layer is the batch-formation opportunity.

Endpoints:

- ``POST /predict``: body ``{"inputs": {name: nested-list},
  "deadline_ms": optional, "cost_class": optional}``, arrays with their
  leading batch axis; an ``X-Request-Id`` header makes the request
  idempotent (a hedge or retry joins the original execution). Replies
  ``{"outputs": {name: nested-list}, "latency_ms": float}``. Typed
  failures map onto status codes and carry a ``type`` field: 503
  (``ServerOverloaded`` / ``RequestShed`` with ``Retry-After: 1``,
  ``EngineStopped``), 504 (``DeadlineExpired``: the deadline passed while
  queued), 400 (malformed), 500 (``BatchExecutionError``: the model failed
  on that batch; the engine stays healthy).
- ``POST /generate``: streaming decode on an engine with ``generate()``
  (a ``DecodeEngine``, or a ``FleetRouter`` in front of them): chunked
  ndjson token events, then exactly one finish event; see
  ``_do_generate``. 501 on a one-shot engine.
- ``GET /healthz``: 200 with ``{"status": "serving"}`` only while the
  engine accepts work, 503 with the actual state (``starting | warming |
  draining | stopped``) otherwise, so a router stops routing at
  ``draining``. An engine's ``health_doc()`` fills the body
  (``engine_kind``, and on a decode replica the KV occupancy); the body
  also names this process's metrics-dump path (``metrics_dump``).
- ``GET /metrics``: the whole process registry as Prometheus text
  (``observability.dump_prometheus()``).
- ``GET /stats``: the engine's ``stats()`` as JSON.

Trace propagation: ``POST /predict`` honours an ``X-Trace-Id`` (and
``X-Parent-Span``) request header, so the request's spans land under the
caller's trace, and echoes the trace id in its reply's ``X-Trace-Id``
while spans are armed (``observability.enable()``).
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Tuple

import numpy as np

from .. import observability as _obs
from ..observability import distributed as _dtrace
from .engine import (BatchExecutionError, DeadlineExpired, EngineStopped,
                     RequestTooLarge, ServerOverloaded, ServingEngine)

__all__ = ["ServingHTTPServer", "start_http_server", "serve"]


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    # -- plumbing ----------------------------------------------------------

    def log_message(self, fmt, *args):  # noqa: A003 — stdlib signature
        pass  # per-request stderr lines are noise; /metrics is the log

    def _reply(self, code: int, body: bytes, ctype: str,
               extra_headers: Tuple = ()) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in extra_headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, code: int, payload: dict,
                    extra_headers: Tuple = ()) -> None:
        self._reply(code, json.dumps(payload).encode(),
                    "application/json", extra_headers)

    # -- routes ------------------------------------------------------------

    def do_GET(self):  # noqa: N802 — stdlib naming
        engine = self.server.engine
        if self.path == "/healthz":
            health = engine.health()
            # engines that implement health_doc() (ServingEngine:
            # engine_kind=oneshot; DecodeEngine: engine_kind=decode +
            # KV occupancy) enrich the body; anything else — e.g. a
            # FleetRouter front — keeps the bare status contract
            doc_fn = getattr(engine, "health_doc", None)
            doc = doc_fn() if callable(doc_fn) else {"status": health}
            doc["metrics_dump"] = _dtrace.dump_path()
            if health == "serving":
                self._reply_json(200, _json_safe(doc))
            else:
                # starting/warming: not ready yet; "draining": stop()
                # flipped readiness but in-flight requests are still
                # finishing — the supervisor must stop routing now and
                # NOT kill the process yet
                self._reply_json(503, _json_safe(doc))
        elif self.path == "/metrics":
            self._reply(200, _obs.dump_prometheus().encode(),
                        "text/plain; version=0.0.4")
        elif self.path == "/stats":
            self._reply_json(200, _json_safe(engine.stats()))
        else:
            self._reply_json(404, {"error": "no route %s" % self.path})

    def do_POST(self):  # noqa: N802
        if self.path == "/generate":
            self._do_generate()
            return
        if self.path != "/predict":
            self._reply_json(404, {"error": "no route %s" % self.path})
            return
        engine: ServingEngine = self.server.engine
        t0 = time.monotonic()
        req_ctx = None
        try:
            length = int(self.headers.get("Content-Length") or 0)
            req = json.loads(self.rfile.read(length) or b"{}")
            inputs = req.get("inputs")
            if not isinstance(inputs, dict) or not inputs:
                raise ValueError('body needs {"inputs": {name: array}}')
            deadline_ms = req.get("deadline_ms")
            if deadline_ms is not None and not isinstance(
                    deadline_ms, (int, float)):
                raise ValueError("deadline_ms must be a number, got %r"
                                 % (deadline_ms,))
            cost_class = req.get("cost_class")
            if cost_class is not None and not isinstance(cost_class, str):
                raise ValueError("cost_class must be a string, got %r"
                                 % (cost_class,))
            request_id = self.headers.get("X-Request-Id") or None
            feed = {str(n): np.asarray(v) for n, v in inputs.items()}
            # a caller-supplied X-Trace-Id joins this request to the
            # caller's trace; without one each request is its own
            # trace. submit() captures the context, so the worker-side
            # dispatch span lands under it too.
            with _dtrace.child_span(
                    "serving.request", cat="serving",
                    trace_id=self.headers.get("X-Trace-Id") or None,
                    parent_span=self.headers.get("X-Parent-Span")
                    or None) as ctx:
                req_ctx = ctx
                outputs = engine.predict(feed, deadline_ms=deadline_ms,
                                         request_id=request_id,
                                         cost_class=cost_class)
        except ServerOverloaded as e:
            # RequestShed is a ServerOverloaded subtype: same 503 +
            # Retry-After back-off, but the typed name tells the
            # caller its COST CLASS was shed (a cheaper class may
            # still be admitted) rather than the hard queue bound hit
            self._reply_json(503, {"error": str(e),
                                   "type": type(e).__name__},
                             (("Retry-After", "1"),) + self._echo(req_ctx))
        except EngineStopped as e:
            self._reply_json(503, {"error": str(e),
                                   "type": "EngineStopped"},
                             self._echo(req_ctx))
        except DeadlineExpired as e:
            # typed 504: the deadline expired while the request was
            # QUEUED (it never reached the predictor) — the caller's
            # retry/hedge budget accounting needs to distinguish this
            # from a transport loss
            self._reply_json(504, {"error": str(e),
                                   "type": "DeadlineExpired"},
                             self._echo(req_ctx))
        except BatchExecutionError as e:
            # the MODEL failed on this batch: the engine is still
            # healthy (don't drain), the CLIENT isn't at fault (not a
            # 4xx) — a plain 500 with the typed name
            self._reply_json(500, {"error": str(e),
                                   "type": "BatchExecutionError"},
                             self._echo(req_ctx))
        except (ValueError, RequestTooLarge, json.JSONDecodeError) as e:
            self._reply_json(400, {"error": str(e)}, self._echo(req_ctx))
        except Exception as e:  # noqa: BLE001 — the model failed
            self._reply_json(500, {"error": "%s: %s"
                                   % (type(e).__name__, e)},
                             self._echo(req_ctx))
        else:
            self._reply_json(200, {
                "outputs": {n: np.asarray(v).tolist()
                            for n, v in outputs.items()},
                "latency_ms": (time.monotonic() - t0) * 1e3,
            }, self._echo(req_ctx))

    @staticmethod
    def _echo(req_ctx) -> Tuple:
        """The X-Trace-Id echo, on EVERY /predict reply — a failed
        request is the one the caller most needs to correlate with its
        distributed trace."""
        return (("X-Trace-Id", req_ctx.trace_id),) if req_ctx else ()

    # -- streaming decode ---------------------------------------------------

    def _do_generate(self):
        """``POST /generate``: chunked ndjson token stream.

        Body: ``{"prompt": [ids], "max_tokens": n, "cost_class": c,
        "deadline_ms": d, "resume_from": i}``; ``X-Request-Id`` makes
        the stream idempotent (a hedge/failover duplicate replays or
        attaches, and ``resume_from`` suppresses already-delivered
        token indices — the fleet's exactly-once resume contract).

        Reply: 200 + ``Transfer-Encoding: chunked``, one JSON object
        per line — ``{"type": "token", "index": i, "token": t}``
        events, then exactly one terminal
        ``{"type": "finish", "reason": ...}``. Admission failures
        reject BEFORE the stream starts, with the same typed status
        mapping as /predict; once streaming, failures arrive in-band
        as the finish event (the status line is already gone)."""
        engine = self.server.engine
        gen = getattr(engine, "generate", None)
        if gen is None:
            self._reply_json(
                501, {"error": "engine %s does not stream"
                      % type(engine).__name__,
                      "type": "NotStreaming"})
            return
        try:
            length = int(self.headers.get("Content-Length") or 0)
            req = json.loads(self.rfile.read(length) or b"{}")
            prompt = req.get("prompt")
            if not isinstance(prompt, list) or not prompt or \
                    not all(isinstance(t, int) for t in prompt):
                raise ValueError(
                    'body needs {"prompt": [token ids]}')
            deadline_ms = req.get("deadline_ms")
            if deadline_ms is not None and not isinstance(
                    deadline_ms, (int, float)):
                raise ValueError("deadline_ms must be a number, got %r"
                                 % (deadline_ms,))
            stream = gen(
                prompt,
                max_tokens=req.get("max_tokens"),
                request_id=self.headers.get("X-Request-Id") or None,
                cost_class=req.get("cost_class") or "high",
                deadline_s=(deadline_ms / 1e3
                            if deadline_ms is not None else None),
                resume_from=int(req.get("resume_from") or 0))
        except ServerOverloaded as e:
            self._reply_json(503, {"error": str(e),
                                   "type": type(e).__name__},
                             (("Retry-After", "1"),))
            return
        except EngineStopped as e:
            self._reply_json(503, {"error": str(e),
                                   "type": "EngineStopped"})
            return
        except (ValueError, RequestTooLarge,
                json.JSONDecodeError) as e:
            self._reply_json(400, {"error": str(e),
                                   "type": type(e).__name__})
            return
        except Exception as e:  # noqa: BLE001 — engine-side failure
            self._reply_json(500, {"error": "%s: %s"
                                   % (type(e).__name__, e)})
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        try:
            for ev in stream:
                self._write_chunk(json.dumps(ev).encode() + b"\n")
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError,
                ConnectionAbortedError):
            # client went away mid-stream (hedge loser, dead caller):
            # stop generating for it
            cancel = getattr(stream, "cancel", None)
            if callable(cancel):
                cancel()
            raise

    def _write_chunk(self, data: bytes) -> None:
        self.wfile.write(b"%x\r\n" % len(data))
        self.wfile.write(data)
        self.wfile.write(b"\r\n")
        self.wfile.flush()


def _json_safe(obj):
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, (np.integer, np.floating)):
        return obj.item()
    return obj


class ServingHTTPServer(ThreadingHTTPServer):
    """HTTP front of one ServingEngine (or a FleetRouter — anything
    with the ``predict``/``health``/``stats`` surface). ``port=0``
    binds an ephemeral port (tests); ``server.server_address`` reports
    the real one."""

    daemon_threads = True
    # a burst of concurrent clients (a load test, a fleet router's
    # streams) connects at once: past the stdlib's listen backlog of 5,
    # a connection waits for its SYN to be sent again
    request_queue_size = 1024

    def __init__(self, engine: ServingEngine, host: str = "127.0.0.1",
                 port: int = 8080):
        self.engine = engine
        super().__init__((host, port), _Handler)

    def handle_error(self, request, client_address):
        # a client hanging up mid-reply is NORMAL under a fleet: the
        # hedge winner cancels the loser by closing its socket, and a
        # deadline-expired caller walks away — neither deserves a
        # stack trace in the replica log
        import sys as _sys

        exc = _sys.exc_info()[1]
        if isinstance(exc, (ConnectionResetError, BrokenPipeError,
                            ConnectionAbortedError)):
            return
        super().handle_error(request, client_address)


def start_http_server(engine: ServingEngine, host: str = "127.0.0.1",
                      port: int = 0) -> Tuple[ServingHTTPServer,
                                              threading.Thread]:
    """Non-blocking: serve on a background thread (tests, embedding)."""
    server = ServingHTTPServer(engine, host, port)
    thread = threading.Thread(target=server.serve_forever,
                              name="serving-http", daemon=True)
    thread.start()
    return server, thread


def serve(engine: ServingEngine, host: str = "0.0.0.0",
          port: int = 8080) -> None:
    """Blocking entry point: start the engine, serve until interrupted,
    then drain. The accept loop runs on a background thread so that
    DURING the drain the server still answers — /healthz returns 503
    (the load-balancer back-off signal) while queued work finishes —
    and only then is the listening socket closed."""
    engine.start()
    server = ServingHTTPServer(engine, host, port)
    thread = threading.Thread(target=server.serve_forever,
                              name="serving-http", daemon=True)
    thread.start()
    try:
        while thread.is_alive():
            thread.join(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        engine.stop()       # drain: probes see 503, submits refused
        server.shutdown()
        server.server_close()
