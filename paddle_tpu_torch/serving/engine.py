"""ServingEngine: worker threads + admission control over one predictor.

Counterpart of ``paddle_tpu/serving/engine.py`` (the one-shot engine). N
worker threads pull micro-batches off a shared ``DynamicBatcher`` and push
them through ONE shared predictor, whose run lock serializes the device
dispatch; while one batch runs on the card the next is being assembled on
another thread. What the bare predictor lacks:

- **admission control**: a bounded queue; a full queue rejects at submit
  with ``ServerOverloaded``;
- **deadlines**: a request past its deadline is dropped when its batch
  forms, before a dispatch is spent on it;
- **warmup**: ``start()`` runs each ladder bucket, on zero feeds derived
  from the program's feed vars, as often as the predictor needs before it
  replays (``warmup_runs``: on the card the eager run and the capture of
  the bucket's CUDA graph), so that traffic captures nothing;
- **graceful drain**: ``stop()`` refuses new work, finishes what is
  queued, then joins the workers;
- **lifecycle**: ``health()`` is ``starting | warming | serving |
  draining | stopped``, and ``health_doc()`` is the ``/healthz`` body
  (``engine_kind`` ``oneshot``, the queue depth);
- **idempotent request ids**: a duplicate of a pending or recently
  finished id joins the original's future;
- **trace context**: ``submit`` captures the caller's
  ``observability.distributed.current()`` (the HTTP front sets it a
  request), and the worker records a ``serving.dispatch`` span under it
  once the batch has run; ``cost_class`` is accepted, as the fleet
  router sends it, and ignored (one engine has no priority lanes).

Metrics record into the process registry and the engine's own view
(``metrics.EngineMetrics``); ``stats()`` reads the engine's.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from concurrent.futures import Future, InvalidStateError
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..observability import distributed as _dtrace
from . import metrics as _m
from .batcher import BatchPolicy, DynamicBatcher, PendingRequest

__all__ = ["ServingConfig", "ServingEngine", "ServingError",
           "ServerOverloaded", "DeadlineExpired", "EngineStopped",
           "RequestTooLarge", "BatchExecutionError"]


class ServingError(RuntimeError):
    """Base of all typed serving failures."""


class ServerOverloaded(ServingError):
    """Admission control: the pending queue is full."""


class DeadlineExpired(ServingError):
    """The request's deadline passed while it waited in the queue."""


class EngineStopped(ServingError):
    """submit() after stop() (or before start())."""


class RequestTooLarge(ServingError):
    """A single request's rows exceed max_batch_size."""


class BatchExecutionError(ServingError):
    """The predictor failed inside a batch dispatch: exactly the
    co-batched requests fail, with the original exception as
    ``__cause__``, and the engine keeps serving."""


class ServingConfig:
    """Engine knobs. ``ladder=None`` -> powers of two up to
    ``max_batch_size``; ``max_queue`` bounds pending requests;
    ``default_deadline_ms=None`` -> requests never expire."""

    def __init__(self, max_batch_size: int = 8,
                 batch_timeout_ms: float = 2.0,
                 ladder: Optional[Sequence[int]] = None,
                 max_queue: int = 64, num_workers: int = 2,
                 default_deadline_ms: Optional[float] = None,
                 warmup: bool = True, request_id_cache: int = 1024):
        self.policy = BatchPolicy(max_batch_size, batch_timeout_ms, ladder)
        self.max_queue = int(max_queue)
        self.num_workers = int(num_workers)
        if self.num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        self.default_deadline_ms = default_deadline_ms
        self.warmup = bool(warmup)
        self.request_id_cache = int(request_id_cache)


class ServingEngine:
    """Dynamic-batching front of a shared predictor.

    ``predictor`` needs ``run(dict) -> [PaddleTensor]`` (thread-safe) and
    ``get_input_names()``. ``sample_feed`` (name -> single-row array) is
    the warmup template; by default it is derived from the predictor
    program's feed vars (batch dim 1, zeros)."""

    _POLL_S = 0.05

    def __init__(self, predictor, config: Optional[ServingConfig] = None,
                 sample_feed: Optional[Dict[str, np.ndarray]] = None):
        self.config = config or ServingConfig()
        self.metrics = _m.EngineMetrics()
        self._predictor = predictor
        self._input_names = list(predictor.get_input_names())
        self._batcher = DynamicBatcher(self.config.policy,
                                       self.config.max_queue, self.metrics)
        self._spec = ({n: np.asarray(v) for n, v in sample_feed.items()}
                      if sample_feed else self._derive_sample_feed())
        self._workers: List[threading.Thread] = []
        self._state_lock = threading.Lock()
        self._started = False
        self._warming = False
        self._stopping = False
        self._abort = False
        self._stopped = False
        self.warmed_buckets: tuple = ()
        self._ids: "OrderedDict[str, Future]" = OrderedDict()
        self._ids_lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ServingEngine":
        with self._state_lock:
            if self._stopping or self._stopped:
                raise EngineStopped("engine cannot be restarted")
            if self._started:
                return self
            # verify the program this engine is about to serve
            # (PADDLE_TPU_VERIFY_IR), before any worker thread exists
            prog = getattr(self._predictor, "_program", None)
            if prog is not None:
                from ..analysis import maybe_verify_program

                fetch = [v.name for v in getattr(
                    self._predictor, "_fetch_vars", None) or []]
                maybe_verify_program(prog, where="serving.engine",
                                     fetch_names=fetch or None)
            if self.config.warmup:
                self._warming = True
                try:
                    self._warmup()
                finally:
                    self._warming = False
            for i in range(self.config.num_workers):
                t = threading.Thread(target=self._worker_loop,
                                     name="serving-worker-%d" % i,
                                     daemon=True)
                t.start()
                self._workers.append(t)
            self._started = True
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Refuse new submits; with ``drain`` finish queued work first,
        else fail queued requests with EngineStopped; join workers."""
        with self._state_lock:
            if self._stopped or not self._started:
                self._stopped = True
                self._stopping = True
                self._batcher.close()
                return
            self._stopping = True
        end = time.monotonic() + timeout
        if not drain:
            self._abort = True
        else:
            while not self._batcher.empty() and time.monotonic() < end:
                time.sleep(self._POLL_S / 5)
        self._batcher.close()
        for t in self._workers:
            t.join(max(0.0, end - time.monotonic()))
        while True:
            batch = self._batcher.next_batch(poll_timeout=0)
            if not batch:
                break
            for p in batch:
                self._fail(p, EngineStopped("engine stopped"))
        with self._state_lock:
            self._stopped = True

    @property
    def running(self) -> bool:
        return self._started and not self._stopping

    def health(self) -> str:
        if self._stopping or self._stopped:
            return "stopped" if self._stopped else "draining"
        if self.running:
            return "serving"
        if self._warming:
            return "warming"
        return "starting"

    def health_doc(self) -> Dict:
        """The ``/healthz`` body: ``engine_kind`` tells a prober a
        one-shot replica from a decode one."""
        return {"status": self.health(), "engine_kind": "oneshot",
                "queue_depth": self._batcher.depth()}

    # -- request path ------------------------------------------------------

    def _join_duplicate(self, request_id: str) -> Optional[Future]:
        """The original future of a known request id (LRU touch), or
        None; callers hold ``_ids_lock``."""
        f = self._ids.get(request_id)
        if f is not None:
            self._ids.move_to_end(request_id)
            self.metrics.inc(_m.DEDUP_HITS)
        return f

    def submit(self, feed: Dict[str, np.ndarray],
               deadline_ms: Optional[float] = None,
               request_id: Optional[str] = None,
               cost_class: Optional[str] = None) -> Future:
        """Queue one request (arrays WITH leading batch axis). Returns a
        Future resolving to a dict name -> ndarray of its rows.
        ``cost_class`` is accepted for the fleet router's sake and
        ignored."""
        del cost_class  # one engine: no shed lanes
        if not self._started or self._stopping:
            raise EngineStopped("engine is not accepting requests")
        rid = None
        if request_id is not None and self.config.request_id_cache > 0:
            rid = str(request_id)
            with self._ids_lock:
                f = self._join_duplicate(rid)
            if f is not None:
                return f
        feed, rows = self._validate(feed)
        if rows > self.config.policy.max_batch_size:
            raise RequestTooLarge("request has %d rows > max_batch_size %d"
                                  % (rows,
                                     self.config.policy.max_batch_size))
        if deadline_ms is None:
            deadline_ms = self.config.default_deadline_ms
        deadline = (time.monotonic() + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        pending = PendingRequest(feed, rows, deadline,
                                 trace_ctx=_dtrace.current())
        if rid is not None:
            # register before the enqueue: of two racing duplicates the
            # loser must find the winner's future
            with self._ids_lock:
                f = self._join_duplicate(rid)
                if f is not None:
                    return f
                self._ids[rid] = pending.future
                while len(self._ids) > self.config.request_id_cache:
                    self._ids.popitem(last=False)
        if not self._batcher.try_put(pending):
            exc = (EngineStopped("engine is not accepting requests")
                   if self._stopping else ServerOverloaded(
                       "pending queue full (%d requests); retry later"
                       % self.config.max_queue))
            if rid is not None:
                # a duplicate may already hold this future: resolve it
                with self._ids_lock:
                    self._ids.pop(rid, None)
                self._fail(pending, exc)
            if not self._stopping:
                self.metrics.inc(_m.REJECTED)
            raise exc
        self.metrics.inc(_m.REQUESTS)
        return pending.future

    def predict(self, feed: Dict[str, np.ndarray],
                deadline_ms: Optional[float] = None,
                timeout: Optional[float] = None,
                request_id: Optional[str] = None,
                cost_class: Optional[str] = None) -> Dict[str, np.ndarray]:
        """Blocking submit().result()."""
        return self.submit(feed, deadline_ms, request_id=request_id,
                           cost_class=cost_class).result(timeout)

    def stats(self) -> Dict:
        out = self.metrics.snapshot()
        out["queue_depth"] = self._batcher.depth()
        out["warmed_buckets"] = list(self.warmed_buckets)
        out["running"] = self.running
        out["state"] = self.health()
        return out

    # -- internals ---------------------------------------------------------

    def _validate(self, feed):
        if not isinstance(feed, dict):
            raise ValueError("feed must be a dict name -> ndarray")
        missing = [n for n in self._input_names if n not in feed]
        extra = [n for n in feed if n not in self._input_names]
        if missing or extra:
            raise ValueError(
                "feed names mismatch: missing=%s unexpected=%s (inputs: %s)"
                % (missing, extra, self._input_names))
        arrs = {n: np.asarray(feed[n]) for n in self._input_names}
        rows = {n: (a.shape[0] if a.ndim else -1) for n, a in arrs.items()}
        distinct = set(rows.values())
        if len(distinct) != 1 or -1 in distinct:
            raise ValueError("every input needs the same leading batch "
                             "axis, got %s" % rows)
        n_rows = distinct.pop()
        if n_rows < 1:
            raise ValueError("request has no rows (leading axis is 0)")
        if self._spec:
            for n, a in arrs.items():
                tmpl = self._spec.get(n)
                if tmpl is None:
                    continue
                if tuple(a.shape[1:]) != tuple(tmpl.shape[1:]):
                    raise ValueError(
                        "input %r rows have shape %s, model expects %s"
                        % (n, tuple(a.shape[1:]), tuple(tmpl.shape[1:])))
                if a.dtype != tmpl.dtype:
                    arrs[n] = a.astype(tmpl.dtype)
        return arrs, n_rows

    def _warmup(self) -> None:
        """Each ladder bucket, ``warmup_runs`` dispatches, before traffic
        arrives."""
        if self._spec is None:
            return
        runs = getattr(self._predictor, "warmup_runs", 1)
        warmed = []
        for bucket in self.config.policy.ladder:
            feed = {n: np.broadcast_to(
                        v, (bucket,) + tuple(v.shape[1:])).copy()
                    for n, v in self._spec.items()}
            for _ in range(runs):
                self._predictor.run(feed)
            warmed.append(bucket)
        self.warmed_buckets = tuple(warmed)

    def _derive_sample_feed(self) -> Optional[Dict[str, np.ndarray]]:
        """Zero single-row feeds from the program's feed-var shapes and
        dtypes; None without a program or with an unknown non-batch dim."""
        program = getattr(self._predictor, "_program", None)
        if program is None:
            return None
        block = program.global_block()
        sample = {}
        for name in self._input_names:
            v = block._find_var_recursive(name)
            if v is None or v.shape is None:
                return None
            tail = list(v.shape)[1:]
            if any(s is None or int(s) < 0 for s in tail):
                return None
            sample[name] = np.zeros([1] + [int(s) for s in tail],
                                    np.dtype(v.dtype))
        return sample

    def _worker_loop(self) -> None:
        while True:
            batch = self._batcher.next_batch(self._POLL_S)
            if not batch:
                if self._stopping and self._batcher.empty():
                    return
                continue
            if self._abort:
                for p in batch:
                    self._fail(p, EngineStopped("engine stopped"))
                continue
            self._dispatch(batch)

    def _dispatch(self, batch: List[PendingRequest]) -> None:
        now = time.monotonic()
        t0_perf = time.perf_counter()
        live = []
        for p in batch:
            if p.deadline is not None and now > p.deadline:
                self.metrics.inc(_m.DEADLINE_EXPIRED)
                self._fail(p, DeadlineExpired(
                    "deadline passed %.1f ms ago while queued"
                    % ((now - p.deadline) * 1e3)))
            else:
                live.append(p)
        if not live:
            return
        try:
            feed, slices, bucket, pad = self._batcher.assemble(live)
        except Exception as e:  # noqa: BLE001 — fail this batch only
            self.metrics.inc(_m.ERRORS, len(live))
            for p in live:
                self._fail(p, e)
            return
        self.metrics.inc(_m.BATCHES)
        self.metrics.observe(_m.BATCH_SIZE, bucket - pad)
        if pad:
            self.metrics.inc(_m.PADDING_WASTE, pad)
        for p in live:
            self.metrics.observe(_m.QUEUE_MS, (now - p.t_enqueue) * 1e3)
        try:
            outs = self._predictor.run(feed)
            outputs = {t.name: np.asarray(t.data) for t in outs}
            results = self._batcher.split_outputs(outputs, slices, bucket)
        except Exception as e:  # noqa: BLE001 — the batch fails as a
            # unit with a typed error; the worker survives
            self.metrics.inc(_m.ERRORS, len(live))
            self.metrics.inc(_m.BATCH_ERRORS)
            err = BatchExecutionError(
                "batch dispatch failed (%d request(s), bucket %d): %s: %s"
                % (len(live), bucket, type(e).__name__, e))
            err.__cause__ = e
            for p in live:
                self._fail(p, err)
            return
        done = time.monotonic()
        for p in live:
            # one span a co-batched request, under its own trace
            if p.trace_ctx is not None:
                _dtrace.record_span("serving.dispatch", t0_perf,
                                    cat="serving", ctx=p.trace_ctx,
                                    bucket=bucket, rows=p.rows)
        for p, result in zip(live, results):
            self.metrics.observe(_m.TOTAL_MS, (done - p.t_enqueue) * 1e3)
            try:
                p.future.set_result(result)
            except InvalidStateError:
                pass  # the caller cancelled; the result goes nowhere

    @staticmethod
    def _fail(p: PendingRequest, exc: Exception) -> None:
        try:
            p.future.set_exception(exc)
        except InvalidStateError:
            pass  # cancelled, or already resolved
