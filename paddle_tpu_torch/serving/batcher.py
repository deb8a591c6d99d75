"""Dynamic micro-batching: request queue + shape-bucketed assembly.

Counterpart of ``paddle_tpu/serving/batcher.py``. Requests queue as
futures; a short window (``batch_timeout_ms``) collects concurrent
arrivals into one feed, padded up to a fixed ladder of batch sizes
(powers of two up to ``max_batch_size`` by default). On the card a fixed
ladder bounds the set of shapes the kernels see, which warmup covers
before traffic arrives; results are sliced back per request so callers
never see the padding. ``plan_ladder`` fits a ladder to observed
real-rows-per-batch; the ``serving_ladder`` steerer calls it with the rows
a replica's traffic gave its batches.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .metrics import EngineMetrics

__all__ = ["BatchPolicy", "DynamicBatcher", "PendingRequest",
           "default_ladder", "pick_bucket", "plan_ladder"]


def default_ladder(max_batch_size: int) -> Tuple[int, ...]:
    """Powers of two up to ``max_batch_size``, plus the max itself."""
    if max_batch_size < 1:
        raise ValueError("max_batch_size must be >= 1, got %r"
                         % max_batch_size)
    ladder = []
    b = 1
    while b < max_batch_size:
        ladder.append(b)
        b *= 2
    ladder.append(max_batch_size)
    return tuple(ladder)


def pick_bucket(ladder: Sequence[int], rows: int) -> int:
    """Smallest ladder entry >= rows."""
    for b in ladder:
        if b >= rows:
            return b
    raise ValueError("rows=%d exceeds ladder max %d" % (rows, ladder[-1]))


class BatchPolicy:
    """Size cap, collection window and bucket ladder of micro-batches."""

    def __init__(self, max_batch_size: int = 8,
                 batch_timeout_ms: float = 2.0,
                 ladder: Optional[Sequence[int]] = None):
        self.max_batch_size = int(max_batch_size)
        if self.max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        self.batch_timeout_ms = float(batch_timeout_ms)
        if self.batch_timeout_ms < 0:
            raise ValueError("batch_timeout_ms must be >= 0")
        if ladder is None:
            self.ladder = default_ladder(self.max_batch_size)
        else:
            self.ladder = tuple(sorted(set(int(b) for b in ladder)))
            if not self.ladder or self.ladder[0] < 1:
                raise ValueError("ladder entries must be >= 1: %r"
                                 % (ladder,))
            if self.ladder[-1] != self.max_batch_size:
                raise ValueError(
                    "ladder max %d != max_batch_size %d"
                    % (self.ladder[-1], self.max_batch_size))

    def __repr__(self):
        return ("BatchPolicy(max_batch_size=%d, batch_timeout_ms=%g, "
                "ladder=%r)" % (self.max_batch_size, self.batch_timeout_ms,
                                self.ladder))


class PendingRequest:
    """One queued request: feed, row count, future, deadline, enqueue
    time, and the submitter's trace context (``trace_ctx``), which the
    dispatching worker thread cannot read from the submitter's thread."""

    __slots__ = ("feed", "rows", "future", "deadline", "t_enqueue",
                 "trace_ctx")

    def __init__(self, feed: Dict[str, np.ndarray], rows: int,
                 deadline: Optional[float] = None, trace_ctx=None):
        self.feed = feed
        self.rows = int(rows)
        self.future: Future = Future()
        self.deadline = deadline          # time.monotonic() timestamp
        self.t_enqueue = time.monotonic()
        self.trace_ctx = trace_ctx


class DynamicBatcher:
    """Bounded FIFO of PendingRequests + batch formation + padding.

    Any number of producer threads (``try_put``) and consumer workers
    (``next_batch``). A request is never split across batches."""

    def __init__(self, policy: BatchPolicy, max_queue: int = 64,
                 metrics: Optional[EngineMetrics] = None):
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        self.policy = policy
        self.max_queue = int(max_queue)
        self.metrics = metrics if metrics is not None else EngineMetrics()
        self._queue: "deque[PendingRequest]" = deque()
        self._cond = threading.Condition()
        self._closed = False

    def try_put(self, pending: PendingRequest) -> bool:
        """Enqueue, or return False when the queue is full or closed."""
        if pending.rows > self.policy.max_batch_size:
            raise ValueError("request rows=%d exceed max_batch_size=%d"
                             % (pending.rows, self.policy.max_batch_size))
        with self._cond:
            if self._closed or len(self._queue) >= self.max_queue:
                return False
            self._queue.append(pending)
            self.metrics.set_queue_depth(len(self._queue))
            self._cond.notify()
            return True

    def depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def empty(self) -> bool:
        return self.depth() == 0

    def close(self) -> None:
        """Wake all waiting workers; later try_put is refused."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def next_batch(self, poll_timeout: float = 0.1
                   ) -> Optional[List[PendingRequest]]:
        """Wait up to ``poll_timeout`` for a first request, then hold the
        batch open ``batch_timeout_ms`` (or until ``max_batch_size`` rows)
        for more. Returns None on an idle poll."""
        cap = self.policy.max_batch_size
        with self._cond:
            if not self._queue and not self._closed:
                self._cond.wait(poll_timeout)
            if not self._queue:
                return None
            batch: List[PendingRequest] = []
            rows = 0
            window_end = (time.monotonic()
                          + self.policy.batch_timeout_ms / 1e3)
            while True:
                while self._queue and rows + self._queue[0].rows <= cap:
                    p = self._queue.popleft()
                    batch.append(p)
                    rows += p.rows
                if rows >= cap or self._queue:
                    break
                remaining = window_end - time.monotonic()
                if remaining <= 0 or self._closed:
                    break
                self._cond.wait(remaining)
            self.metrics.set_queue_depth(len(self._queue))
            if self._queue:
                self._cond.notify()  # leftover work for another worker
        return batch

    def assemble(self, batch: Sequence[PendingRequest]
                 ) -> Tuple[Dict[str, np.ndarray], List[Tuple[int, int]],
                            int, int]:
        """Concatenate the batch's feeds along axis 0 and pad with zero
        rows to the bucket size. Returns (feed, [(offset, rows)] per
        request, bucket, padded_rows)."""
        rows = sum(p.rows for p in batch)
        bucket = pick_bucket(self.policy.ladder, rows)
        pad = bucket - rows
        feed: Dict[str, np.ndarray] = {}
        for name in batch[0].feed:
            parts = [np.asarray(p.feed[name]) for p in batch]
            if pad:
                parts.append(np.zeros((pad,) + parts[0].shape[1:],
                                      parts[0].dtype))
            feed[name] = parts[0] if len(parts) == 1 else np.concatenate(
                parts, 0)
        slices = []
        off = 0
        for p in batch:
            slices.append((off, p.rows))
            off += p.rows
        return feed, slices, bucket, pad

    @staticmethod
    def split_outputs(outputs: Dict[str, np.ndarray],
                      slices: Sequence[Tuple[int, int]],
                      batch_rows: int) -> List[Dict[str, np.ndarray]]:
        """Per-request output dicts sliced off each output's leading axis.
        Every output must be batch-major over ``batch_rows``."""
        arrs = {}
        for name, arr in outputs.items():
            arr = np.asarray(arr)
            if arr.ndim == 0 or arr.shape[0] != batch_rows:
                raise ValueError(
                    "output %r has shape %s, not batch-major over the %d "
                    "dispatched rows; fetch per-row outputs when serving"
                    % (name, arr.shape, batch_rows))
            arrs[name] = arr
        return [{name: arr[off:off + rows] for name, arr in arrs.items()}
                for off, rows in slices]


def plan_ladder(max_batch_size: int, batch_rows: Sequence[int],
                max_rungs: int = 6) -> Tuple[int, ...]:
    """A bucket ladder fitted to observed real-rows-per-batch: distinct
    quantile rungs (p25/p50/p75/p90/max observed) plus the
    ``max_batch_size`` cap, validated as ``BatchPolicy`` validates a
    ladder; ``default_ladder`` when no usable observation exists. Fewer,
    better-placed rungs pad less while the set of shapes (and of captured
    graphs) stays ``len(ladder)``."""
    if max_batch_size < 1:
        raise ValueError("max_batch_size must be >= 1, got %r"
                         % max_batch_size)
    rows = sorted(min(max_batch_size, max(1, int(r)))
                  for r in batch_rows
                  if isinstance(r, (int, float)) and r > 0)
    if not rows:
        return default_ladder(max_batch_size)
    rungs = {max_batch_size}
    for q in (0.25, 0.5, 0.75, 0.9, 1.0):
        # ceil-style index: the rung must cover the quantile's batches
        rungs.add(rows[min(len(rows) - 1,
                           int(np.ceil(q * (len(rows) - 1))))])
    ladder = tuple(sorted(rungs))
    if len(ladder) > max_rungs:
        # keep the cap and the largest rungs
        ladder = ladder[-max_rungs:]
        if ladder[-1] != max_batch_size:
            ladder = tuple(sorted(set(ladder) | {max_batch_size}))
    BatchPolicy(max_batch_size=max_batch_size, ladder=ladder)  # validate
    return ladder


def _steer_serving_ladder(report, max_batch_size=None,
                          batch_rows=None, max_rungs=6, **_ctx):
    """``steer("serving_ladder", report, max_batch_size=...,
    batch_rows=...)``: the report may be None (this steerer reads live
    traffic, not a step profile). The plan is the ladder tuple, which
    ``BatchPolicy(ladder=...)`` applies."""
    if max_batch_size is None:
        raise ValueError("serving_ladder steerer needs "
                         "max_batch_size=<cap> in context")
    if not batch_rows:
        raise ValueError("serving_ladder steerer needs "
                         "batch_rows=<observed real rows per batch>")
    return plan_ladder(int(max_batch_size), batch_rows,
                       max_rungs=int(max_rungs))


from ..observability import steering as _steering  # noqa: E402

_steering.register_steerer(
    "serving_ladder", _steer_serving_ladder,
    "bucket ladder replanned from the rows of observed batches")
