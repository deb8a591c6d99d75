"""Serving metrics: names, and a small registry of counters, gauges and
histograms.

The metric families are those of ``paddle_tpu/serving/metrics.py`` that the
one-shot engine and the decode engine record, plus
``serving.prefill_chunks`` (prompt chunks prefilled: with the decode steps
it predicts the paged-attention launches); the classes are a small copy of the
``Counter``/``Gauge``/``Histogram`` of ``paddle_tpu/observability/
registry.py`` (exact count/sum/min/max plus a bounded uniform reservoir
for percentiles). Each ``ServingEngine`` owns its own ``MetricsRegistry``,
so two engines in one process never mix their counts.
"""
from __future__ import annotations

import random
import threading
from typing import Dict, List, Optional

__all__ = ["REQUESTS", "REJECTED", "DEADLINE_EXPIRED", "ERRORS",
           "BATCH_ERRORS", "BATCHES", "PADDING_WASTE", "BATCH_SIZE",
           "QUEUE_MS", "TOTAL_MS", "QUEUE_DEPTH", "DEDUP_HITS",
           "STREAMS", "TTFT_MS", "ITL_MS", "TOKENS", "PREFILL_TOKENS",
           "PREFILL_CHUNKS", "DECODE_STEPS", "DECODE_BATCH", "KV_OCCUPANCY",
           "PREEMPTIONS", "STREAM_RESUMES", "STREAM_ERRORS", "Counter", "Gauge", "Histogram", "MetricsRegistry"]

REQUESTS = "serving.requests"                  # admitted requests
REJECTED = "serving.rejected"                  # admission-control rejections
DEADLINE_EXPIRED = "serving.deadline_expired"  # dropped before dispatch
ERRORS = "serving.errors"                      # failed requests
BATCH_ERRORS = "serving.batch_errors"          # predictor-failed batches
BATCHES = "serving.batches"                    # dispatched micro-batches
PADDING_WASTE = "serving.padding_waste"        # padded rows (bucket - real)
BATCH_SIZE = "serving.batch_size"              # real rows per micro-batch
QUEUE_MS = "serving.queue_ms"                  # submit -> dispatch wait
TOTAL_MS = "serving.total_ms"                  # submit -> result latency
QUEUE_DEPTH = "serving.queue_depth"            # requests waiting now
DEDUP_HITS = "serving.dedup_hits"              # idempotent request-id joins
# the decode engine's families
STREAMS = "serving.streams"                    # admitted decode streams
TTFT_MS = "serving.ttft_ms"                    # submit -> first token
ITL_MS = "serving.itl_ms"                      # gap between two tokens
TOKENS = "serving.tokens"                      # generated tokens
PREFILL_TOKENS = "serving.prefill_tokens"      # prompt tokens prefilled
PREFILL_CHUNKS = "serving.prefill_chunks"      # prompt chunks prefilled
DECODE_STEPS = "serving.decode_steps"          # batched decode steps
DECODE_BATCH = "serving.decode_batch"          # real rows per decode step
KV_OCCUPANCY = "serving.kv_occupancy"          # used share of the KV arena
PREEMPTIONS = "serving.preemptions"            # sequences evicted
STREAM_RESUMES = "serving.stream_resumes"      # submits with resume_from > 0
STREAM_ERRORS = "serving.stream_errors"        # streams ended by an error

_COUNTERS = (REQUESTS, REJECTED, DEADLINE_EXPIRED, ERRORS, BATCH_ERRORS,
             BATCHES, PADDING_WASTE, DEDUP_HITS, STREAMS, TOKENS,
             PREFILL_TOKENS, PREFILL_CHUNKS, DECODE_STEPS, PREEMPTIONS,
             STREAM_RESUMES, STREAM_ERRORS)
_GAUGES = (QUEUE_DEPTH, KV_OCCUPANCY)
_HISTOGRAMS = (BATCH_SIZE, QUEUE_MS, TOTAL_MS, TTFT_MS, ITL_MS, DECODE_BATCH)


def reservoir_quantile(sorted_vals, q: float):
    """Nearest-rank quantile over a sorted sequence, None when empty."""
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


class Counter:
    """Monotonically increasing count."""

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError("counter %r cannot decrease (n=%r)"
                             % (self.name, n))
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value


class Gauge:
    """Last-written value."""

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    @property
    def value(self):
        return self._value


class Histogram:
    """Exact count/sum/min/max and a bounded uniform reservoir."""

    RESERVOIR = 512

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._reservoir: List[float] = []
        self._rng = random.Random(0x5EED)
        self._lock = threading.Lock()

    def observe(self, v) -> None:
        self.observe_many((v,))

    def observe_many(self, vs) -> None:
        """Observe each of ``vs`` in turn, under one lock."""
        with self._lock:
            for v in vs:
                v = float(v)
                self.count += 1
                self.sum += v
                self.min = v if self.min is None else min(self.min, v)
                self.max = v if self.max is None else max(self.max, v)
                if len(self._reservoir) < self.RESERVOIR:
                    self._reservoir.append(v)
                else:
                    j = int(self._rng.random() * self.count)
                    if j < self.RESERVOIR:
                        self._reservoir[j] = v

    def snapshot(self) -> Dict:
        with self._lock:
            s = sorted(self._reservoir)
            out = {"count": self.count, "sum": self.sum, "min": self.min,
                   "max": self.max,
                   "mean": (self.sum / self.count) if self.count else None}
        for q, tag in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
            out[tag] = reservoir_quantile(s, q)
        return out


class MetricsRegistry:
    """Get-or-create store of named metrics, thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get(self, cls, name: str):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name)
        if not isinstance(m, cls):
            raise TypeError("metric %r is a %s, not a %s"
                            % (name, type(m).__name__, cls.__name__))
        return m

    def counter(self, name: str) -> Counter:
        return self._get(Counter, name)

    def gauge(self, name: str) -> Gauge:
        return self._get(Gauge, name)

    def histogram(self, name: str) -> Histogram:
        return self._get(Histogram, name)

    def inc(self, name: str, n: int = 1) -> None:
        self.counter(name).inc(n)

    def observe(self, name: str, v) -> None:
        self.histogram(name).observe(v)

    def set_gauge(self, name: str, v) -> None:
        self.gauge(name).set(v)

    def set_queue_depth(self, n: int) -> None:
        self.set_gauge(QUEUE_DEPTH, n)

    def snapshot(self) -> Dict:
        """The serving counters, gauges and latency histograms as a plain
        dict (the ``stats()`` payload of either engine)."""
        out = {name: self.counter(name).value for name in _COUNTERS}
        for name in _GAUGES:
            out[name] = self.gauge(name).value
        for name in _HISTOGRAMS:
            out[name] = self.histogram(name).snapshot()
        return out
