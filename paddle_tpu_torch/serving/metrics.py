"""Serving metric names and their always-on recording helpers.

Counterpart of ``paddle_tpu/serving/metrics.py``. Serving records
unconditionally into the process registry (``observability.metrics()``),
so ``GET /metrics`` and ``observability.dump_prometheus()`` always see live
numbers: the module functions ``inc`` / ``observe`` / ``set_gauge`` /
``set_queue_depth`` / ``snapshot`` are the JAX package's, and the fleet
router records through them. Handles are fetched from the registry on
every write, so ``observability.reset()`` cannot leave a writer holding a
metric a dump no longer reads.

Each engine also keeps a view of its own (``EngineMetrics``): every write
goes to the process registry and to the engine's private registry, and
``stats()`` reads the private one, so two engines in one process (two
replicas on one card, say) still report their own counts.

The families are the JAX package's, plus ``serving.prefill_chunks``
(prompt chunks prefilled: with the decode steps it predicts the
paged-attention launches):

=================================  =======================================
``serving.requests``               counter: admitted requests
``serving.rejected``               counter: admission-control rejections
``serving.deadline_expired``       counter: dropped before dispatch
``serving.errors``                 counter: dispatch failures (per req)
``serving.batch_errors``           counter: predictor-failed batches
``serving.batches``                counter: dispatched micro-batches
``serving.padding_waste``          counter: padded rows (bucket - real)
``serving.batch_size``             histogram: real rows per micro-batch
``serving.queue_ms``               histogram: submit -> dispatch wait
``serving.total_ms``               histogram: submit -> result latency
``serving.queue_depth``            gauge: requests waiting right now
``serving.dedup_hits``             counter: idempotent request-id joins
``serving.shed{class=}``           counter: cost-class load sheds (fleet)
``serving.hedges``                 counter: hedged attempts launched
``serving.hedge_wasted``           counter: hedge losers (result discarded)
``serving.fleet_retries``          counter: re-dispatches after a failure
``serving.replica_ejections{cause=}``  counter: replicas pulled from
                                   rotation (dead | draining)
``serving.replica_rejoins``        counter: ejected replicas back serving
``serving.streams``                counter: accepted decode streams
``serving.ttft_ms``                histogram: submit -> first token
``serving.itl_ms``                 histogram: gap between emitted tokens
``serving.tokens``                 counter: decode tokens emitted
``serving.prefill_tokens``         counter: prompt tokens prefilled
``serving.prefill_chunks``         counter: prompt chunks prefilled
``serving.decode_steps``           counter: batched decode steps run
``serving.decode_batch``           histogram: real rows per decode step
``serving.kv_occupancy``           gauge: used / total KV-cache blocks
``serving.preemptions``            counter: sequences evicted under KV
                                   pressure (re-prefilled later)
``serving.stream_resumes``         counter: streams resumed from a token
                                   index > 0
``serving.stream_errors``          counter: streams finished by an error
=================================  =======================================
"""
from __future__ import annotations

from .. import observability as _obs
from ..observability.registry import MetricsRegistry

__all__ = [
    "REQUESTS", "REJECTED", "DEADLINE_EXPIRED", "ERRORS",
    "BATCH_ERRORS", "BATCHES", "PADDING_WASTE", "BATCH_SIZE",
    "QUEUE_MS", "TOTAL_MS", "QUEUE_DEPTH", "DEDUP_HITS",
    "SHED", "HEDGES", "HEDGE_WASTED", "FLEET_RETRIES",
    "REPLICA_EJECTIONS", "REPLICA_REJOINS",
    "STREAMS", "TTFT_MS", "ITL_MS", "TOKENS", "PREFILL_TOKENS",
    "PREFILL_CHUNKS", "DECODE_STEPS", "DECODE_BATCH", "KV_OCCUPANCY",
    "PREEMPTIONS", "STREAM_RESUMES", "STREAM_ERRORS",
    "inc", "observe", "set_gauge", "set_queue_depth", "snapshot",
    "EngineMetrics",
]

REQUESTS = "serving.requests"
REJECTED = "serving.rejected"
DEADLINE_EXPIRED = "serving.deadline_expired"
ERRORS = "serving.errors"
BATCH_ERRORS = "serving.batch_errors"
BATCHES = "serving.batches"
PADDING_WASTE = "serving.padding_waste"
BATCH_SIZE = "serving.batch_size"
QUEUE_MS = "serving.queue_ms"
TOTAL_MS = "serving.total_ms"
QUEUE_DEPTH = "serving.queue_depth"
DEDUP_HITS = "serving.dedup_hits"
SHED = "serving.shed"
HEDGES = "serving.hedges"
HEDGE_WASTED = "serving.hedge_wasted"
FLEET_RETRIES = "serving.fleet_retries"
REPLICA_EJECTIONS = "serving.replica_ejections"
REPLICA_REJOINS = "serving.replica_rejoins"
STREAMS = "serving.streams"
TTFT_MS = "serving.ttft_ms"
ITL_MS = "serving.itl_ms"
TOKENS = "serving.tokens"
PREFILL_TOKENS = "serving.prefill_tokens"
PREFILL_CHUNKS = "serving.prefill_chunks"
DECODE_STEPS = "serving.decode_steps"
DECODE_BATCH = "serving.decode_batch"
KV_OCCUPANCY = "serving.kv_occupancy"
PREEMPTIONS = "serving.preemptions"
STREAM_RESUMES = "serving.stream_resumes"
STREAM_ERRORS = "serving.stream_errors"

_COUNTERS = (REQUESTS, REJECTED, DEADLINE_EXPIRED, ERRORS, BATCH_ERRORS,
             BATCHES, PADDING_WASTE, DEDUP_HITS, HEDGES, HEDGE_WASTED,
             FLEET_RETRIES, REPLICA_REJOINS, STREAMS, TOKENS,
             PREFILL_TOKENS, PREFILL_CHUNKS, DECODE_STEPS, PREEMPTIONS,
             STREAM_RESUMES, STREAM_ERRORS)
_GAUGES = (QUEUE_DEPTH, KV_OCCUPANCY)
_HISTOGRAMS = (BATCH_SIZE, QUEUE_MS, TOTAL_MS, TTFT_MS, ITL_MS, DECODE_BATCH)


def inc(name: str, n: int = 1, **labels) -> None:
    _obs.counter(name, **labels).inc(n)


def observe(name: str, v) -> None:
    _obs.histogram(name).observe(v)


def set_gauge(name: str, v) -> None:
    _obs.gauge(name).set(v)


def set_queue_depth(n: int) -> None:
    _obs.gauge(QUEUE_DEPTH).set(n)


def _snapshot(reg: MetricsRegistry) -> dict:
    out = {name: reg.counter_value(name) for name in _COUNTERS}
    for name in _GAUGES:
        out[name] = reg.gauge_value(name)
    for name in _HISTOGRAMS:
        out[name] = reg.histogram(name).snapshot()
    return out


def snapshot() -> dict:
    """The serving counters, gauges and latency histograms of the process
    registry as a plain dict (the fleet router's ``stats()``)."""
    return _snapshot(_obs.metrics())


class EngineMetrics:
    """One engine's view: each write lands in the process registry and in
    this engine's own, which ``snapshot()`` (the engine's ``stats()``)
    reads."""

    def __init__(self):
        self._own = MetricsRegistry()

    def inc(self, name: str, n: int = 1) -> None:
        self._own.counter(name).inc(n)
        inc(name, n)

    def observe(self, name: str, v) -> None:
        self._own.histogram(name).observe(v)
        observe(name, v)

    def observe_many(self, name: str, vs) -> None:
        self._own.histogram(name).observe_many(vs)
        _obs.histogram(name).observe_many(vs)

    def set_gauge(self, name: str, v) -> None:
        self._own.gauge(name).set(v)
        set_gauge(name, v)

    def set_queue_depth(self, n: int) -> None:
        self.set_gauge(QUEUE_DEPTH, n)

    def snapshot(self) -> dict:
        return _snapshot(self._own)

    def samples(self, name: str) -> list:
        """This engine's values of histogram ``name`` (its reservoir): the
        real rows of each batch for ``serving.batch_size``, which the
        ``serving_ladder`` steerer fits a ladder to."""
        return self._own.histogram(name).samples()
