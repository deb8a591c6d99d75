"""Observability of the port: the process-wide metrics registry, the host
span buffer, trace-context propagation and the flight recorder.

Counterpart of ``paddle_tpu/observability/__init__.py:139-280``. The
registry is one ``MetricsRegistry`` a process; ``dump()`` /
``dump_prometheus()`` export it (``GET /metrics`` serves the Prometheus
text). The ``serving.*`` families (``serving/metrics.py``), the fleet's,
``fault.injected{side=,kind=}`` and ``checkpoint.*`` record
unconditionally through the direct handles (``counter`` / ``gauge`` /
``histogram``); ``inc`` / ``set_gauge`` / ``observe`` record only while
the layer is armed, as the JAX package's instrumentation sites do.

Arming: ``enable()`` / ``disable()``, the ``FLAGS_tpu_metrics`` flag
(``fluid.set_flags``) or ``PADDLE_TPU_METRICS=1`` in the environment.
Armed, the span buffer (``tracing``) records too: the HTTP front's
``serving.request`` spans and the engine's ``serving.dispatch`` spans
under their propagated trace ids (``distributed``).

Submodules: ``registry``, ``tracing`` (the span buffer, the
``fluid.profiler`` sessions, the chrome trace), ``distributed`` (trace
context and the per-process dumper), ``flight`` (the bounded ring of
recent events), ``profiler`` (the step profiler, FLOPs and the session
API), ``device_trace`` (a ``torch.profiler`` trace folded into phases),
``capture`` (``PADDLE_TPU_SAMPLE_EVERY``), ``spool`` (the span spool) and
``timeseries`` (windowed series). A set ``PADDLE_TPU_METRICS_DIR`` arms
the layer and the dumper. The JAX package's job-level merge and steering
stay there for now (ROADMAP.md).
"""
from __future__ import annotations

import os
import sys

from . import distributed, flight, spool, timeseries, tracing  # noqa: F401
from . import capture, device_trace, profiler  # noqa: F401
from .registry import Counter, Gauge, Histogram, MetricsRegistry  # noqa: F401
from .tracing import span  # noqa: F401

__all__ = ["enable", "disable", "enabled", "metrics", "counter", "gauge",
           "histogram", "inc", "set_gauge", "observe", "counter_value",
           "gauge_value", "span", "dump", "dump_prometheus",
           "chrome_trace", "write_chrome_trace", "reset",
           "MetricsRegistry", "Counter", "Gauge", "Histogram",
           "flight", "distributed", "tracing", "profiler", "spool",
           "timeseries", "capture", "device_trace"]

_registry = MetricsRegistry()
_enabled = False


def enabled() -> bool:
    return _enabled


def _sync_flag(on: bool) -> None:
    """Keep ``FLAGS_tpu_metrics`` truthful when ``enable()`` /
    ``disable()`` is called directly, without importing the flag module
    early."""
    fl = sys.modules.get(__package__.rsplit(".", 1)[0] + ".core.flags")
    if fl is not None:
        fl._values["FLAGS_tpu_metrics"] = bool(on)


def enable() -> None:
    global _enabled
    _enabled = True
    tracing._set_metrics_on(True)
    _sync_flag(True)


def disable() -> None:
    global _enabled
    _enabled = False
    tracing._set_metrics_on(False)
    _sync_flag(False)


def metrics() -> MetricsRegistry:
    return _registry


# -- direct handles: they create and record whether or not the layer is
# armed (the always-on families use these) ----------------------------------

def counter(name: str, **labels) -> Counter:
    return _registry.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return _registry.gauge(name, **labels)


def histogram(name: str, **labels) -> Histogram:
    return _registry.histogram(name, **labels)


# -- guarded one-shot helpers: no-ops while the layer is disarmed -----------

def inc(name: str, n: int = 1, **labels) -> None:
    if _enabled:
        _registry.counter(name, **labels).inc(n)


def set_gauge(name: str, v, **labels) -> None:
    if _enabled:
        _registry.gauge(name, **labels).set(v)


def observe(name: str, v, **labels) -> None:
    if _enabled:
        _registry.histogram(name, **labels).observe(v)


def counter_value(name: str, **labels):
    return _registry.counter_value(name, **labels)


def gauge_value(name: str, **labels):
    return _registry.gauge_value(name, **labels)


# -- export ------------------------------------------------------------------

def dump(fmt: str = "json") -> object:
    """Snapshot of every metric: a JSON-able dict (``fmt="json"``) or the
    Prometheus text exposition format (``fmt="prometheus"``)."""
    if fmt == "prometheus":
        return _registry.to_prometheus()
    if fmt != "json":
        raise ValueError("unknown dump format %r" % fmt)
    out = _registry.snapshot()
    out["spans"] = tracing.stats()
    out["enabled"] = _enabled
    return out


def dump_prometheus() -> str:
    return dump(fmt="prometheus")


def _profiler_events():
    """The last finished ``fluid.profiler`` session's events (a live
    session's spans are in the buffer already)."""
    if tracing.profiler_session_active():
        return []
    return profiler.get_trace_events()


def chrome_trace() -> dict:
    """Perfetto-loadable ``trace_event`` JSON of the span buffer and the
    last ``fluid.profiler`` session."""
    return tracing.chrome_trace(extra_events=_profiler_events())


def write_chrome_trace(path: str) -> str:
    return tracing.write_chrome_trace(path, extra_events=_profiler_events())


def reset() -> None:
    """Clear every metric, buffered span and the last profiler session's
    snapshot (the armed state is kept)."""
    _registry.reset()
    tracing.clear()
    del profiler._last_trace[:]


def _init_from_env() -> None:
    raw = os.environ.get("FLAGS_tpu_metrics")
    if raw is None:
        raw = os.environ.get("PADDLE_TPU_METRICS", "")
    if raw.lower() in ("1", "true", "yes", "on"):
        enable()
    if distributed.metrics_dir() is not None:
        enable()
        distributed.arm_from_env()


_init_from_env()
