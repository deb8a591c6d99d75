"""Process-wide metrics registry: counters, gauges, histograms.

Counterpart of ``paddle_tpu/observability/registry.py`` (standard library
only, so the port keeps its own copy). One thread-safe registry that the
serving layer, the fleet router, the fault injector and the checkpoint
code report into; ``observability.dump_prometheus()`` exports it, and the
HTTP front's ``GET /metrics`` serves that text.

Metrics are identified by (name, labels). Histograms keep exact
count/sum/min/max plus a bounded uniform reservoir (cap
``Histogram.RESERVOIR``) for percentile estimates, so memory stays O(1) a
metric however many observations arrive. ``Histogram.observe_many``
records several values under one lock (the decode engine's per-step
token latencies).
"""
from __future__ import annotations

import random
import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "reservoir_quantile"]


def reservoir_quantile(sorted_vals, q: float):
    """Nearest-rank quantile over an already-sorted sequence, None when
    empty."""
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]

LabelsT = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Dict) -> LabelsT:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _qualified(name: str, labels: LabelsT) -> str:
    if not labels:
        return name
    return "%s{%s}" % (name, ",".join("%s=%s" % kv for kv in labels))


class _Metric:
    __slots__ = ("name", "labels", "_lock")

    kind = "metric"

    def __init__(self, name: str, labels: LabelsT):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()

    @property
    def qualified_name(self) -> str:
        return _qualified(self.name, self.labels)


class Counter(_Metric):
    """Monotonically increasing count (steps run, flushes, declines)."""

    __slots__ = ("_value",)

    kind = "counter"

    def __init__(self, name, labels):
        super().__init__(name, labels)
        self._value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError("counter %r cannot decrease (n=%r)"
                             % (self.name, n))
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value

    def snapshot(self):
        return self._value


class Gauge(_Metric):
    """Last-written value (live bytes, bubble fraction)."""

    __slots__ = ("_value",)

    kind = "gauge"

    def __init__(self, name, labels):
        super().__init__(name, labels)
        self._value = 0.0

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    def inc(self, n=1) -> None:
        with self._lock:
            self._value += n

    def dec(self, n=1) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self):
        return self._value

    def snapshot(self):
        return self._value


class Histogram(_Metric):
    """Distribution with exact count/sum/min/max and a bounded uniform
    reservoir for percentiles (step latency, flushed-graph sizes)."""

    __slots__ = ("count", "sum", "min", "max", "_reservoir", "_rng")

    kind = "histogram"
    RESERVOIR = 512

    def __init__(self, name, labels):
        super().__init__(name, labels)
        self.count = 0
        self.sum = 0.0
        self.min = None  # type: Optional[float]
        self.max = None  # type: Optional[float]
        self._reservoir: List[float] = []
        # private stream: never perturbs (or is perturbed by) the
        # global random state a training script may have seeded
        self._rng = random.Random(0x5EED ^ hash(self.qualified_name))

    def observe(self, v) -> None:
        self.observe_many((v,))

    def observe_many(self, vs) -> None:
        """``observe`` each of ``vs`` in turn, under one lock."""
        with self._lock:
            for v in vs:
                v = float(v)
                self.count += 1
                self.sum += v
                if self.min is None or v < self.min:
                    self.min = v
                if self.max is None or v > self.max:
                    self.max = v
                if len(self._reservoir) < self.RESERVOIR:
                    self._reservoir.append(v)
                else:
                    j = self._rng.randrange(self.count)
                    if j < self.RESERVOIR:
                        self._reservoir[j] = v

    def percentile(self, q: float) -> Optional[float]:
        with self._lock:
            s = sorted(self._reservoir)
        return reservoir_quantile(s, q)

    def samples(self) -> List[float]:
        """The reservoir's values (all of them up to ``RESERVOIR``
        observations), in the order they landed."""
        with self._lock:
            return list(self._reservoir)

    def snapshot(self) -> Dict:
        with self._lock:
            s = sorted(self._reservoir)
            out = {"count": self.count, "sum": self.sum,
                   "min": self.min, "max": self.max,
                   "mean": (self.sum / self.count) if self.count else None}
        for q, tag in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
            out[tag] = reservoir_quantile(s, q)
        return out


class MetricsRegistry:
    """Get-or-create store of metrics, thread-safe. One process-wide
    instance lives in ``paddle_tpu_torch.observability``; an engine keeps
    a private one for its own ``stats()``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, LabelsT], _Metric] = {}

    def _get(self, cls, name: str, labels: Dict):
        key = (name, _labels_key(labels))
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = cls(name, key[1])
                    self._metrics[key] = m
        if not isinstance(m, cls):
            raise TypeError("metric %r already registered as %s, not %s"
                            % (name, m.kind, cls.kind))
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def counter_value(self, name: str, **labels):
        """Current value, 0 when the counter was never touched (reads
        never create metrics — dump stays an observation)."""
        m = self._metrics.get((name, _labels_key(labels)))
        return m.value if isinstance(m, Counter) else 0

    def gauge_value(self, name: str, **labels):
        m = self._metrics.get((name, _labels_key(labels)))
        return m.value if isinstance(m, Gauge) else 0

    def all_metrics(self) -> List[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()

    # -- export -----------------------------------------------------------

    def snapshot(self) -> Dict:
        """JSON-able {counters, gauges, histograms} keyed by
        ``name{label=value,...}``."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for m in self.all_metrics():
            out[m.kind + "s"][m.qualified_name] = m.snapshot()
        return out

    def to_prometheus(self, prefix: str = "paddle_tpu_") -> str:
        """Prometheus text exposition format (0.0.4). Histograms export
        as summaries (quantile series + _sum/_count)."""
        def _pname(name):
            return prefix + "".join(
                c if (c.isalnum() or c == "_") else "_" for c in name)

        def _plabels(labels, extra=()):
            items = list(labels) + list(extra)
            if not items:
                return ""
            # exposition-format label escaping (0.0.4): backslash
            # first, then quote and newline — an unescaped newline in
            # a label value would split the sample line and corrupt
            # the whole scrape
            body = ",".join('%s="%s"' % (k, str(v).replace("\\", "\\\\")
                                         .replace('"', '\\"')
                                         .replace("\n", "\\n"))
                            for k, v in items)
            return "{%s}" % body

        by_name: Dict[Tuple[str, str], List[_Metric]] = {}
        for m in self.all_metrics():
            by_name.setdefault((m.name, m.kind), []).append(m)
        lines = []
        for (name, kind), ms in sorted(by_name.items()):
            pn = _pname(name)
            ptype = {"counter": "counter", "gauge": "gauge",
                     "histogram": "summary"}[kind]
            lines.append("# TYPE %s %s" % (pn, ptype))
            for m in sorted(ms, key=lambda x: x.labels):
                if kind == "histogram":
                    for q in (0.5, 0.9, 0.99):
                        v = m.percentile(q)
                        if v is not None:
                            lines.append("%s%s %s" % (
                                pn, _plabels(m.labels,
                                             [("quantile", q)]), v))
                    lines.append("%s_sum%s %s"
                                 % (pn, _plabels(m.labels), m.sum))
                    lines.append("%s_count%s %s"
                                 % (pn, _plabels(m.labels), m.count))
                else:
                    lines.append("%s%s %s"
                                 % (pn, _plabels(m.labels), m.value))
        return "\n".join(lines) + ("\n" if lines else "")
