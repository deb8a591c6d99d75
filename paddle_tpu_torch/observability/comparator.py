"""Watched-metric threshold comparator: the one comparison behind the
perf gate and the canary protocol (``observability/canary.py``).

Counterpart of ``paddle_tpu/observability/comparator.py`` (standard
library only, so the port keeps its own copy; the tables below are the
JAX package's, entry for entry, so both packages give the same verdict on
the same records). It compares the numbers of each workload between a
BASE and a HEAD record and flags every watched higher-is-better metric
that falls past a relative threshold (or lower-is-better one that grows
past it), with absolute noise floors, so sub-millisecond jitter on a
near-zero base never reads as a 150% regression. Record shapes:

- a benchmark record            (``{"extras": {workload: {...}}}``)
- a multi-device record         (``{"configs": {config: {...}}}``)
- a merged job ``metrics.json`` (``{"counters_total": {counter: value}}``,
                                from ``distributed.merge_job_dir``)

Two layers: ``diff_records`` / ``diff_counters`` yield raw tuples;
``compare(base, head)`` wraps both into a ``Comparison`` with a verdict
(``to_dict()`` is JSON-safe: a zero-base row's ``rel=inf`` is written as
the string ``"inf"``), which is what the canary audits.
"""
from __future__ import annotations

import json
import math
from typing import Dict, Iterator, List, Optional, Tuple

__all__ = [
    "WATCHED", "ABS_NOISE_FLOOR", "COUNTER_WATCH_GROWS_BAD",
    "load", "workloads", "counter_totals",
    "diff_records", "diff_counters", "compare", "Comparison",
    "Objective",
]

# per-workload metrics worth gating; direction: +1 higher is better, -1
# lower is better. Metrics of a record's ``profile``, ``diag`` or
# ``placement`` block resolve through ``_lookup``.
WATCHED = (
    ("images_per_sec", +1), ("tokens_per_sec", +1),
    ("examples_per_sec", +1), ("steps_per_sec", +1),
    ("tokens_or_images_per_sec", +1),
    ("step_ms", -1), ("collective_bytes", -1),
    ("mfu_est", +1), ("overlap_frac", +1),
    ("critical_path_ms", -1), ("exposed_collective_ms", -1),
    # the step profiler's phase attribution
    ("feed_ms", -1), ("optimizer_ms", -1),
    # the device trace's counterparts and the host-device agreement
    ("device_overlap_frac", +1), ("device_critical_path_ms", -1),
    ("host_device_agreement", +1),
    # serving: throughput, latency, queue wait, batch size, padding,
    # and the captures the bucket ladder bounds
    ("rows_per_s", +1), ("p50_ms", -1), ("p99_ms", -1),
    ("serving_queue_ms_p50", -1), ("serving_queue_ms_p99", -1),
    ("serving_batch_size_mean", +1),
    ("serving_padding_waste_frac", -1), ("jit_traces", -1),
    # decode: time to first token, inter-token latency, the margin over
    # the static-wave baseline measured in the same record
    ("ttft_p50_ms", -1), ("ttft_p99_ms", -1),
    ("itl_p50_ms", -1), ("itl_p99_ms", -1),
    ("decode_speedup_vs_static", +1),
    ("kv_occupancy_frac", +1), ("preemptions", -1),
    # parameter-server records (the JAX package's; kept for parity)
    ("ps_digest_ms", -1), ("rounds_per_s", +1),
    ("repl_delta_bytes_per_round", -1),
    ("ckpt_delta_bytes_per_round", -1), ("ckpt_restore_ms", -1),
    ("ps_row_load_skew", -1),
    # how well a searched placement plan's predicted step time tracks
    # the measured one (min / max ratio)
    ("placement_agreement", +1),
    # the scalar score of an objective-driven decision
    ("objective_score", +1),
)

# absolute noise floors of measured timings: a delta must clear both the
# relative threshold and this floor to flag. Deterministic metrics have
# no floor.
ABS_NOISE_FLOOR = {
    "step_ms": 2.0, "critical_path_ms": 2.0,
    "exposed_collective_ms": 2.0, "overlap_frac": 0.1,
    "feed_ms": 1.0, "optimizer_ms": 2.0,
    "device_overlap_frac": 0.1, "device_critical_path_ms": 2.0,
    "host_device_agreement": 0.1,
    "p50_ms": 5.0, "p99_ms": 10.0,
    "serving_queue_ms_p50": 5.0, "serving_queue_ms_p99": 10.0,
    "serving_batch_size_mean": 1.0, "serving_padding_waste_frac": 0.15,
    "ttft_p50_ms": 25.0, "ttft_p99_ms": 120.0,
    "itl_p50_ms": 3.0, "itl_p99_ms": 10.0,
    "decode_speedup_vs_static": 0.3, "kv_occupancy_frac": 0.15,
    "preemptions": 2.0,
    "ps_digest_ms": 5.0,
    "ckpt_restore_ms": 20.0,
    "placement_agreement": 0.15,
    "objective_score": 0.05,
}

# counter totals (metrics.json) whose growth is a regression: traffic,
# fallbacks, the parameter server's bytes (the JAX package's), a fused
# program's op count, and any serving error
COUNTER_WATCH_GROWS_BAD = ("parallel.collective_bytes",
                           "parallel.collective_ops",
                           "executor.compile_fallbacks",
                           "ps.replication_bytes",
                           "ps.migration_bytes",
                           "checkpoint.round_bytes",
                           "sc.program_ops",
                           "serving.errors", "serving.batch_errors",
                           "serving.stream_errors")


def load(path):
    with open(path) as f:
        doc = json.load(f)
    # a benchmark harness may wrap the record as {"parsed": {...}}
    if isinstance(doc, dict) and isinstance(doc.get("parsed"), dict):
        return doc["parsed"]
    return doc


def workloads(doc):
    """{workload: record} from any of the three supported shapes."""
    if "configs" in doc and isinstance(doc["configs"], dict):
        return dict(doc["configs"])  # multichip bench
    if "extras" in doc and isinstance(doc["extras"], dict):
        return {k: v for k, v in doc["extras"].items()
                if isinstance(v, dict) and not k.endswith("_error")}
    return {}


def counter_totals(doc):
    # merged job metrics.json (merge_job_dir) names the key
    # counters_total; accept the plain spelling too
    for key in ("counters_total", "totals"):
        if isinstance(doc.get(key), dict):
            return doc[key]
    if isinstance(doc.get("metrics_totals"), dict):
        return doc["metrics_totals"]  # multichip bench embeds them
    return {}


def diff_records(base, head, threshold
                 ) -> Iterator[Tuple[str, str, object, object,
                                     float, bool]]:
    """Yield (workload, metric, base, head, rel_delta, regressed)."""
    b_wl, h_wl = workloads(base), workloads(head)
    for name in sorted(set(b_wl) & set(h_wl)):
        b, h = b_wl[name], h_wl[name]
        for metric, direction in WATCHED:
            bv, hv = _lookup(b, metric), _lookup(h, metric)
            if bv is None or hv is None:
                continue
            if not bv:
                # growth from a zero base has no relative delta: show
                # the row (rel=inf) but don't hard-fail — a single-chip
                # BASE vs multichip HEAD legitimately goes 0 -> N
                # collective bytes, and the watched counter totals
                # below still gate structural from-zero growth
                if not hv:
                    continue
                yield name, metric, bv, hv, float("inf"), False
                continue
            rel = (hv - bv) / abs(bv)
            regressed = (-direction * rel) > threshold and \
                abs(hv - bv) > ABS_NOISE_FLOOR.get(metric, 0.0)
            yield name, metric, bv, hv, rel, regressed
        # a SILENT placement-plan change between runs is a regression:
        # same workload, same knobs, different plan digest means the
        # search (or its report) drifted without anyone deciding it
        bd = _plan_digest(b)
        hd = _plan_digest(h)
        if bd and hd and bd != hd:
            yield (name, "placement.plan_digest", bd[:12], hd[:12],
                   float("inf"), True)


def _plan_digest(rec):
    p = rec.get("placement")
    if isinstance(p, dict):
        d = p.get("plan_digest")
        if isinstance(d, str):
            return d
    return None


def _lookup(rec, metric):
    """A metric straight off the record, or from its profile block
    (mfu_est / overlap_frac / critical_path_ms), its diag (single-chip
    collective_bytes lives there), or its placement block
    (placement_agreement)."""
    v = rec.get(metric)
    if v is None and isinstance(rec.get("profile"), dict):
        v = rec["profile"].get(metric)
    if v is None and isinstance(rec.get("diag"), dict):
        v = rec["diag"].get(metric)
    if v is None and isinstance(rec.get("placement"), dict):
        v = rec["placement"].get(metric)
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return float(v)
    return None


def diff_counters(base, head, threshold
                  ) -> Iterator[Tuple[str, object, object, float, bool]]:
    b_t, h_t = counter_totals(base), counter_totals(head)
    for key in sorted(set(b_t) & set(h_t)):
        bv, hv = b_t[key], h_t[key]
        if not isinstance(bv, (int, float)):
            continue
        # exact key or its labeled series ("...{kind=...}") — a bare
        # prefix test would also catch parallel.collective_bytes_saved,
        # whose growth is an improvement
        grows_bad = any(key == w or key.startswith(w + "{")
                        for w in COUNTER_WATCH_GROWS_BAD)
        if not bv:
            if not hv:
                continue
            # zero -> nonzero growth of a watched counter is always a
            # regression (e.g. the first compile fallback appearing)
            yield key, bv, hv, float("inf"), grows_bad
            continue
        rel = (hv - bv) / abs(bv)
        yield key, bv, hv, rel, grows_bad and rel > threshold


class Objective:
    """A weighted multi-metric objective: per-metric weight, direction
    and absolute noise floor fold every compared row into ONE scalar
    score, with full per-term provenance for the audit trail.

    - ``weights``: {metric: weight > 0}. Weights are normalized (they
      only express RELATIVE importance): {"a": 2, "b": 2} scores
      identically to {"a": 1, "b": 1}.
    - ``directions``: per-metric override; required for metrics not in
      ``WATCHED``. An override that CONTRADICTS the watched direction
      is a configuration bug and raises (a rule author flipping
      ``step_ms`` to higher-is-better is never what they meant).
    - ``floors``: per-metric absolute noise floor override; defaults
      to ``ABS_NOISE_FLOOR``. A mean absolute delta at-or-under the
      floor contributes 0 to the score (noise is not signal in EITHER
      direction).
    - ``hard_floors``: {metric: absolute bound on the HEAD value} —
      SLO-style unconditional vetoes. For a lower-is-better metric the
      head may never EXCEED the bound (p99_ms may never pass 250ms);
      for higher-is-better it may never DROP BELOW it. A hard-floor
      violation vetoes promotion regardless of the score.

    The score is the weight-normalized sum over configured metrics of
    ``direction * mean(rel_delta)`` (positive = net improvement). A
    configured metric missing from the comparison contributes 0 but
    keeps its weight in the normalization and is flagged in its term —
    silently dropping a term would inflate the remaining ones.
    """

    __slots__ = ("weights", "directions", "floors", "hard_floors")

    def __init__(self, weights: Dict[str, float], *,
                 directions: Optional[Dict[str, int]] = None,
                 floors: Optional[Dict[str, float]] = None,
                 hard_floors: Optional[Dict[str, float]] = None):
        if not isinstance(weights, dict) or not weights:
            raise ValueError("Objective needs a non-empty weights dict")
        self.weights = {}
        for m, w in weights.items():
            w = float(w)
            if w <= 0:
                raise ValueError("objective weight for %r must be > 0, "
                                 "got %r" % (m, w))
            self.weights[m] = w
        self.hard_floors = {m: float(v)
                            for m, v in (hard_floors or {}).items()}
        watched = dict(WATCHED)
        directions = directions or {}
        self.directions = {}
        for m in sorted(set(self.weights) | set(self.hard_floors)):
            explicit = directions.get(m)
            if explicit is not None:
                explicit = int(explicit)
                if explicit not in (-1, 1):
                    raise ValueError("direction for %r must be +1 or "
                                     "-1, got %r" % (m, explicit))
                if m in watched and watched[m] != explicit:
                    raise ValueError(
                        "direction conflict for %r: objective says %+d "
                        "but WATCHED says %+d" % (m, explicit,
                                                  watched[m]))
                self.directions[m] = explicit
            elif m in watched:
                self.directions[m] = watched[m]
            else:
                raise ValueError(
                    "metric %r is not in WATCHED; an objective over it "
                    "needs an explicit direction" % (m,))
        self.floors = {}
        for m in self.weights:
            fl = (floors or {}).get(m)
            self.floors[m] = float(fl) if fl is not None \
                else float(ABS_NOISE_FLOOR.get(m, 0.0))

    def score_rows(self, rows: List[tuple]
                   ) -> Tuple[float, List[Dict]]:
        """Fold comparison rows into ``(score, terms)``. Each term
        carries its full provenance (weight, direction, mean relative
        delta, floor decision, contribution)."""
        wsum = sum(self.weights.values())
        by_metric: Dict[str, List[tuple]] = {}
        for row in rows:
            _wl, m, bv, hv, rel, _bad = row
            if m in self.weights and isinstance(rel, float) and \
                    math.isfinite(rel) and \
                    isinstance(bv, (int, float)) and \
                    isinstance(hv, (int, float)):
                by_metric.setdefault(m, []).append((float(bv),
                                                    float(hv),
                                                    float(rel)))
        score = 0.0
        terms = []
        for m in sorted(self.weights):
            weight = self.weights[m] / wsum
            got = by_metric.get(m)
            if not got:
                terms.append({"metric": m, "weight": weight,
                              "missing": True, "gain": 0.0,
                              "contribution": 0.0})
                continue
            rel = sum(r for _b, _h, r in got) / len(got)
            abs_delta = sum(abs(h - b) for b, h, _r in got) / len(got)
            gain = rel * self.directions[m]
            floored = abs_delta <= self.floors[m]
            contribution = 0.0 if floored else weight * gain
            score += contribution
            terms.append({
                "metric": m, "weight": weight,
                "direction": self.directions[m],
                "base": got[0][0], "head": got[0][1],
                "rel": rel, "gain": gain, "abs_delta": abs_delta,
                "floor": self.floors[m], "floored": floored,
                "contribution": contribution,
            })
        return score, terms

    def hard_floor_violations(self, rows: List[tuple]) -> List[Dict]:
        """Every (metric, workload) where the HEAD value sits past its
        SLO bound, regardless of relative movement."""
        out = []
        for _wl, m, _bv, hv, _rel, _bad in rows:
            bound = self.hard_floors.get(m)
            if bound is None or not isinstance(hv, (int, float)):
                continue
            d = self.directions[m]
            if (d < 0 and float(hv) > bound) or \
                    (d > 0 and float(hv) < bound):
                out.append({"metric": m, "workload": _wl,
                            "bound": bound, "head": float(hv)})
        return out

    def to_dict(self) -> Dict:
        return {"weights": dict(self.weights),
                "directions": dict(self.directions),
                "floors": dict(self.floors),
                "hard_floors": dict(self.hard_floors)}

    @classmethod
    def from_dict(cls, doc: Dict) -> "Objective":
        return cls(doc.get("weights") or {},
                   directions=doc.get("directions") or None,
                   floors=doc.get("floors") or None,
                   hard_floors=doc.get("hard_floors") or None)


class Comparison:
    """The structured result of ``compare``: every row both generators
    yielded, the regression count, and a one-word verdict the canary
    writes into its audit trail.

    With an ``objective`` attached, record-row regressions stop being
    individually fatal — they become weighted score terms, so a net
    win can carry one bounded regression. Three things still veto
    unconditionally: nothing comparable (``no_overlap``), a regressed
    WATCHED counter total (structural/error counters are never
    tradeable), and an objective ``hard_floor`` violation."""

    __slots__ = ("rows", "counter_rows", "threshold",
                 "counters_threshold", "objective")

    def __init__(self, rows, counter_rows, threshold,
                 counters_threshold, objective=None):
        self.rows: List[tuple] = rows
        self.counter_rows: List[tuple] = counter_rows
        self.threshold = threshold
        self.counters_threshold = counters_threshold
        self.objective: Optional[Objective] = objective

    @property
    def compared(self) -> int:
        return len(self.rows) + len(self.counter_rows)

    @property
    def regressions(self) -> int:
        return sum(1 for r in self.rows if r[-1]) + \
            sum(1 for r in self.counter_rows if r[-1])

    @property
    def regressed_metrics(self) -> List[str]:
        return [r[1] for r in self.rows if r[-1]] + \
            [r[0] for r in self.counter_rows if r[-1]]

    @property
    def counter_regressions(self) -> int:
        return sum(1 for r in self.counter_rows if r[-1])

    @property
    def objective_score(self) -> Optional[float]:
        """Weighted net score (positive = improvement); None when no
        objective is attached."""
        if self.objective is None:
            return None
        score, _terms = self.objective.score_rows(self.rows)
        return score

    def objective_result(self) -> Optional[Dict]:
        """Full objective evaluation: score, per-term provenance, and
        hard-floor violations. None without an objective."""
        if self.objective is None:
            return None
        score, terms = self.objective.score_rows(self.rows)
        violations = self.objective.hard_floor_violations(self.rows)
        return {"score": score, "terms": terms,
                "hard_floor_violations": violations,
                "ok": bool(self.compared > 0 and not violations and
                           self.counter_regressions == 0 and
                           score > 0)}

    @property
    def ok(self) -> bool:
        if self.objective is not None:
            res = self.objective_result()
            return bool(res and res["ok"])
        return self.compared > 0 and self.regressions == 0

    @property
    def verdict(self) -> str:
        """Flat mode: ``"ok"`` | ``"regression"`` | ``"no_overlap"``
        (nothing in common to compare — treated as NOT ok: a canary
        that measured nothing comparable must never promote).
        Objective mode: ``"objective_improved"`` |
        ``"objective_regression"`` | ``"hard_floor"`` |
        ``"counter_regression"`` | ``"no_overlap"``."""
        if not self.compared:
            return "no_overlap"
        if self.objective is not None:
            res = self.objective_result()
            if res["hard_floor_violations"]:
                return "hard_floor"
            if self.counter_regressions:
                return "counter_regression"
            return "objective_improved" if res["score"] > 0 \
                else "objective_regression"
        return "regression" if self.regressions else "ok"

    def improvement(self, metric: str) -> Optional[float]:
        """Signed relative improvement of ``metric`` across all
        workload rows (positive = better, direction-aware); None when
        the metric was not compared or sits on a zero base."""
        directions = dict(WATCHED)
        best = None
        for _wl, m, _bv, _hv, rel, _bad in self.rows:
            if m != metric or not math.isfinite(rel):
                continue
            gain = rel * directions.get(m, +1)
            best = gain if best is None else max(best, gain)
        return best

    def to_dict(self) -> Dict:
        """JSON-safe: non-finite relative deltas become ``"inf"``."""
        def _rel(rel):
            return rel if isinstance(rel, float) and math.isfinite(rel) \
                else "inf"

        doc = {
            "verdict": self.verdict,
            "ok": self.ok,
            "compared": self.compared,
            "regressions": self.regressions,
            "threshold": self.threshold,
            "counters_threshold": self.counters_threshold,
            "rows": [
                {"workload": wl, "metric": m, "base": bv, "head": hv,
                 "rel": _rel(rel), "regressed": bool(bad)}
                for wl, m, bv, hv, rel, bad in self.rows],
            "counter_rows": [
                {"counter": key, "base": bv, "head": hv,
                 "rel": _rel(rel), "regressed": bool(bad)}
                for key, bv, hv, rel, bad in self.counter_rows],
        }
        if self.objective is not None:
            # key present ONLY in objective mode — the default dict is
            # byte-identical with every pre-objective audit/CI record
            doc["objective"] = {
                "config": self.objective.to_dict(),
                "result": self.objective_result(),
            }
        return doc


def compare(base, head, threshold: float = 0.10,
            counters_threshold: float = 0.25,
            objective: Optional[Objective] = None) -> Comparison:
    """One call over both generators. ``base``/``head`` are already-
    parsed record documents (use ``load`` for files). With an
    ``objective``, ``ok``/``verdict`` switch to weighted-score
    semantics; the default (None) path is unchanged."""
    return Comparison(
        rows=list(diff_records(base, head, threshold)),
        counter_rows=list(diff_counters(base, head,
                                        counters_threshold)),
        threshold=threshold,
        counters_threshold=counters_threshold,
        objective=objective)
