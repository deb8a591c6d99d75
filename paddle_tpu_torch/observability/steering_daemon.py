"""Steering daemon: watch the merged live telemetry and propose; never
apply.

Counterpart of ``paddle_tpu/observability/steering_daemon.py``. The
launcher's ``--steering`` role runs it as its own worker. Each poll:

1. merges the job's ``PADDLE_TPU_METRICS_DIR`` (``merge_job_dir``, as the
   launcher does at teardown) and reads the merged ``metrics.json``, the
   sampled-capture reports (``observability/capture.py``) and their
   cross-rank drift included;
2. evaluates each ``WatchRule`` (a direction-aware relative threshold
   with an absolute noise floor) against the rule's own baseline, its
   first observation after the start or after its last proposal;
3. when a rule breaches for ``hysteresis`` consecutive polls (one noisy
   poll never triggers), re-runs its registered steerer and writes a
   proposed plan (``proposed-<steerer>.json``) and a ``steering.proposed``
   flight event with the plan digest.

The daemon never applies a plan: that is the canary's
(``observability/canary.py``), which installs a proposal only after a
canary beat the incumbent, and audits every switch. After proposing, a
rule takes the observed level as its baseline and sleeps ``cooldown``
polls, so a proposal nobody acted on is not repeated every poll.

Run directly::

    python -m paddle_tpu_torch.observability.steering_daemon \\
        --metrics-dir DIR [--interval 5] [--max-polls N]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional

from . import flight
from . import inc as _inc
from . import steering

__all__ = ["WatchRule", "SteeringDaemon", "default_rules",
           "counter_ratio", "counter_value", "windowed_counter_ratio",
           "drift_value", "placement_agreement_value",
           "PROPOSAL_SCHEMA"]

PROPOSAL_SCHEMA = "steering_proposal_v1"

HYSTERESIS_ENV = "PADDLE_TPU_STEER_HYSTERESIS"
COOLDOWN_ENV = "PADDLE_TPU_STEER_COOLDOWN"


# -- metric extractors ------------------------------------------------------
#
# A rule watches ONE number derived from the merged metrics.json.
# Counters only grow, so "padding waste rose" must be judged as a
# RATIO (waste per batch), never a raw total.

def counter_value(name: str) -> Callable[[Dict], Optional[float]]:
    def _get(doc):
        v = (doc.get("counters_total") or {}).get(name)
        return float(v) if isinstance(v, (int, float)) else None
    return _get


def counter_ratio(num: str, den: str,
                  min_den: float = 1.0) -> Callable[[Dict],
                                                    Optional[float]]:
    """numerator/denominator over the job's counter totals; None until
    the denominator has seen ``min_den`` events (a ratio over nothing
    is noise, not signal)."""
    def _get(doc):
        totals = doc.get("counters_total") or {}
        n, d = totals.get(num), totals.get(den)
        if not isinstance(n, (int, float)) \
                or not isinstance(d, (int, float)) or d < min_den:
            return None
        return float(n) / float(d)
    return _get


def windowed_counter_ratio(num: str, den: str,
                           min_den: float = 1.0
                           ) -> Callable[[Dict], Optional[float]]:
    """numerator/denominator over the merged job's WINDOWED deltas
    (``series_windows``, timeseries.py) — "waste per batch over the
    last window", so a fresh drift is judged against the recent past
    instead of being diluted by hours of lifetime totals. Falls back
    to the lifetime ``counter_ratio`` when no series exist yet (old
    dumps, sampling disabled, or fewer than two dump ticks)."""
    lifetime = counter_ratio(num, den, min_den)

    def _get(doc):
        wins = doc.get("series_windows")
        if isinstance(wins, dict):
            nw, dw = wins.get(num), wins.get(den)
            if isinstance(nw, dict) and isinstance(dw, dict):
                nd, dd = nw.get("delta"), dw.get("delta")
                if isinstance(nd, (int, float)) \
                        and isinstance(dd, (int, float)) \
                        and dd >= min_den:
                    return float(nd) / float(dd)
        return lifetime(doc)
    return _get


def recompile_frac() -> Callable[[Dict], Optional[float]]:
    """lazy.recompiles / (lazy.recompiles + lazy.cache_hits): the
    fraction of lazy flushes that paid a fresh trace."""
    def _get(doc):
        totals = doc.get("counters_total") or {}
        r = totals.get("lazy.recompiles")
        h = totals.get("lazy.cache_hits")
        if not isinstance(r, (int, float)) \
                or not isinstance(h, (int, float)) or (r + h) < 1:
            return None
        return float(r) / float(r + h)
    return _get


def drift_value(metric: str, field: str = "spread"
                ) -> Callable[[Dict], Optional[float]]:
    """A number off the merged ``sampled_profile_drift`` block (e.g.
    the cross-rank step_ms spread a straggler shows up as)."""
    def _get(doc):
        row = (doc.get("sampled_profile_drift") or {}).get(metric)
        if isinstance(row, dict) \
                and isinstance(row.get(field), (int, float)):
            return float(row[field])
        return None
    return _get


def placement_agreement_value(plan_path: Optional[str] = None
                              ) -> Callable[[Dict], Optional[float]]:
    """Live predicted-vs-measured agreement: the active placement
    plan's ``predicted_step_ms`` against the mean sampled step_ms
    across ranks (min / max ratio, the comparator's
    ``placement_agreement``). None when no plan artifact or no sampled
    reports exist yet."""
    def _get(doc):
        path = plan_path or os.environ.get(
            "PADDLE_TPU_PLACEMENT_PLAN", "").strip()
        if not path:
            return None
        try:
            with open(path, "r", encoding="utf-8") as f:
                plan = json.load(f)
        except (OSError, ValueError):
            return None
        pred = plan.get("predicted_step_ms") \
            if isinstance(plan, dict) else None
        if not isinstance(pred, (int, float)) or pred <= 0:
            return None
        steps = []
        for sdoc in (doc.get("sampled_profiles") or {}).values():
            prof = sdoc.get("profile") or {}
            v = prof.get("step_ms")
            if isinstance(v, (int, float)) and v > 0:
                steps.append(float(v))
        if not steps:
            return None
        measured = sum(steps) / len(steps)
        return min(pred, measured) / max(pred, measured)
    return _get


# -- rules ------------------------------------------------------------------

class WatchRule:
    """One watched metric: an extractor, a threshold (the relative move
    from the rule's baseline in the bad direction, gated by an absolute
    noise floor) and the steerer to re-run on a sustained breach."""

    __slots__ = ("name", "value_fn", "direction", "threshold",
                 "floor", "steerer", "description", "objective",
                 "ab_pairs")

    def __init__(self, name: str, value_fn: Callable,
                 direction: int, threshold: float, steerer: str,
                 floor: float = 0.0, description: str = "",
                 objective=None, ab_pairs: Optional[int] = None):
        if direction not in (+1, -1):
            raise ValueError("direction must be +1 or -1")
        if threshold <= 0:
            raise ValueError("threshold must be > 0")
        self.name = name
        self.value_fn = value_fn
        self.direction = int(direction)
        self.threshold = float(threshold)
        self.floor = float(floor)
        self.steerer = steerer
        self.description = description
        # the rule's canary settings: a comparator.Objective (anything
        # with to_dict()) and an A/B window-pair count ride the proposal
        # into run_ab_canary, so a rule names the trade-off its plan may
        # make
        self.objective = objective
        self.ab_pairs = int(ab_pairs) if ab_pairs else None

    def breached(self, baseline: float, observed: float) -> bool:
        if not baseline:
            return bool(observed) and self.direction < 0 \
                and abs(observed) > self.floor
        rel = (observed - baseline) / abs(baseline)
        return (-self.direction * rel) > self.threshold \
            and abs(observed - baseline) > self.floor


def default_rules() -> List[WatchRule]:
    """Three drifts: padding waste rising (the ladder is stale), the
    recompile fraction growing (the lazy key cap is stale), placement
    agreement collapsing (the cost model is off the machine)."""
    return [
        WatchRule("serving_padding_waste",
                  windowed_counter_ratio("serving.padding_waste",
                                         "serving.batches",
                                         min_den=8),
                  direction=-1, threshold=0.25, floor=0.10,
                  steerer="serving_ladder",
                  description="padded rows per dispatched batch "
                              "(last window when series exist)"),
        WatchRule("lazy_recompile_frac", recompile_frac(),
                  direction=-1, threshold=0.25, floor=0.05,
                  steerer="lazy_policy",
                  description="fraction of lazy flushes re-tracing"),
        WatchRule("placement_agreement",
                  placement_agreement_value(),
                  direction=+1, threshold=0.15, floor=0.10,
                  steerer="placement",
                  description="active-plan predicted vs sampled "
                              "step_ms"),
    ]


# -- the daemon -------------------------------------------------------------

class SteeringDaemon:
    """See the module docstring. ``context`` maps steerer name ->
    kwargs forwarded on re-run (the placement steerer needs its
    builder/n_devices; the serving steerer its max_batch_size)."""

    def __init__(self, metrics_dir: str,
                 rules: Optional[List[WatchRule]] = None,
                 hysteresis: Optional[int] = None,
                 cooldown: Optional[int] = None,
                 interval_s: float = 5.0,
                 out_dir: Optional[str] = None,
                 context: Optional[Dict[str, Dict]] = None,
                 merge: bool = True):
        if not metrics_dir:
            raise ValueError("steering daemon needs a metrics dir")
        if hysteresis is None:
            hysteresis = int(os.environ.get(HYSTERESIS_ENV, "2") or 2)
        if cooldown is None:
            cooldown = int(os.environ.get(COOLDOWN_ENV, "3") or 3)
        self.metrics_dir = metrics_dir
        self.rules = list(rules) if rules is not None \
            else default_rules()
        self.hysteresis = max(1, int(hysteresis))
        self.cooldown = max(0, int(cooldown))
        self.interval_s = float(interval_s)
        self.out_dir = out_dir or metrics_dir
        self.context = dict(context or {})
        self.merge = bool(merge)
        self.polls = 0
        self.proposals: List[Dict] = []
        self._state: Dict[str, Dict] = {
            r.name: {"baseline": None, "breaches": 0, "cooldown": 0}
            for r in self.rules}

    # -- one poll ----------------------------------------------------

    def read_merged(self) -> Optional[Dict]:
        from . import distributed as _dist

        if self.merge:
            try:
                _dist.merge_job_dir(self.metrics_dir)
            except Exception:
                # a torn dump mid-write must not kill the daemon — the
                # stale merged file (if any) serves this poll
                _inc("steering.merge_errors")
        path = os.path.join(self.metrics_dir,
                            _dist.MERGED_METRICS_NAME)
        try:
            with open(path, "r", encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def newest_report(self, doc: Dict) -> Optional[Dict]:
        """The most recent rank's sampled profile, coerced through the
        registry's shared loader (stale/garbage reports become None,
        exactly like a deleted report file would)."""
        best, best_t = None, -1.0
        for sdoc in (doc.get("sampled_profiles") or {}).values():
            t = sdoc.get("wrote_at")
            t = float(t) if isinstance(t, (int, float)) else 0.0
            if t > best_t:
                best, best_t = sdoc, t
        if best is None:
            return None
        return steering.coerce_report(best.get("profile"))

    def poll_once(self) -> List[Dict]:
        self.polls += 1
        doc = self.read_merged()
        if doc is None:
            return []
        report = self.newest_report(doc)
        out = []
        for rule in self.rules:
            prop = self._evaluate(rule, doc, report)
            if prop is not None:
                out.append(prop)
        return out

    def _evaluate(self, rule: WatchRule, doc: Dict,
                  report: Optional[Dict]) -> Optional[Dict]:
        st = self._state[rule.name]
        if st["cooldown"] > 0:
            st["cooldown"] -= 1
            return None
        observed = rule.value_fn(doc)
        if observed is None:
            return None
        if st["baseline"] is None:
            st["baseline"] = observed
            return None
        if not rule.breached(st["baseline"], observed):
            # hysteresis is CONSECUTIVE breaches: one clean poll
            # resets the count — a metric oscillating around the
            # threshold never accumulates to a trigger
            st["breaches"] = 0
            return None
        st["breaches"] += 1
        if st["breaches"] < self.hysteresis:
            return None
        prop = self._propose(rule, doc, report, st["baseline"],
                             observed)
        st["breaches"] = 0
        st["cooldown"] = self.cooldown
        st["baseline"] = observed
        return prop

    def _propose(self, rule: WatchRule, doc: Dict,
                 report: Optional[Dict], baseline: float,
                 observed: float) -> Optional[Dict]:
        _import_consumers()
        ctx = self.context.get(rule.steerer, {})
        try:
            plan = steering.steer(rule.steerer, report, **ctx)
        except Exception as e:
            _inc("steering.propose_errors", steerer=rule.steerer)
            flight.record("steering.propose_error",
                          steerer=rule.steerer, metric=rule.name,
                          error="%s: %s" % (type(e).__name__, e))
            return None
        digest = steering.plan_digest(plan)
        artifact = {
            "schema": PROPOSAL_SCHEMA,
            "steerer": rule.steerer,
            "metric": rule.name,
            "baseline": baseline,
            "observed": observed,
            "threshold": rule.threshold,
            "hysteresis": self.hysteresis,
            "plan": steering.plan_jsonable(plan),
            "plan_digest": digest,
            "created_at": time.time(),
            "poll": self.polls,
        }
        if rule.objective is not None:
            artifact["objective"] = rule.objective.to_dict()
        if rule.ab_pairs:
            artifact["ab_pairs"] = rule.ab_pairs
        path = os.path.join(self.out_dir,
                            "proposed-%s.json" % rule.steerer)
        try:
            from ..checkpoint import atomic_write_bytes

            os.makedirs(self.out_dir, exist_ok=True)
            atomic_write_bytes(path, json.dumps(
                artifact, indent=2, sort_keys=True,
                default=str).encode())
        except OSError:
            path = None
        _inc("steering.proposals", steerer=rule.steerer)
        flight.record("steering.proposed", steerer=rule.steerer,
                      metric=rule.name, plan_digest=digest,
                      baseline=round(baseline, 6),
                      observed=round(observed, 6))
        artifact["path"] = path
        self.proposals.append(artifact)
        return artifact

    # -- supervised loop ---------------------------------------------

    def run(self, max_polls: Optional[int] = None,
            stop_event=None) -> int:
        """Poll until ``max_polls`` (None = forever) or ``stop_event``
        is set. Returns the number of proposals emitted."""
        n = 0
        while max_polls is None or self.polls < max_polls:
            if stop_event is not None and stop_event.is_set():
                break
            n += len(self.poll_once())
            if max_polls is not None and self.polls >= max_polls:
                break
            if stop_event is not None:
                if stop_event.wait(self.interval_s):
                    break
            else:
                time.sleep(self.interval_s)
        return n


def _import_consumers() -> None:
    """Steerers register at their module's import; make sure the known
    consumers had the chance before a dispatch (a daemon process never
    imported the serving stack on its own)."""
    for mod in ("paddle_tpu_torch.parallel.collectives",
                "paddle_tpu_torch.serving.batcher",
                "paddle_tpu_torch.dygraph.lazy",
                "paddle_tpu_torch.placement.search",
                "paddle_tpu_torch.observability.ps_steering"):
        try:
            __import__(mod)
        except Exception:
            # a missing consumer only narrows what can be steered —
            # steer() still fails loudly (KeyError) on dispatch
            _inc("steering.import_errors", module=mod)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0])
    ap.add_argument("--metrics-dir",
                    default=os.environ.get("PADDLE_TPU_METRICS_DIR"),
                    help="job metrics dir (default: "
                         "$PADDLE_TPU_METRICS_DIR)")
    ap.add_argument("--interval", type=float, default=5.0,
                    help="seconds between polls (default 5)")
    ap.add_argument("--max-polls", type=int, default=None,
                    help="stop after N polls (default: run forever)")
    ap.add_argument("--hysteresis", type=int, default=None,
                    help="consecutive breached polls before a "
                         "proposal (default $%s or 2)" % HYSTERESIS_ENV)
    ap.add_argument("--cooldown", type=int, default=None,
                    help="polls to sleep a rule after it proposed "
                         "(default $%s or 3)" % COOLDOWN_ENV)
    args = ap.parse_args(argv)
    if not args.metrics_dir:
        ap.error("--metrics-dir or PADDLE_TPU_METRICS_DIR required")
    daemon = SteeringDaemon(args.metrics_dir,
                            hysteresis=args.hysteresis,
                            cooldown=args.cooldown,
                            interval_s=args.interval)
    n = daemon.run(max_polls=args.max_polls)
    print("steering daemon: %d poll(s), %d proposal(s)"
          % (daemon.polls, n))
    return 0


if __name__ == "__main__":
    sys.exit(main())
