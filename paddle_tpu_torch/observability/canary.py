"""Canary-gated plan rollout: apply to one replica, compare, decide.

Counterpart of ``paddle_tpu/observability/canary.py`` (standard library
only, so the port keeps its own copy). A proposal (from the steering
daemon, or a steerer run by hand) never reaches the fleet directly: it is
applied to one canary (a serving replica on the new bucket ladder, a
training config under the new placement plan), measured, and compared
with the incumbent by ``observability/comparator.py``. Then:

- promote: no watched metric regressed (and, where the caller asks, the
  named metric improved): the plan is installed through the
  ``PlanStore`` pointer;
- roll back: a watched regression: the incumbent stays, and
  ``rollback_fn`` reverts the canary.

Every decision is flight-recorded (``canary.promoted`` /
``canary.rolled_back`` with the plan digest: they land in the merged
``trace.json``) and appended to the ``steering_audit.json`` trail. The
``PlanStore`` is the only writer of the active-plan pointer and refuses to
install without the audit entry of a promotion, so a plan switch that
skipped the trail cannot be written.

Audit entry (``steering_audit_v1``)::

    {"seq": n, "t": epoch_seconds, "decision": "promoted"|"rolled_back",
     "steerer": str|None, "plan_digest": sha1,
     "verdict": "ok"|"regression"|"no_overlap",
     "regressions": int, "regressed_metrics": [str, ...],
     "trigger": {...proposal trigger block or null...},
     "comparison": {...Comparison.to_dict()...}}

An interleaved A/B entry (``run_ab_canary``) carries ``"protocol":
"ab_interleaved"`` and ``pairs`` / ``ok_pairs`` / ``objective`` /
``objective_score`` / ``windows`` (each measurement window with its open
and close stamps and its record) / ``pair_verdicts`` (each pairwise
comparison) in place of the single ``comparison``.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from . import comparator, flight, steering
from . import inc as _inc
from . import set_gauge as _set_gauge

__all__ = ["AuditTrail", "PlanStore", "CanaryDecision", "run_canary",
           "run_ab_canary", "AUDIT_SCHEMA", "AUDIT_NAME",
           "AB_PROTOCOL", "AB_PAIRS_ENV", "DEFAULT_AB_PAIRS"]

AUDIT_SCHEMA = "steering_audit_v1"
AUDIT_NAME = "steering_audit.json"
# the interleaved A/B protocol's tag in its audit entries, which tells
# the two protocols apart
AB_PROTOCOL = "ab_interleaved"
AB_PAIRS_ENV = "PADDLE_TPU_AB_PAIRS"
DEFAULT_AB_PAIRS = 3


class AuditTrail:
    """Append-only JSON trail of steering decisions. The whole file is
    rewritten atomically per append (decisions are rare — human-scale
    events, not a hot path), so a reader never sees a torn trail and a
    crash between appends loses nothing already written."""

    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, AUDIT_NAME)
        self.path = path
        self._lock = threading.Lock()

    def entries(self) -> List[Dict]:
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return []
        if isinstance(doc, dict) and isinstance(doc.get("entries"),
                                                list):
            return doc["entries"]
        return []

    def append(self, entry: Dict) -> Dict:
        from ..checkpoint import atomic_write_bytes

        with self._lock:
            entries = self.entries()
            entry = dict(entry)
            entry["seq"] = len(entries)
            entry.setdefault("t", time.time())
            entries.append(entry)
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            atomic_write_bytes(self.path, json.dumps(
                {"schema": AUDIT_SCHEMA, "entries": entries},
                indent=2, sort_keys=True, default=str).encode())
        return entry


class PlanStore:
    """The fleet's active-plan pointer for one steerer:
    ``active_plan-<steerer>.json``. The ONLY legal write path is
    ``install`` — and install demands the audit entry that justified
    the switch, so an un-audited plan switch cannot be expressed."""

    def __init__(self, dirname: str, steerer: str):
        self.dirname = dirname
        self.steerer = steerer
        self.path = os.path.join(dirname,
                                 "active_plan-%s.json" % steerer)
        self.installs = 0

    def read(self) -> Optional[Dict]:
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def active_digest(self) -> Optional[str]:
        doc = self.read()
        if isinstance(doc, dict):
            d = doc.get("plan_digest") or doc.get("digest")
            if isinstance(d, str):
                return d
        return None

    def install(self, plan, audit_entry: Dict) -> str:
        """Atomically point the fleet at ``plan``. Refuses without the
        audit entry recording the promotion (and cross-checks its
        digest — the pointer and the trail can never disagree)."""
        from ..checkpoint import atomic_write_bytes

        if not isinstance(audit_entry, dict) \
                or audit_entry.get("decision") != "promoted":
            raise ValueError(
                "PlanStore.install requires the audit entry of a "
                "promotion — un-audited plan switches are not a thing")
        digest = steering.plan_digest(plan)
        if audit_entry.get("plan_digest") != digest:
            raise ValueError(
                "audit entry digest %r does not match plan %r"
                % (audit_entry.get("plan_digest"), digest))
        doc = {"schema": "active_plan_v1",
               "steerer": self.steerer,
               "plan": steering.plan_jsonable(plan),
               "plan_digest": digest,
               "audit_seq": audit_entry.get("seq"),
               "installed_at": time.time()}
        os.makedirs(self.dirname, exist_ok=True)
        atomic_write_bytes(self.path, json.dumps(
            doc, indent=2, sort_keys=True, default=str).encode())
        self.installs += 1
        return digest


class CanaryDecision:
    """What ``run_canary`` returns: the verdict plus everything needed
    to assert on it."""

    __slots__ = ("promoted", "reason", "plan", "plan_digest",
                 "comparison", "audit_entry")

    def __init__(self, promoted, reason, plan, plan_digest,
                 comparison, audit_entry):
        self.promoted = bool(promoted)
        self.reason = reason
        self.plan = plan
        self.plan_digest = plan_digest
        self.comparison = comparison
        self.audit_entry = audit_entry

    @property
    def decision(self) -> str:
        return "promoted" if self.promoted else "rolled_back"

    def __repr__(self):
        return "CanaryDecision(%s, %s, plan=%s)" % (
            self.decision, self.reason, self.plan_digest[:12])


def run_canary(proposal, incumbent, measure: Callable,
               *, steerer: Optional[str] = None,
               threshold: float = 0.10,
               counters_threshold: float = 0.25,
               apply_fn: Optional[Callable] = None,
               promote_fn: Optional[Callable] = None,
               rollback_fn: Optional[Callable] = None,
               plan_store: Optional[PlanStore] = None,
               audit: Optional[AuditTrail] = None,
               require_improvement: Optional[str] = None,
               min_improvement: float = 0.0,
               objective: Optional["comparator.Objective"] = None
               ) -> CanaryDecision:
    """One canary evaluation of ``proposal`` against ``incumbent``.

    - ``proposal``: a daemon proposal artifact (``{"plan": ...,
      "plan_digest": ...}``) or a bare plan;
    - ``incumbent``: the incumbent's measured record (any shape the
      comparator understands: a run record or a merged metrics.json);
    - ``measure(plan) -> record``: run the canary replica/config under
      the plan and return its record. The caller owns HOW (one
      FleetRouter replica, one re-launched config) — this function
      owns the decision protocol;
    - ``apply_fn(plan)``: point the canary at the plan before
      measuring (optional when ``measure`` applies internally);
    - ``promote_fn(plan)`` / ``rollback_fn(plan)``: roll the plan out
      to the fleet / revert the canary. Called AFTER the audit entry
      exists — the trail records the decision before the world
      changes;
    - ``require_improvement``: a watched metric name that must have
      improved by more than ``min_improvement`` (direction-aware) for
      promotion — "no regression" alone keeps a pointless plan out of
      the fleet when set.

    Promotion requires verdict ``ok`` — a canary whose record shares
    NOTHING with the incumbent (``no_overlap``) rolls back: a blind
    promote is worse than a spurious rollback.
    """
    if isinstance(proposal, dict) and "plan" in proposal:
        plan = proposal["plan"]
        trigger = {k: proposal.get(k) for k in
                   ("steerer", "metric", "baseline", "observed",
                    "threshold", "created_at") if k in proposal}
        steerer = steerer or proposal.get("steerer")
        digest = proposal.get("plan_digest") \
            or steering.plan_digest(plan)
    else:
        plan = proposal
        trigger = None
        digest = steering.plan_digest(plan)

    if objective is None and isinstance(proposal, dict) \
            and isinstance(proposal.get("objective"), dict):
        objective = comparator.Objective.from_dict(
            proposal["objective"])

    if apply_fn is not None:
        apply_fn(plan)
    head = measure(plan)
    cmp = comparator.compare(incumbent, head, threshold,
                             counters_threshold, objective=objective)

    promoted = cmp.ok
    reason = cmp.verdict
    if promoted and require_improvement:
        gain = cmp.improvement(require_improvement)
        if gain is None or gain <= min_improvement:
            promoted = False
            reason = "no_improvement:%s" % require_improvement

    entry = {
        "schema": AUDIT_SCHEMA,
        "decision": "promoted" if promoted else "rolled_back",
        "reason": reason,
        "steerer": steerer,
        "plan_digest": digest,
        "verdict": cmp.verdict,
        "regressions": cmp.regressions,
        "regressed_metrics": cmp.regressed_metrics,
        "trigger": trigger,
        "comparison": cmp.to_dict(),
    }
    if objective is not None:
        entry["objective"] = objective.to_dict()
        entry["objective_score"] = cmp.objective_score
        if cmp.objective_score is not None:
            _set_gauge("steering.objective_score",
                       cmp.objective_score, steerer=steerer or "none")
    if audit is not None:
        entry = audit.append(entry)

    if promoted:
        if plan_store is not None:
            if audit is None:
                raise ValueError(
                    "a PlanStore promotion requires an AuditTrail — "
                    "every plan switch must be audited")
            plan_store.install(plan, entry)
        if promote_fn is not None:
            promote_fn(plan)
        _inc("canary.promoted", steerer=steerer or "none")
        flight.record("canary.promoted", steerer=steerer,
                      plan_digest=digest, verdict=cmp.verdict,
                      regressions=cmp.regressions)
    else:
        if rollback_fn is not None:
            rollback_fn(plan)
        _inc("canary.rolled_back", steerer=steerer or "none")
        flight.record("canary.rolled_back", steerer=steerer,
                      plan_digest=digest, verdict=cmp.verdict,
                      reason=reason,
                      regressions=cmp.regressions)

    return CanaryDecision(promoted, reason, plan, digest, cmp, entry)


def _ab_pairs_default() -> int:
    try:
        n = int(os.environ.get(AB_PAIRS_ENV, "") or DEFAULT_AB_PAIRS)
    except ValueError:
        n = DEFAULT_AB_PAIRS
    return max(1, n)


def run_ab_canary(proposal, measure: Callable,
                  *, steerer: Optional[str] = None,
                  pairs: Optional[int] = None,
                  objective: Optional["comparator.Objective"] = None,
                  threshold: float = 0.10,
                  counters_threshold: float = 0.25,
                  apply_fn: Optional[Callable] = None,
                  revert_fn: Optional[Callable] = None,
                  promote_fn: Optional[Callable] = None,
                  rollback_fn: Optional[Callable] = None,
                  plan_store: Optional[PlanStore] = None,
                  audit: Optional[AuditTrail] = None,
                  min_score: float = 0.0) -> CanaryDecision:
    """Interleaved A/B canary: alternate incumbent and candidate
    measurement windows N times (A-B-A-B-...), score each ADJACENT
    pair, and promote only on strict-majority pairwise agreement (plus
    net objective improvement when an objective is configured).

    Why interleaved: a single before/after comparison (``run_canary``
    against a stale incumbent record) confuses plan effect with load
    drift — under monotone drift everything measured later looks
    better (or worse) regardless of the plan. Adjacent A/B windows are
    at most one window apart in time, so the drift contribution to
    each pairwise delta is bounded by one window of drift and the same
    bias applies to every pair; a plan that only "wins" because of
    drift loses the pairwise vote.

    - ``measure(plan_or_None) -> record``: one measurement window.
      ``None`` = measure the incumbent; a plan = measure the
      candidate. The caller owns window length.
    - ``revert_fn(plan)``: point the canary back at the incumbent
      before each A window (optional when ``measure(None)`` handles
      it); ``apply_fn(plan)`` points it at the candidate before each
      B window.
    - ``pairs``: A/B window pairs to run; default from the proposal's
      ``ab_pairs``, then ``PADDLE_TPU_AB_PAIRS``, then 3.
    - ``objective``: weighted scoring for every pairwise comparison;
      default from the proposal's ``objective`` block. With one, the
      MEAN pairwise score must exceed ``min_score`` on top of the
      majority vote; a hard-floor violation in ANY window vetoes
      unconditionally.

    The audit entry (appended BEFORE the world changes, like every
    canary decision) records every window, every pairwise verdict with
    its full comparison, and every objective term.
    """
    if isinstance(proposal, dict) and "plan" in proposal:
        plan = proposal["plan"]
        trigger = {k: proposal.get(k) for k in
                   ("steerer", "metric", "baseline", "observed",
                    "threshold", "created_at") if k in proposal}
        steerer = steerer or proposal.get("steerer")
        digest = proposal.get("plan_digest") \
            or steering.plan_digest(plan)
        if objective is None and \
                isinstance(proposal.get("objective"), dict):
            objective = comparator.Objective.from_dict(
                proposal["objective"])
        if pairs is None and proposal.get("ab_pairs"):
            pairs = int(proposal["ab_pairs"])
    else:
        plan = proposal
        trigger = None
        digest = steering.plan_digest(plan)
    pairs = max(1, int(pairs)) if pairs else _ab_pairs_default()

    windows: List[Dict] = []
    pair_docs: List[Dict] = []
    ok_pairs = 0
    hard_veto = False
    last_cmp = None

    def _window(phase: str, pair: int, plan_arg):
        flight.record("canary.window", phase=phase, pair=pair,
                      steerer=steerer, plan_digest=digest)
        _inc("canary.windows", phase=phase, steerer=steerer or "none")
        t_open = time.time()
        record = measure(plan_arg)
        windows.append({"seq": len(windows), "pair": pair,
                        "phase": phase, "t_open": t_open,
                        "t_close": time.time(), "record": record})
        return record

    for i in range(pairs):
        if revert_fn is not None:
            revert_fn(plan)
        rec_a = _window("incumbent", i, None)
        if apply_fn is not None:
            apply_fn(plan)
        rec_b = _window("candidate", i, plan)
        cmp = comparator.compare(rec_a, rec_b, threshold,
                                 counters_threshold,
                                 objective=objective)
        last_cmp = cmp
        if cmp.ok:
            ok_pairs += 1
        if cmp.verdict == "hard_floor":
            hard_veto = True
        pair_docs.append({"pair": i, "ok": cmp.ok,
                          "verdict": cmp.verdict,
                          "objective_score": cmp.objective_score,
                          "comparison": cmp.to_dict()})

    scores = [d["objective_score"] for d in pair_docs
              if d["objective_score"] is not None]
    mean_score = (sum(scores) / len(scores)) if scores else None

    promoted = ok_pairs * 2 > pairs
    reason = "ab_majority:%d/%d" % (ok_pairs, pairs)
    if hard_veto:
        # a hard-floor breach in any window vetoes whatever the vote
        promoted = False
        reason = "ab_hard_floor"
    elif promoted and objective is not None and \
            (mean_score is None or mean_score <= min_score):
        promoted = False
        reason = "ab_no_objective_improvement"

    if mean_score is not None:
        _set_gauge("steering.objective_score", mean_score,
                   steerer=steerer or "none")

    entry = {
        "schema": AUDIT_SCHEMA,
        "protocol": AB_PROTOCOL,
        "decision": "promoted" if promoted else "rolled_back",
        "reason": reason,
        "steerer": steerer,
        "plan_digest": digest,
        "pairs": pairs,
        "ok_pairs": ok_pairs,
        "objective": objective.to_dict() if objective is not None
        else None,
        "objective_score": mean_score,
        "windows": windows,
        "pair_verdicts": pair_docs,
        "trigger": trigger,
    }
    if audit is not None:
        entry = audit.append(entry)

    if promoted:
        if plan_store is not None:
            if audit is None:
                raise ValueError(
                    "a PlanStore promotion requires an AuditTrail — "
                    "every plan switch must be audited")
            plan_store.install(plan, entry)
        if promote_fn is not None:
            promote_fn(plan)
        _inc("canary.promoted", steerer=steerer or "none")
        flight.record("canary.promoted", steerer=steerer,
                      plan_digest=digest, protocol=AB_PROTOCOL,
                      ok_pairs=ok_pairs, pairs=pairs,
                      objective_score=mean_score)
    else:
        if rollback_fn is not None:
            rollback_fn(plan)
        _inc("canary.rolled_back", steerer=steerer or "none")
        flight.record("canary.rolled_back", steerer=steerer,
                      plan_digest=digest, protocol=AB_PROTOCOL,
                      reason=reason, ok_pairs=ok_pairs, pairs=pairs,
                      objective_score=mean_score)

    return CanaryDecision(promoted, reason, plan, digest, last_cmp,
                          entry)
