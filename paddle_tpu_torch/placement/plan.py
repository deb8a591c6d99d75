"""The placement-plan artifact: the search's winning configuration,
saved a model and loaded by the data-parallel engine.

Counterpart of ``paddle_tpu/placement/plan.py``, with the same canonical
JSON and digest, so a plan saved by one package loads in the other.
Contract (``placement_plan_v1``):

- ``mesh``: the ordered ``[[axis, size], ...]`` factorization of the
  device count (dp / mp / pp / sp / ep);
- ``strategy``: the reduction spelling (ring | tree | two_stage);
- ``bucket``: ``{"plan": size|profile, "bucket_mb": float}``; a profile
  plan replans from the embedded report;
- ``quant``: ``{"mode", "buckets", "error_feedback"}``: one mode for all,
  or a list of one a bucket op;
- ``sharded_update`` / ``async_collectives``: the remaining knobs;
- ``report``: the source profile report, embedded, so one file is the
  whole plan;
- ``predicted_step_ms``, ``cost_provenance`` (fitted | analytic) and
  ``schedule_digest``: what the search promised;
- ``digest``: sha1 over the canonical body; a load checks it, so a
  truncated or hand-edited artifact fails loudly.

``PADDLE_TPU_PLACEMENT_PLAN=<file>`` arms :func:`active_plan`; the
engine's ``maybe_rewrite_collectives`` then applies the plan in place of
the hand knobs at a program's first data-parallel run. A plan whose mesh
does not match the live one is skipped and counted, never applied in part.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Dict, Optional, Sequence, Tuple

__all__ = ["PlacementPlan", "load_plan", "save_plan", "active_plan",
           "PLAN_ENV", "PLAN_SCHEMA"]

PLAN_ENV = "PADDLE_TPU_PLACEMENT_PLAN"
PLAN_SCHEMA = "placement_plan_v1"

_VALID_BUCKET_PLAN = ("size", "profile")


def _strategy_registry():
    # single source of truth (lazy: keeps this module import-light)
    from ..ops.collective_ops import REDUCTION_STRATEGIES

    return REDUCTION_STRATEGIES


def _quant_registry():
    from ..ops.collective_ops import QUANT_WIRE_ITEMSIZE

    return tuple(QUANT_WIRE_ITEMSIZE)


def _canonical(doc: Dict) -> bytes:
    body = {k: v for k, v in doc.items() if k != "digest"}
    return json.dumps(body, sort_keys=True,
                      separators=(",", ":")).encode()


class PlacementPlan:
    """In-memory form of the artifact; field validation happens at
    construction so a malformed plan can never reach a rewrite pass."""

    def __init__(self, mesh: Sequence[Tuple[str, int]],
                 strategy: str = "ring", bucket_mb: float = 4.0,
                 bucket_plan_mode: str = "size",
                 quant_mode: str = "none",
                 quant_buckets: Optional[Sequence[Optional[str]]] = None,
                 error_feedback: bool = False,
                 sharded_update: bool = False,
                 async_collectives: bool = False,
                 report: Optional[Dict] = None,
                 predicted_step_ms: Optional[float] = None,
                 cost_provenance: str = "analytic",
                 schedule_digest: str = "", model: str = "",
                 source: Optional[Dict] = None):
        mesh = [(str(a), int(s)) for a, s in mesh]
        if not mesh or any(s < 1 for _a, s in mesh):
            raise ValueError("placement plan: bad mesh %r" % (mesh,))
        if strategy not in _strategy_registry():
            raise ValueError("placement plan: bad strategy %r" % strategy)
        valid_quant = _quant_registry()
        if quant_mode not in valid_quant:
            raise ValueError("placement plan: bad quant mode %r"
                             % quant_mode)
        if bucket_plan_mode not in _VALID_BUCKET_PLAN:
            raise ValueError("placement plan: bad bucket plan %r"
                             % bucket_plan_mode)
        if quant_buckets is not None:
            for m in quant_buckets:
                if m is not None and m not in valid_quant:
                    raise ValueError(
                        "placement plan: bad per-bucket quant %r" % (m,))
        if bucket_plan_mode == "profile" and report is None:
            raise ValueError("placement plan: bucket plan 'profile' "
                             "needs an embedded report")
        self.mesh = mesh
        self.strategy = strategy
        self.bucket_mb = float(bucket_mb)
        self.bucket_plan_mode = bucket_plan_mode
        self.quant_mode = quant_mode
        self.quant_buckets = (list(quant_buckets)
                              if quant_buckets is not None else None)
        self.error_feedback = bool(error_feedback)
        self.sharded_update = bool(sharded_update)
        self.async_collectives = bool(async_collectives)
        self.report = report
        self.predicted_step_ms = (float(predicted_step_ms)
                                  if predicted_step_ms is not None
                                  else None)
        self.cost_provenance = cost_provenance
        self.schedule_digest = schedule_digest
        self.model = model
        self.source = dict(source or {})

    # -- identity -----------------------------------------------------------

    @property
    def n_devices(self) -> int:
        n = 1
        for _a, s in self.mesh:
            n *= s
        return n

    def to_doc(self) -> Dict:
        doc = {
            "schema": PLAN_SCHEMA,
            "model": self.model,
            "mesh": [[a, s] for a, s in self.mesh],
            "strategy": self.strategy,
            "bucket": {"plan": self.bucket_plan_mode,
                       "bucket_mb": self.bucket_mb},
            "quant": {"mode": self.quant_mode,
                      "buckets": self.quant_buckets,
                      "error_feedback": self.error_feedback},
            "sharded_update": self.sharded_update,
            "async_collectives": self.async_collectives,
            "report": self.report,
            "predicted_step_ms": self.predicted_step_ms,
            "cost_provenance": self.cost_provenance,
            "schedule_digest": self.schedule_digest,
            "source": self.source,
        }
        doc["digest"] = hashlib.sha1(_canonical(doc)).hexdigest()
        return doc

    @property
    def digest(self) -> str:
        return self.to_doc()["digest"]

    @classmethod
    def from_doc(cls, doc: Dict) -> "PlacementPlan":
        if not isinstance(doc, dict) or doc.get("schema") != PLAN_SCHEMA:
            raise ValueError("not a %s document" % PLAN_SCHEMA)
        want = doc.get("digest")
        got = hashlib.sha1(_canonical(doc)).hexdigest()
        if want != got:
            raise ValueError(
                "placement plan digest mismatch (%r != %r) — artifact "
                "corrupted or hand-edited" % (want, got))
        bucket = doc.get("bucket") or {}
        quant = doc.get("quant") or {}
        return cls(
            mesh=[(a, s) for a, s in doc.get("mesh") or []],
            strategy=doc.get("strategy", "ring"),
            bucket_mb=bucket.get("bucket_mb", 4.0),
            bucket_plan_mode=bucket.get("plan", "size"),
            quant_mode=quant.get("mode", "none"),
            quant_buckets=quant.get("buckets"),
            error_feedback=quant.get("error_feedback", False),
            sharded_update=doc.get("sharded_update", False),
            async_collectives=doc.get("async_collectives", False),
            report=doc.get("report"),
            predicted_step_ms=doc.get("predicted_step_ms"),
            cost_provenance=doc.get("cost_provenance", "analytic"),
            schedule_digest=doc.get("schedule_digest", ""),
            model=doc.get("model", ""),
            source=doc.get("source"))

    # -- engine-side application helpers -------------------------------------

    def matches(self, nranks: int, data_axes) -> bool:
        """A plan only applies to the mesh it was searched for: same
        total fan-in, and every data axis the plan's mesh names with
        size > 1 must be live. (Axis-name slack is deliberate — the
        engine derives axis names from the program, the plan from the
        search request.)"""
        if self.n_devices != int(nranks):
            return False
        plan_axes = {a for a, s in self.mesh if s > 1}
        live = set(data_axes or ())
        # dp-only plans (the common case) just need the fan-in match
        return plan_axes <= live or plan_axes == {"dp"} or not live

    def summary(self) -> Dict:
        """What a run record carries: enough to watch predicted-vs-
        measured drift and detect silent plan changes, without the
        embedded report."""
        return {
            "plan_digest": self.digest,
            "schedule_digest": self.schedule_digest,
            "predicted_step_ms": self.predicted_step_ms,
            "cost_provenance": self.cost_provenance,
            "mesh": [[a, s] for a, s in self.mesh],
            "strategy": self.strategy,
            "sharded_update": self.sharded_update,
            "async_collectives": self.async_collectives,
            "quant": self.quant_mode,
            "error_feedback": self.error_feedback,
        }


def save_plan(plan: PlacementPlan, path: str) -> str:
    """Atomic-enough single-file write (tmp + rename) of the canonical
    artifact; returns the plan digest."""
    doc = plan.to_doc()
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return doc["digest"]


def load_plan(path: str) -> PlacementPlan:
    with open(path, "r", encoding="utf-8") as f:
        return PlacementPlan.from_doc(json.load(f))


# -- engine hook -------------------------------------------------------------

_cache_lock = threading.Lock()
_plan_cache: Dict[str, Optional[PlacementPlan]] = {}


def active_plan() -> Optional[PlacementPlan]:
    """The plan named by ``PADDLE_TPU_PLACEMENT_PLAN``, or None. Read
    once per path per process (the engine bakes plans into programs at
    first mesh run anyway — point a NEW path at a new artifact, don't
    rewrite one in place). Unreadable/corrupt artifacts are counted
    and treated as absent: a deleted plan file degrades to the hand
    knobs, it never breaks a training step."""
    path = os.environ.get(PLAN_ENV, "").strip()
    if not path:
        return None
    with _cache_lock:
        if path in _plan_cache:
            return _plan_cache[path]
    try:
        plan = load_plan(path)
    except (OSError, ValueError) as e:
        from .. import observability as _obs

        _obs.inc("placement.plan_skipped", reason="unreadable")
        import sys

        print("placement: ignoring unreadable plan %r: %s"
              % (path, e), file=sys.stderr)
        plan = None
    with _cache_lock:
        _plan_cache[path] = plan
    return plan
