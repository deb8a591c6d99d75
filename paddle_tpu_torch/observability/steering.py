"""The ``profile report -> plan`` interface: one registry any subsystem
steers from.

Counterpart of ``paddle_tpu/observability/steering.py`` (standard library
only, so the port keeps its own copy). A *steerer* is a named callable
``fn(report, **context) -> plan`` that turns a saved step-profile report
(``profiler.profile_step``'s dict, or a record wrapping one under
``profile``) into a plan for one subsystem. The registered steerers:
``bucket_layout`` (``parallel/collectives.plan_buckets_profile``),
``placement`` (``placement/search.search_placement``), ``lazy_policy``
(``dygraph/lazy.plan_lazy_policy``) and ``serving_ladder``
(``serving/batcher``'s ladder fitted to observed batch rows).

- ``register_steerer(name, fn)``: re-registering a name replaces it, so a
  module that registers at import stays reload-safe;
- ``steer(name, report, **context)``: dispatch, counted in
  ``steering.plans{steerer=}``;
- ``load_report(path)``: the one report loader every steerer shares. It
  takes a ``profile_step`` dict, a record wrapping one, or a path (or
  env var) naming either, and returns None, never raising, on a missing,
  garbled or incomplete document, so a deleted report never breaks a
  training step.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Callable, Dict, List, Optional

__all__ = ["register_steerer", "get_steerer", "steerers", "steer",
           "load_report", "REPORT_FIELDS", "plan_digest",
           "plan_jsonable"]

# the measured fields every steerer keys on: per-collective cost points
# (the cost-model fit) and the backward compute timeline (the hide
# budget). A document missing either is not a usable report.
REPORT_FIELDS = ("per_bucket", "backward_segments")

_lock = threading.Lock()
_STEERERS: Dict[str, Callable] = {}


def register_steerer(name: str, fn: Callable,
                     description: str = "") -> Callable:
    """Register ``fn(report, **context) -> plan`` under ``name``.
    Re-registration replaces (import-reload safe). Returns ``fn`` so it
    can be used as a decorator tail."""
    if not name or not callable(fn):
        raise ValueError("steerer needs a name and a callable")
    with _lock:
        _STEERERS[name] = fn
        if description:
            fn.__steering_doc__ = description
    return fn


def get_steerer(name: str) -> Optional[Callable]:
    with _lock:
        return _STEERERS.get(name)


def steerers() -> List[str]:
    with _lock:
        return sorted(_STEERERS)


def steer(name: str, report, **context):
    """Dispatch ``report`` to the named steerer. Raises ``KeyError``
    for an unknown steerer (a typo should fail loudly, unlike a
    missing report)."""
    fn = get_steerer(name)
    if fn is None:
        raise KeyError("no steerer registered under %r (have: %s)"
                       % (name, ", ".join(steerers()) or "none"))
    from . import inc as _inc

    _inc("steering.plans", steerer=name)
    return fn(report, **context)


def load_report(path: Optional[str] = None,
                env: str = "PADDLE_TPU_BUCKET_PROFILE",
                required_fields=REPORT_FIELDS) -> Optional[Dict]:
    """Load a step-profile report from ``path`` (or the env var when
    path is None/empty). Unwraps a bench record's ``profile`` block.
    Returns None — never raises — when the path is unset, unreadable,
    not JSON, or missing any of ``required_fields``."""
    if path is None:
        path = os.environ.get(env, "").strip()
    if not path:
        return None
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return coerce_report(doc, required_fields=required_fields)


def plan_jsonable(plan):
    """A JSON-serializable view of any plan a steerer can return: a
    ``PlacementPlan``-style object (``to_doc()``), a plain container,
    or a tuple ladder. The canonical form the daemon writes into a
    proposal artifact and the digest hashes."""
    if hasattr(plan, "to_doc"):
        return plan.to_doc()
    if hasattr(plan, "to_dict"):
        return plan.to_dict()
    if isinstance(plan, tuple):
        return list(plan)
    return plan


def plan_digest(plan) -> str:
    """Stable content digest of a plan — the identity every steering
    decision is audited under. Plans that carry their own digest
    (``PlacementPlan.digest``) keep it; anything else hashes its
    canonical JSON form."""
    d = getattr(plan, "digest", None)
    if isinstance(d, str) and d:
        return d
    body = json.dumps(plan_jsonable(plan), sort_keys=True,
                      separators=(",", ":"), default=str)
    return hashlib.sha1(body.encode()).hexdigest()


def coerce_report(doc, required_fields=REPORT_FIELDS) -> Optional[Dict]:
    """The in-memory half of ``load_report``: unwrap + field-check an
    already-parsed document (a plan artifact embeds its source report
    inline — same validation, no file)."""
    if not isinstance(doc, dict):
        return None
    if isinstance(doc.get("profile"), dict):
        doc = doc["profile"]
    for field in required_fields:
        if not isinstance(doc.get(field), list):
            return None
    return doc
