"""Verifier-gated search of the parallelism plan.

Counterpart of ``paddle_tpu/placement/search.py``; on the same builder and
the same report both packages enumerate the same candidates, give each the
same status and pick the same winner (the same plan digest).

The space: the dp / mp / pp / sp / ep factorization of the device count,
the cross-replica sharded update, the bucket layout (a size cap or the
profile replanner), the reduction spelling, per-bucket quantization (with
error feedback) and the async start / await split.

The invariant: every candidate is rewritten on a fresh program and gated
through ``analysis.verify_program``, ``check_collective_schedule`` and
``check_cross_rank`` before anything runs. A candidate that fails is
recorded and dropped; it never reaches a replica. ``schedule_record``
digests merge equivalent candidates (a profile replan that reproduced the
size layout, say).

Two stages of a beam: stage A enumerates the structure (mesh, sharded
update, bucket layout), rewrites and gates each, and keeps the
``beam_width`` cheapest by the cost model; stage B expands the survivors
over (strategy, quant, async), gates each, merges duplicates and ranks.
The winner becomes a :class:`~.plan.PlacementPlan`.

A mesh whose non-dp axes the model was not built for (no sharded
embedding, ring attention, MoE or pipeline metadata on the program) is
recorded as ``unsupported``: a search after the build cannot add a hybrid
pass, it can only refuse by name.
"""
from __future__ import annotations

import itertools
import json
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .cost_model import CostModel, fit_cost_model
from .plan import PlacementPlan

__all__ = ["search_placement", "enumerate_meshes", "model_capabilities",
           "Candidate"]

MESH_AXES = ("dp", "mp", "pp", "sp", "ep")


class Candidate:
    """One point of the search space + its audit trail."""

    __slots__ = ("mesh", "sharded_update", "bucket_plan", "bucket_mb",
                 "strategy", "quant_mode", "quant_buckets",
                 "error_feedback", "async_collectives", "status",
                 "predicted_step_ms", "provenance", "schedule_digest",
                 "error", "verified", "traced", "schedule")

    def __init__(self, mesh, sharded_update=False, bucket_plan="size",
                 bucket_mb=4.0, strategy="ring", quant_mode="none",
                 quant_buckets=None, error_feedback=False,
                 async_collectives=False):
        self.mesh = tuple(mesh)
        self.sharded_update = sharded_update
        self.bucket_plan = bucket_plan
        self.bucket_mb = bucket_mb
        self.strategy = strategy
        self.quant_mode = quant_mode
        self.quant_buckets = quant_buckets
        self.error_feedback = error_feedback
        self.async_collectives = async_collectives
        self.status = "enumerated"
        self.predicted_step_ms = None
        self.provenance = None
        self.schedule_digest = None
        self.error = None
        self.verified = False   # passed the full static gate
        # the search runs no candidate, so this stays False; code that
        # ever runs one sets it, and the audit's traced_before_verify
        # counts a run before the gate
        self.traced = False
        self.schedule = None    # the scored collective schedule

    def key(self) -> Tuple:
        return (self.mesh, self.sharded_update, self.bucket_plan,
                self.bucket_mb, self.strategy, self.quant_mode,
                tuple(self.quant_buckets or ()), self.error_feedback,
                self.async_collectives)

    def spawn(self, **overrides) -> "Candidate":
        kw = {"mesh": self.mesh, "sharded_update": self.sharded_update,
              "bucket_plan": self.bucket_plan,
              "bucket_mb": self.bucket_mb, "strategy": self.strategy,
              "quant_mode": self.quant_mode,
              "quant_buckets": self.quant_buckets,
              "error_feedback": self.error_feedback,
              "async_collectives": self.async_collectives}
        kw.update(overrides)
        return Candidate(**kw)

    def audit_row(self) -> Dict:
        return {
            "mesh": [[a, s] for a, s in self.mesh],
            "sharded_update": self.sharded_update,
            "bucket": {"plan": self.bucket_plan,
                       "bucket_mb": self.bucket_mb},
            "strategy": self.strategy,
            "quant": {"mode": self.quant_mode,
                      "buckets": self.quant_buckets,
                      "error_feedback": self.error_feedback},
            "async_collectives": self.async_collectives,
            "status": self.status,
            "verified": self.verified,
            "traced": self.traced,
            "predicted_step_ms": self.predicted_step_ms,
            "provenance": self.provenance,
            "schedule_digest": self.schedule_digest,
            "error": self.error,
        }


# ---------------------------------------------------------------------------
# mesh enumeration
# ---------------------------------------------------------------------------


def model_capabilities(program) -> frozenset:
    """Mesh axes the built program can use: dp always; a hybrid axis
    only where a build-time pass left its metadata on the program (shard
    specs, data axes, pipeline stages). A factorization that needs any
    other axis is unsupported for this model: recorded, not guessed."""
    caps = {"dp"}
    specs = getattr(program, "_var_shard_specs", None) or {}
    data_axes = set(getattr(program, "_data_axes", None) or ())
    for spec in specs.values():
        caps.update(a for a in (spec or ()) if a)
    caps.update(a for a in data_axes if a)
    if getattr(program, "_pipeline_cuts", None) is not None or \
            getattr(program, "_pipeline_stages", None) is not None:
        caps.add("pp")
    return frozenset(caps & set(MESH_AXES))


def _factor_splits(n: int, k: int):
    """All ordered k-tuples of ints >= 1 whose product is n."""
    if k == 1:
        yield (n,)
        return
    for d in range(1, n + 1):
        if n % d:
            continue
        for rest in _factor_splits(n // d, k - 1):
            yield (d,) + rest


def enumerate_meshes(n_devices: int, caps: frozenset
                     ) -> Tuple[List[Tuple], List[Dict]]:
    """(supported, unsupported) mesh factorizations of ``n_devices``
    over dp/mp/pp/sp/ep. A mesh is the tuple of (axis, size) with
    size > 1 axes kept in canonical order (plus pure-dp as
    ``(("dp", n),)``). Unsupported rows carry the missing axes."""
    supported: List[Tuple] = []
    unsupported: List[Dict] = []
    seen = set()
    for sizes in _factor_splits(int(n_devices), len(MESH_AXES)):
        mesh = tuple((a, s) for a, s in zip(MESH_AXES, sizes) if s > 1)
        if not mesh:
            mesh = (("dp", int(n_devices)),)
        if mesh in seen:
            continue
        seen.add(mesh)
        missing = sorted({a for a, s in mesh if s > 1} - set(caps))
        if missing:
            unsupported.append({
                "mesh": [[a, s] for a, s in mesh],
                "status": "unsupported",
                "error": "model was not built for axes %s (no "
                         "build-time transpiler metadata)" % missing})
        else:
            supported.append(mesh)
    return supported, unsupported


# ---------------------------------------------------------------------------
# symbolic rewrite + static gate
# ---------------------------------------------------------------------------


def _rewrite_candidate(cand: Candidate, builder: Callable, report):
    """Build a fresh program and apply the candidate's rewrites: the
    passes ``maybe_rewrite_collectives`` runs under this plan. Returns
    (program, scope, loss_name). Nothing here touches a device."""
    from ..core.scope import Scope
    from ..parallel.collectives import (apply_sharded_weight_update,
                                        bucket_allreduce_ops)
    from ..parallel.scheduling import (configure_bucket_quant,
                                       schedule_async_collectives,
                                       swap_reduction_strategy)
    from ..parallel.transpiler import insert_allreduce_ops

    main, loss_name = builder()
    scope = Scope()
    nranks = 1
    for _a, s in cand.mesh:
        nranks *= s
    data_axis = cand.mesh[0][0]
    insert_allreduce_ops(main, nranks)
    if cand.sharded_update:
        apply_sharded_weight_update(main, scope, nranks, axis=data_axis,
                                    quant=cand.quant_mode)
    bucket_allreduce_ops(
        main, bucket_bytes=int(cand.bucket_mb * (1 << 20)),
        quant=cand.quant_mode, scope=scope,
        plan=cand.bucket_plan,
        report=report if cand.bucket_plan == "profile" else None)
    if cand.strategy != "ring":
        swap_reduction_strategy(main, cand.strategy)
    if cand.error_feedback or cand.quant_buckets:
        configure_bucket_quant(main, scope, nranks, data_axis,
                               modes=cand.quant_buckets,
                               error_feedback=cand.error_feedback,
                               materialize=False)
    if cand.async_collectives:
        # the report gates splits by measured slack REGARDLESS of the
        # bucket plan — the engine passes the plan's embedded report
        # the same way, so the candidate verified+priced here is the
        # schedule that actually executes
        schedule_async_collectives(main, report=report, scope=scope)
    return main, scope, loss_name


def _static_gate(cand: Candidate, program, scope, loss_name,
                 nranks: int) -> Dict:
    """The gate in full: well-formedness, the single-program collective
    schedule, and the cross-rank comparison (every rank runs this program;
    the pairwise check runs on the schedule extracted once a rank, so a
    divergence in the extraction itself would surface). Raises on any
    error finding; returns the schedule record (ok and digest)."""
    from ..analysis import (check_collective_schedule, check_cross_rank,
                            schedule_record, verify_program)

    verify_program(program, fetch_names=[loss_name],
                   pass_name="placement_search")
    sigs = check_collective_schedule(program, nranks=nranks,
                                     where="placement_search",
                                     scope=scope)
    check_cross_rank([list(sigs) for _ in range(min(nranks, 2))],
                     where="placement_search", scope=scope)
    return schedule_record(program, nranks=nranks, scope=scope)


def _candidate_schedule(program, scope) -> List[Dict]:
    """The cost model's view of a rewritten program's collectives: kind,
    bytes moved, availability position, strategy, from the
    ``build_phase_plan`` the profiler measures with."""
    from ..observability.profiler import build_phase_plan

    plan = build_phase_plan(program, state=scope)
    return [{"op": c["type"], "kind": c["kind"], "bytes": c["bytes"],
             "avail_pos": c["avail_pos"],
             "strategy": c.get("strategy", "ring"),
             "quant": c.get("quant", "none")}
            for c in plan["collectives"]]


def _score(cand: Candidate, builder: Callable, report,
           model: CostModel) -> Optional[Tuple]:
    """Rewrite + gate + price one candidate. Mutates the candidate's
    audit fields; returns (program-free) ranking tuple or None when
    the candidate was rejected."""
    nranks = 1
    for _a, s in cand.mesh:
        nranks *= s
    try:
        program, scope, loss_name = _rewrite_candidate(cand, builder,
                                                       report)
    except Exception as e:  # a model/bucket mismatch, not a verdict
        cand.status = "rejected"
        cand.error = "rewrite failed: %r" % (e,)
        return None
    try:
        rec = _static_gate(cand, program, scope, loss_name, nranks)
    except Exception as e:
        cand.status = "rejected"
        cand.error = "static gate: %s" % str(e)[:500]
        return None
    cand.verified = True
    cand.schedule_digest = rec.get("digest")
    sched = _candidate_schedule(program, scope)
    stage_sizes = [s for _a, s in cand.mesh if s > 1]
    for c in sched:
        c["stage_sizes"] = stage_sizes
    cand.schedule = sched
    pred = model.predict(sched,
                         async_scheduled=cand.async_collectives)
    cand.predicted_step_ms = pred["step_ms"]
    cand.provenance = pred["provenance"]
    cand.status = "verified"
    return (pred["step_ms"], json.dumps(cand.audit_row()["quant"],
                                        sort_keys=True), cand.key())


def derive_quant_buckets(schedule, model) -> Optional[List[str]]:
    """Per-bucket quantization: for each bucket op in the scored
    schedule, pick the wire mode the cost model prices cheapest at
    that bucket's payload (executed widths + the unmeasured-mode
    compute penalty: with int8 summed in int32 this derives all-"none",
    and flips a bucket only where fitted terms say the wire dominates).
    Returns one mode per bucket op, or None when nothing would quantize
    (the uniform candidate covers it)."""
    from ..ops.collective_ops import QUANT_PSUM_ITEMSIZE

    ents = [c for c in (schedule or ())
            if c.get("op") in ("c_bucket_allreduce",
                               "c_bucket_allreduce_start")]
    if not ents:
        return None
    modes: List[str] = []
    for c in ents:
        best, best_ms = "none", None
        for m in ("none", "bf16", "int8"):
            scale = (QUANT_PSUM_ITEMSIZE.get(m) or 4) / 4.0
            ms = model.collective_ms(c["kind"],
                                     float(c["bytes"]) * scale,
                                     c.get("strategy", "ring"),
                                     c.get("stage_sizes"), quant=m)
            if best_ms is None or ms < best_ms - 1e-12:
                best, best_ms = m, ms
        modes.append(best)
    if all(m == "none" for m in modes):
        return None
    return modes


# ---------------------------------------------------------------------------
# the beam
# ---------------------------------------------------------------------------


def _dedup_key(cand: Candidate) -> Tuple:
    """Two candidates whose rewritten programs carry the same schedule
    digest AND the same spelling knobs are the same plan (the typical
    hit: a profile replan that reproduced the size layout)."""
    return (cand.schedule_digest, cand.strategy, cand.quant_mode,
            tuple(cand.quant_buckets or ()), cand.error_feedback,
            cand.async_collectives)


def search_placement(builder: Callable, n_devices: int,
                     report: Optional[Dict] = None, beam_width: int = 4,
                     seed: int = 0, model: str = "",
                     strategies: Optional[Sequence[str]] = None,
                     include_quant: bool = True) -> Tuple[
                         Optional[PlacementPlan], Dict]:
    """Search the plan space for ``builder``'s model on ``n_devices``.

    ``builder() -> (main_program, loss_name)`` must return a FRESH
    un-transpiled training program each call (the search rewrites them
    destructively). Returns ``(winning_plan | None, audit)`` — the
    audit carries one row per enumerated candidate plus the
    enumeration/dedup/prune accounting the tests assert over.
    Deterministic: same builder + report + seed => same winner digest
    (the search itself draws no randomness; ``seed`` is recorded so a
    future stochastic refinement stays pinned)."""
    from ..observability import steering

    report = steering.coerce_report(report) if report is not None \
        else None
    cost = fit_cost_model(report, nranks=n_devices)

    probe, _loss = builder()
    caps = model_capabilities(probe)
    meshes, unsupported = enumerate_meshes(n_devices, caps)

    # -- stage A: structural beam (mesh x sharded x bucket layout) ----------
    bucket_dims: List[Tuple[str, float]] = [("size", 4.0), ("size", 1.0)]
    if report is not None:
        bucket_dims.append(("profile", 4.0))
    stage_a: List[Candidate] = []
    for mesh, sharded in itertools.product(meshes, (False, True)):
        if sharded:
            # bucket layout is moot once the update is sharded (the
            # grads collapse into the fused op) — one candidate
            stage_a.append(Candidate(mesh, sharded_update=True))
        else:
            for bplan, mb in bucket_dims:
                stage_a.append(Candidate(mesh, bucket_plan=bplan,
                                         bucket_mb=mb))
    all_rows: List[Candidate] = list(stage_a)
    ranked_a = []
    for cand in stage_a:
        rank = _score(cand, builder, report, cost)
        if rank is not None:
            ranked_a.append((rank, cand))
    ranked_a.sort(key=lambda rc: rc[0])
    survivors = [c for _r, c in ranked_a[:max(1, int(beam_width))]]
    for _r, c in ranked_a[max(1, int(beam_width)):]:
        c.status = "pruned"   # verified but beam-cut before expansion

    # -- stage B: spelling expansion (strategy x quant x async) -------------
    strategies = tuple(strategies or ("ring", "tree", "two_stage"))
    seen: Dict[Tuple, Candidate] = {}
    ranked_b = []
    for base in survivors:
        n_multi_axes = sum(1 for _a, s in base.mesh if s > 1)
        for strat in strategies:
            if strat == "two_stage" and n_multi_axes < 2:
                continue  # degenerates to ring on a 1-axis mesh
            if base.sharded_update and strat != "ring":
                continue  # the fused update op keeps its own psum
            quants: List[Tuple] = [("none", None, False)]
            if include_quant and not base.sharded_update:
                quants += [("bf16", None, False), ("int8", None, True)]
                # per-bucket derivation: the cost model flips each
                # wire-bound bucket individually (EF rides along when
                # any bucket goes int8)
                derived = derive_quant_buckets(base.schedule, cost)
                if derived is not None:
                    quants.append(("none", derived,
                                   "int8" in derived))
            for qmode, qbuckets, ef in quants:
                for use_async in ((False,) if base.sharded_update
                                  else (False, True)):
                    if (strat, qmode, qbuckets, ef, use_async) == \
                            ("ring", "none", None, False, False):
                        cand = base  # already scored in stage A
                    else:
                        cand = base.spawn(strategy=strat,
                                          quant_mode=qmode,
                                          quant_buckets=qbuckets,
                                          error_feedback=ef,
                                          async_collectives=use_async)
                        all_rows.append(cand)
                        if _score(cand, builder, report, cost) is None:
                            continue
                    dk = _dedup_key(cand)
                    prev = seen.get(dk)
                    if prev is not None:
                        if cand is not prev:
                            cand.status = "deduped"
                        continue
                    seen[dk] = cand
                    ranked_b.append(
                        ((cand.predicted_step_ms,
                          json.dumps([[a, s] for a, s in cand.mesh]),
                          repr(cand.key())), cand))
    ranked_b.sort(key=lambda rc: rc[0])

    audit = {
        "schema": "placement_search_audit_v1",
        "model": model,
        "n_devices": int(n_devices),
        "seed": int(seed),
        "beam_width": int(beam_width),
        "capabilities": sorted(caps),
        "cost_provenance": cost.provenance,
        "report_used": report is not None,
        "enumerated": len(all_rows) + len(unsupported),
        "verified": sum(1 for c in all_rows if c.verified),
        "rejected": sum(1 for c in all_rows
                        if c.status == "rejected"),
        "deduped": sum(1 for c in all_rows if c.status == "deduped"),
        "pruned": sum(1 for c in all_rows if c.status == "pruned"),
        "traced_before_verify": sum(
            1 for c in all_rows if c.traced and not c.verified),
        "unsupported": unsupported,
        "candidates": [c.audit_row() for c in all_rows],
    }
    from .. import observability as _obs

    _obs.inc("placement.candidates", len(all_rows))
    _obs.inc("placement.candidates_verified", audit["verified"])

    if not ranked_b:
        return None, audit
    best = ranked_b[0][1]
    best.status = "winner"
    audit["winner"] = best.audit_row()
    plan = PlacementPlan(
        mesh=best.mesh, strategy=best.strategy,
        bucket_mb=best.bucket_mb, bucket_plan_mode=best.bucket_plan,
        quant_mode=best.quant_mode, quant_buckets=best.quant_buckets,
        error_feedback=best.error_feedback,
        sharded_update=best.sharded_update,
        async_collectives=best.async_collectives,
        report=report,  # embedded: the artifact is self-contained
        predicted_step_ms=best.predicted_step_ms,
        cost_provenance=best.provenance or cost.provenance,
        schedule_digest=best.schedule_digest or "", model=model,
        source={"seed": int(seed), "beam_width": int(beam_width),
                "n_devices": int(n_devices),
                "enumerated": audit["enumerated"],
                "verified": audit["verified"]})
    return plan, audit


# -- steering registration ---------------------------------------------------


def _steer_placement(report, builder=None, n_devices=None, **ctx):
    """``steer("placement", report, builder=..., n_devices=...)``: the
    search through the steering registry."""
    if builder is None or n_devices is None:
        raise ValueError("placement steerer needs builder= and "
                         "n_devices=")
    return search_placement(builder, n_devices, report=report, **ctx)


from ..observability import steering as _steering  # noqa: E402

_steering.register_steerer(
    "placement", _steer_placement,
    "verifier-gated parallelism-plan search")
