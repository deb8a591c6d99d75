"""Profile-fitted cost model for the placement search.

Counterpart of ``paddle_tpu/placement/cost_model.py`` (standard library
only, so the port keeps its own copy: the same fit and the same prediction,
number for number). It prices a candidate collective schedule in
milliseconds from two kinds of evidence, each number tagged with where it
came from:

- **fitted**: a saved step-profile report (``profiler.profile_step``):
  its measured per-collective points (``per_bucket``: bytes against
  collective ms, by kind) fit an ``a + b * bytes`` line a kind; its
  ``backward_segments`` give the compute a collective can hide behind;
  its ``phase_ms`` the compute floor. Another spelling of a reduction
  re-scales the fitted line by its launches and its busiest link
  (``strategy_factors``);
- **analytic**: hand estimates (``DEFAULT_ALPHA_MS``,
  ``DEFAULT_BW_GBPS``) where no usable report exists. The search still
  runs, and every score says ``provenance="analytic"``.

The analytic constants are the JAX package's, kept so that both packages
price a report-less search alike: they are magnitudes of a CPU host mesh,
not of the card. On the card a plan comes from a model fitted to a report
the card measured (``profile_step`` of a step on the card).

The model charges the widths the reduction moves (``QUANT_PSUM_ITEMSIZE``:
int8 codes are summed in int32, so int8 saves no bytes on the wire).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["CostModel", "fit_cost_model", "analytic_cost_model",
           "strategy_factors"]

# analytic fallbacks: magnitudes of a CPU host mesh, not of the card; a
# fitted model replaces them, never an edit of these
DEFAULT_ALPHA_MS = 0.05     # per-hop launch / latency cost
DEFAULT_BW_GBPS = 2.0       # effective per-link bandwidth
# share of a bucket's in-budget cost the schedule hides; the report's
# measured overlap_frac where it has one
DEFAULT_OVERLAP_EFF = 0.6
ASYNC_OVERLAP_BONUS = 0.2   # a scheduled start / await over no split

# analytic compute cost of a compressed payload (the cast, or the scale,
# round and clip passes around the sum), charged for a quant mode the
# report did not measure, so that quantization is never free because it
# shrinks bytes. Magnitudes of a CPU host mesh; a report measured under a
# mode carries its cost inside the fitted line and pays none of this.
QUANT_COMPUTE_MS_PER_BYTE = {"none": 0.0, "bf16": 2e-5, "int8": 4e-5}


def strategy_factors(strategy: str, nranks: int,
                     stage_sizes: Optional[Sequence[int]] = None
                     ) -> Tuple[float, float]:
    """(launches, bw_factor) of a reduction spelling at fan-in ``nranks``,
    a price of what ``ops.collective_ops.strategy_psum`` runs:

    - ``ring``: one reduction; busiest-link bytes 2(n-1)/n of the payload.
    - ``tree``: two collectives (a reduce-scatter and an all-gather), the
      same bytes as the ring and one launch more.
    - ``two_stage``: one whole-payload reduction a mesh axis
      (``stage_sizes``; a balanced 2-way split by default), each moving
      2(s-1)/s of the payload on its axis.
    """
    n = max(1, int(nranks))
    if n == 1:
        return 0.0, 0.0
    if strategy == "tree":
        return 2.0, 2.0 * (n - 1) / n
    if strategy == "two_stage":
        sizes = [s for s in (stage_sizes or ()) if s and s > 1]
        if not sizes:
            a = 2 ** (math.ceil(math.log2(n)) // 2)
            sizes = [max(2, int(a)), max(1, n // max(2, int(a)))]
        bw = sum(2.0 * (s - 1) / s for s in sizes)
        return float(len(sizes)), bw
    # ring
    return 1.0, 2.0 * (n - 1) / n


class CostModel:
    """Per-kind ``a + b*bytes`` collective terms + compute terms, each
    tagged ``fitted`` or ``analytic``. ``provenance`` is the weakest
    tag any consumed term carries — a score is only "fitted" when
    every number behind it was measured."""

    def __init__(self, nranks: int, terms: Dict[str, Tuple[float, float]],
                 compute_ms: float, backward_segments: List,
                 fitted_kinds: frozenset, base_strategy: str = "ring",
                 overlap_eff: float = DEFAULT_OVERLAP_EFF,
                 compute_fitted: bool = False,
                 overhead_ms: float = 0.0, base_quant: str = "none"):
        self.nranks = max(1, int(nranks))
        self.terms = dict(terms)          # kind -> (a_ms, b_ms_per_byte)
        self.compute_ms = float(compute_ms)
        self.backward_segments = [tuple(s) for s in backward_segments]
        self.fitted_kinds = frozenset(fitted_kinds)
        self.base_strategy = base_strategy
        self.overlap_eff = float(overlap_eff)
        self.compute_fitted = bool(compute_fitted)
        # fixed per-step cost outside compute and collectives (dispatch,
        # fetch, host work): the report's whole-step time less its
        # phases. The same for every candidate, so it never changes a
        # ranking; it puts predicted_step_ms on the measured clock.
        self.overhead_ms = max(0.0, float(overhead_ms))
        # the wire mode the fitted points were measured under — that
        # mode's quantize compute is already inside the fitted line
        self.base_quant = base_quant

    # -- provenance ---------------------------------------------------------

    def term_provenance(self, kind: str) -> str:
        return "fitted" if kind in self.fitted_kinds else "analytic"

    @property
    def provenance(self) -> str:
        """Whole-model tag: fitted only when the compute floor AND at
        least one collective term came from measurement."""
        return ("fitted" if self.compute_fitted and self.fitted_kinds
                else "analytic")

    # -- collective pricing -------------------------------------------------

    def quant_penalty_ms(self, quant: str, nbytes: float) -> float:
        """Analytic quantize-compute charge for a wire mode the report
        did not measure (0 for exact wire or the fitted base mode)."""
        if quant in (None, "", "none") or quant == self.base_quant:
            return 0.0
        return QUANT_COMPUTE_MS_PER_BYTE.get(quant, 0.0) * nbytes

    def collective_ms(self, kind: str, nbytes: float,
                      strategy: str = "ring",
                      stage_sizes: Optional[Sequence[int]] = None,
                      quant: str = "none") -> float:
        """Serial cost of one collective of ``kind`` moving ``nbytes``
        under ``strategy`` and wire mode ``quant``. The per-kind
        (a, b) describe the model's BASE strategy; other spellings
        re-scale through the alpha-beta factors; unmeasured quant
        modes add the analytic quantize-compute penalty."""
        a, b = self.terms.get(kind, self.terms.get("allreduce",
                                                   (DEFAULT_ALPHA_MS, 0.0)))
        pen = self.quant_penalty_ms(quant, nbytes)
        base_ln, base_bw = strategy_factors(self.base_strategy,
                                            self.nranks, stage_sizes)
        launches, bw = strategy_factors(strategy, self.nranks,
                                        stage_sizes)
        if base_ln <= 0 or base_bw <= 0:
            return a + b * nbytes + pen
        # the fitted intercept is the per-launch cost of the BASE
        # spelling; the fitted slope is its per-byte cost at the base
        # busiest-link factor
        alpha = a / base_ln
        beta_unit = b / base_bw
        return alpha * launches + beta_unit * bw * nbytes + pen

    def hide_budget_ms(self, pos: int) -> float:
        """Measured backward compute remaining after compute position
        ``pos``: the budget rule of ``plan_buckets_profile``."""
        return sum(float(ms) for _s, e, ms in self.backward_segments
                   if e > pos)

    # -- whole-schedule scoring ---------------------------------------------

    def predict(self, schedule: Sequence[Dict],
                async_scheduled: bool = False) -> Dict:
        """Predicted step time for a candidate collective schedule.

        ``schedule``: one dict per collective —
        ``{"kind", "bytes", "avail_pos", "strategy"[, "stage_sizes"]}``
        (``avail_pos`` None = nothing to hide behind, e.g. the
        optimizer-phase allgather of a sharded update). Returns
        ``{"step_ms", "compute_ms", "collective_ms", "exposed_ms",
        "overlap_eff", "provenance", "per_collective"}``.

        Exposure rule: a collective overlaps ``overlap_eff`` of
        ``min(cost, hide_budget(avail_pos))`` — the efficiency is the
        report's measured overlap_frac (fitted) or the analytic
        default, plus a bounded bonus when the start / await pass
        schedules the overlap.
        """
        eff = min(1.0, self.overlap_eff
                  + (ASYNC_OVERLAP_BONUS if async_scheduled else 0.0))
        per = []
        coll_total = 0.0
        exposed_total = 0.0
        prov = "fitted" if self.compute_fitted else "analytic"
        for c in schedule:
            quant = c.get("quant", "none")
            nbytes = float(c.get("bytes", 0))
            cost = self.collective_ms(c["kind"], nbytes,
                                      c.get("strategy", "ring"),
                                      c.get("stage_sizes"), quant=quant)
            pos = c.get("avail_pos")
            budget = 0.0 if pos is None else self.hide_budget_ms(pos)
            hidden = eff * min(cost, budget)
            exposed = max(0.0, cost - hidden)
            if self.term_provenance(c["kind"]) == "analytic" \
                    or self.quant_penalty_ms(quant, nbytes) > 0:
                prov = "analytic"
            coll_total += cost
            exposed_total += exposed
            per.append({"kind": c["kind"], "bytes": c.get("bytes", 0),
                        "strategy": c.get("strategy", "ring"),
                        "cost_ms": cost, "hidden_ms": hidden,
                        "exposed_ms": exposed,
                        "provenance": self.term_provenance(c["kind"])})
        return {
            "step_ms": self.compute_ms + self.overhead_ms
            + exposed_total,
            "compute_ms": self.compute_ms,
            "overhead_ms": self.overhead_ms,
            "collective_ms": coll_total,
            "exposed_ms": exposed_total,
            "overlap_eff": eff,
            "provenance": prov,
            "per_collective": per,
        }


# ---------------------------------------------------------------------------
# fitting
# ---------------------------------------------------------------------------


def _fit_line(points: List[Tuple[float, float]]
              ) -> Optional[Tuple[float, float]]:
    """Least-squares ``a + b*x``. One measured point cannot separate
    latency from bandwidth: 10%% of its cost stands in for the intercept
    (splitting is never free)."""
    pts = [(float(x), float(y)) for x, y in points if x > 0 and y > 0]
    if not pts:
        return None
    xs = [p[0] for p in pts]
    ys = [p[1] for p in pts]
    if len(set(xs)) >= 2:
        n = float(len(pts))
        mx = sum(xs) / n
        my = sum(ys) / n
        var = sum((x - mx) ** 2 for x in xs)
        slope = sum((x - mx) * (y - my) for x, y in pts) / var
        icept = my - slope * mx
        if slope <= 0:  # degenerate (noise-dominated) fit
            slope = my / mx if mx else 0.0
            icept = 0.0
        return max(0.0, icept), max(0.0, slope)
    icept = 0.1 * ys[0]
    slope = max(0.0, ys[0] - icept) / xs[0] if xs[0] else 0.0
    return icept, slope


def analytic_cost_model(nranks: int,
                        compute_ms: float = 0.0) -> CostModel:
    """Hand-estimate fallback: ring alpha-beta terms from
    ``DEFAULT_ALPHA_MS`` / ``DEFAULT_BW_GBPS`` for every kind. Every
    score it produces carries ``provenance="analytic"``."""
    n = max(1, int(nranks))
    hops, bw = strategy_factors("ring", n)
    a = DEFAULT_ALPHA_MS * hops
    b = bw / (DEFAULT_BW_GBPS * 1e6)  # ms per byte
    terms = {k: (a, b) for k in ("allreduce", "allgather",
                                 "reducescatter", "ppermute",
                                 "alltoall", "sharded_update")}
    return CostModel(nranks=n, terms=terms, compute_ms=compute_ms,
                     backward_segments=[], fitted_kinds=frozenset(),
                     overlap_eff=DEFAULT_OVERLAP_EFF,
                     compute_fitted=False)


def fit_cost_model(report: Optional[Dict],
                   nranks: Optional[int] = None) -> CostModel:
    """Fit a :class:`CostModel` to a step-profile report; falls back to
    :func:`analytic_cost_model` terms for anything the report cannot
    pin (missing kinds, no compute phases), recording exactly which
    terms were measured. A None/unusable report returns the pure
    analytic model."""
    from ..observability.steering import coerce_report

    report = coerce_report(report) if report is not None else None
    n = int(nranks or (report or {}).get("nranks") or 1)
    base = analytic_cost_model(n)
    if report is None:
        return base

    by_kind: Dict[str, List[Tuple[float, float]]] = {}
    strategies = set()
    quants = set()
    for b in report.get("per_bucket") or []:
        x = float(b.get("bytes") or 0)
        y = float(b.get("collective_ms") or 0)
        if x <= 0 or y <= 0:
            continue
        by_kind.setdefault(b.get("kind") or "allreduce", []).append((x, y))
        strategies.add(b.get("strategy", "ring"))
        quants.add(b.get("quant", "none"))
    terms = dict(base.terms)
    fitted = set()
    for kind, pts in by_kind.items():
        line = _fit_line(pts)
        if line is not None:
            terms[kind] = line
            fitted.add(kind)

    phase_ms = report.get("phase_ms") or {}
    compute_ms = sum(float(v) for k, v in phase_ms.items()
                     if k != "collective" and isinstance(v, (int, float)))
    compute_fitted = compute_ms > 0

    overlap = report.get("overlap_frac")
    eff = (float(overlap) if isinstance(overlap, (int, float))
           and 0.0 < float(overlap) <= 1.0 else DEFAULT_OVERLAP_EFF)
    # fixed per-step overhead: whole-step time minus attributed phases
    # (collective exposure counted at the measured overlap). A report
    # names the whole-step time "step_ms", a record's profile block
    # "profiled_step_ms": both are read.
    overhead = 0.0
    step_ms = report.get("step_ms")
    if not isinstance(step_ms, (int, float)):
        step_ms = report.get("profiled_step_ms")
    if isinstance(step_ms, (int, float)) and compute_fitted:
        exp = report.get("exposed_collective_ms")
        exp = float(exp) if isinstance(exp, (int, float)) else 0.0
        overhead = max(0.0, float(step_ms) - compute_ms - exp)
    # the report measured ONE strategy; record it so transfers re-scale
    base_strategy = strategies.pop() if len(strategies) == 1 else "ring"
    return CostModel(
        nranks=n, terms=terms, compute_ms=compute_ms,
        backward_segments=[s for s in
                           (report.get("backward_segments") or [])
                           if isinstance(s, (list, tuple))
                           and len(s) == 3],
        fitted_kinds=frozenset(fitted),
        base_strategy=base_strategy if base_strategy in
        ("ring", "tree", "two_stage") else "ring",
        overlap_eff=eff, compute_fitted=compute_fitted,
        overhead_ms=overhead,
        base_quant=(quants.pop() if len(quants) == 1 else "none"))
