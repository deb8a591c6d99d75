"""Placement: search the parallelism plan instead of hand-picking it.

Counterpart of ``paddle_tpu/placement/``, over the port's rewrites,
verifier and profiler:

- :mod:`.cost_model`: per-collective ``a + b * bytes`` terms fitted to a
  saved step-profile report (hand estimates where none), every score
  tagged ``fitted`` or ``analytic``;
- :mod:`.search`: a beam over the dp / mp / pp / sp / ep factorizations,
  the sharded update, the bucket layout, the reduction spelling,
  per-bucket quantization with error feedback and the async split, every
  candidate rewritten on a fresh program and gated through
  ``verify_program`` and ``check_cross_rank`` before anything runs;
- :mod:`.plan`: the winner as one JSON artifact the engine loads through
  ``PADDLE_TPU_PLACEMENT_PLAN``, written a model by
  ``tools/torch_placement_search.py``.
"""
from __future__ import annotations

from .cost_model import (CostModel, analytic_cost_model,  # noqa: F401
                         fit_cost_model)
from .plan import (PLAN_ENV, PlacementPlan, active_plan,  # noqa: F401
                   load_plan, save_plan)
from .search import (Candidate, derive_quant_buckets,  # noqa: F401
                     enumerate_meshes, model_capabilities,
                     search_placement)

__all__ = [
    "CostModel", "fit_cost_model", "analytic_cost_model",
    "PlacementPlan", "load_plan", "save_plan", "active_plan",
    "PLAN_ENV", "Candidate", "enumerate_meshes", "model_capabilities",
    "search_placement",
]
