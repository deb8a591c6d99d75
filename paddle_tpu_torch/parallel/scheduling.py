"""Collective-schedule knobs over an already-bucketed program.

Counterpart of ``paddle_tpu/parallel/scheduling.py``:

- ``configure_bucket_quant`` (``PADDLE_TPU_QUANT_ERROR_FEEDBACK=1``): the
  ``quant`` attr per bucket op and, for quantized buckets under error
  feedback, a Residual var sharded over the data axis, one rounding-error
  shard a replica.
- ``PADDLE_TPU_REDUCE_STRATEGY=ring|tree|two_stage`` and
  ``PADDLE_TPU_ASYNC_COLLECTIVES=1`` are accepted and leave the program as
  it is (``unchanged_knobs``), as ``BuildStrategy``'s subsumed knobs do.
  The replicas of one process sum in rank order whatever the spelling, so
  tree and two-stage would give the ring's bits, and across processes they
  would add traffic; a start / await split overlaps nothing while each
  reduction completes where it is issued (no async work handles here).
"""
from __future__ import annotations

import os
import warnings
from typing import List, Optional

import torch

from ..core.dtypes import to_torch_dtype
from ..core.tensor import LoDTensor
from ..ops.collective_ops import QUANT_WIRE_ITEMSIZE
from .transpiler import _bump_version
from ..analysis.contracts import checked_rewrite

__all__ = [
    "reduce_strategy_mode", "async_collectives_enabled",
    "quant_error_feedback", "configure_bucket_quant", "unchanged_knobs",
    "warn_unchanged_knobs", "BUCKET_OP_TYPES", "REDUCTION_STRATEGIES",
]

# ops a quant reconfiguration may touch
BUCKET_OP_TYPES = ("c_bucket_allreduce",)

# the JAX package's reduction spellings, accepted by the knob
REDUCTION_STRATEGIES = ("ring", "tree", "two_stage")

_TRUTHY = ("1", "true", "yes", "on")


def reduce_strategy_mode() -> str:
    """``PADDLE_TPU_REDUCE_STRATEGY``: ring (default) | tree | two_stage."""
    raw = os.environ.get("PADDLE_TPU_REDUCE_STRATEGY", "").strip().lower()
    if raw in ("", "auto", "ring"):
        return "ring"
    if raw in REDUCTION_STRATEGIES:
        return raw
    raise ValueError("PADDLE_TPU_REDUCE_STRATEGY=%r (want one of %s)"
                     % (raw, ", ".join(REDUCTION_STRATEGIES)))


def async_collectives_enabled() -> bool:
    raw = os.environ.get("PADDLE_TPU_ASYNC_COLLECTIVES", "").strip()
    return raw.lower() in _TRUTHY


def quant_error_feedback() -> bool:
    raw = os.environ.get("PADDLE_TPU_QUANT_ERROR_FEEDBACK", "").strip()
    return raw.lower() in _TRUTHY


def unchanged_knobs(plan: str = "size") -> List[str]:
    """The schedule knobs set in the environment that the port accepts and
    leaves without effect: a tree or two-stage reduction spelling, the
    async split, and ``plan`` (``PADDLE_TPU_BUCKET_PLAN``) ``profile``,
    which plans by size (no profiler of the port writes the report)."""
    out = []
    if reduce_strategy_mode() != "ring":
        out.append("PADDLE_TPU_REDUCE_STRATEGY=" + reduce_strategy_mode())
    if async_collectives_enabled():
        out.append("PADDLE_TPU_ASYNC_COLLECTIVES=1")
    if plan == "profile":
        out.append("PADDLE_TPU_BUCKET_PLAN=profile")
    return out


_WARNED = set()


def warn_unchanged_knobs(plan: str = "size") -> List[str]:
    """Warn once a process for each knob ``unchanged_knobs`` names."""
    knobs = unchanged_knobs(plan)
    for k in knobs:
        if k not in _WARNED:
            _WARNED.add(k)
            warnings.warn("%s is accepted and leaves the program unchanged"
                          % k, stacklevel=3)
    return knobs


def _bucket_numel(block, scope, op) -> Optional[int]:
    from .collectives import _numel_and_dtype

    total = 0
    for n in op.input("X"):
        k, _dt = _numel_and_dtype(block, scope, n)
        if k is None:
            return None
        total += k
    return total


@checked_rewrite("bucket_quant")
def configure_bucket_quant(program, scope, nranks: int, axis: str,
                           modes=None, error_feedback: bool = False,
                           materialize: bool = True) -> int:
    """``modes``: None keeps each bucket op's quant; a string sets all; a
    sequence sets them in program order. With ``error_feedback`` every
    quantized bucket gets a Residual / ResidualOut var of ``nranks *
    bucket numel`` zeros, sharded over ``axis``. ``materialize=False``
    writes no zeros into the scope. Returns the number of ops changed."""
    block = program.global_block()
    bucket_ops = [op for op in block.ops if op.type in BUCKET_OP_TYPES]
    if not bucket_ops:
        return 0
    if isinstance(modes, str):
        modes = [modes] * len(bucket_ops)
    touched = 0
    for i, op in enumerate(bucket_ops):
        if modes is not None and i < len(modes) and modes[i] is not None:
            mode = modes[i]
            if mode not in QUANT_WIRE_ITEMSIZE:
                raise ValueError("bucket %d: unknown quant mode %r"
                                 % (i, mode))
            if op.attrs.get("quant", "none") != mode:
                op.attrs["quant"] = mode
                touched += 1
        quant = op.attrs.get("quant", "none")
        if error_feedback and quant != "none" and not op.input("Residual"):
            total = _bucket_numel(block, scope, op)
            if total is None:
                continue  # unknown payload: stays exact
            dtype = "float32"
            v = block._find_var_recursive(op.input("X")[0])
            if v is not None and v.dtype:
                dtype = str(v.dtype)
            rname = "bucket_ar_residual_%d" % op._id
            rv = block.create_var(name=rname,
                                  shape=(int(nranks) * int(total),),
                                  dtype=dtype, persistable=True)
            rv.stop_gradient = True
            if materialize and scope is not None:
                from .collectives import _flat_device

                scope.var(rname).set(LoDTensor(torch.zeros(
                    int(nranks) * int(total), dtype=to_torch_dtype(dtype),
                    device=_flat_device(scope, op.input("X"), block))))
            specs = getattr(program, "_var_shard_specs", None)
            if specs is None:
                specs = {}
                program._var_shard_specs = specs
            specs[rname] = (axis,)
            op.inputs["Residual"] = [rname]
            op.outputs["ResidualOut"] = [rname]
            touched += 1
    if touched:
        _bump_version(program)
    return touched
