"""Collective-schedule rewrites over an already-bucketed program.

Counterpart of ``paddle_tpu/parallel/scheduling.py``: three
``@checked_rewrite`` passes, the vocabulary the placement search
(``placement/``) enumerates, each also set by a knob:

- ``schedule_async_collectives`` (``PADDLE_TPU_ASYNC_COLLECTIVES=1``):
  each ``c_bucket_allreduce`` splits into a ``c_bucket_allreduce_start``
  at the bucket's availability point, which reduces into a ``Pending``
  buffer, and a ``c_bucket_allreduce_await`` just before the first op
  that touches a member grad, which slices it back. Over the replicas of
  one process the start completes the reduction where it is issued; over
  a ``torch.distributed`` group it issues it with ``async_op=True`` and
  the await waits on its work handle, so the ops between the pair run
  while the reduction is in flight. With a profile report a bucket with
  no measured backward compute left after it stays whole.
- ``swap_reduction_strategy`` (``PADDLE_TPU_REDUCE_STRATEGY=ring|tree|
  two_stage``): re-spells every bucket reduction without moving an op
  (``ops.collective_ops.strategy_psum``): ``ring`` the one rank-order
  sum, ``tree`` a reduce-scatter and then an all-gather (the ring's bits),
  ``two_stage`` one sum over each data axis of the mesh in turn (another
  association of the same sum: within
  ``analysis.contracts.reassociation_bound`` of the ring's).
- ``configure_bucket_quant`` (``PADDLE_TPU_QUANT_ERROR_FEEDBACK=1``): the
  ``quant`` attr per bucket op and, for quantized buckets under error
  feedback, a Residual var sharded over the data axis, one rounding-error
  shard a replica.
"""
from __future__ import annotations

import bisect
import os
from typing import Dict, List, Optional

import torch

from ..core.dtypes import to_torch_dtype
from ..core.tensor import LoDTensor
from ..ops.collective_ops import QUANT_WIRE_ITEMSIZE, REDUCTION_STRATEGIES
from .transpiler import _bump_version
from ..analysis.contracts import checked_rewrite

__all__ = [
    "reduce_strategy_mode", "async_collectives_enabled",
    "quant_error_feedback", "swap_reduction_strategy",
    "configure_bucket_quant", "schedule_async_collectives",
    "BUCKET_OP_TYPES", "REDUCTION_STRATEGIES",
]

# ops a strategy or quant reconfiguration may touch; the await carries no
# payload and no strategy (it slices the Pending buffer back)
BUCKET_OP_TYPES = ("c_bucket_allreduce", "c_bucket_allreduce_start")

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
    """``PADDLE_TPU_ASYNC_COLLECTIVES=1``: split bucket reductions into
    start / await pairs at a program's first data-parallel run."""
    raw = os.environ.get("PADDLE_TPU_ASYNC_COLLECTIVES", "").strip()
    return raw.lower() in _TRUTHY


def quant_error_feedback() -> bool:
    raw = os.environ.get("PADDLE_TPU_QUANT_ERROR_FEEDBACK", "").strip()
    return raw.lower() in _TRUTHY


# -- the reduction swap -----------------------------------------------------------


@checked_rewrite("reduction_swap")
def swap_reduction_strategy(program, strategy: str) -> int:
    """Re-spell every bucket reduction with ``strategy``: attrs only, no op
    added, removed or moved (the contract holds exactly that). Returns the
    number of ops re-spelled."""
    if strategy not in REDUCTION_STRATEGIES:
        raise ValueError("unknown reduction strategy %r (want one of %s)"
                         % (strategy, ", ".join(REDUCTION_STRATEGIES)))
    n = 0
    changed = False
    for op in program.global_block().ops:
        if op.type not in BUCKET_OP_TYPES:
            continue
        if op.attrs.get("strategy", "ring") != strategy:
            op.attrs["strategy"] = strategy
            changed = True
        n += 1
    if changed:
        _bump_version(program)
    return n


# -- per-bucket quantization and error-feedback residuals ----------------------------


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


# -- the async start / await split ---------------------------------------------------


def _measured_slack_ok(report, compute_pos, anchor_idx) -> bool:
    """With a report: is measured backward compute left after this
    bucket's availability point? A tail bucket (none left) stays whole."""
    if report is None:
        return True
    segs = [s for s in (report.get("backward_segments") or [])
            if isinstance(s, (list, tuple)) and len(s) == 3]
    if not segs:
        return True
    pos = compute_pos[anchor_idx]
    return any(float(ms) > 0 and end > pos for _s, end, ms in segs)


@checked_rewrite("async_collective")
def schedule_async_collectives(program, report=None, scope=None) -> int:
    """Split each ``c_bucket_allreduce`` into a start / await pair: the
    start stays at the bucket's availability point, the await lands just
    before the first later op that touches a member grad (a reader would
    see the unreduced value; a writer between the pair would be overwritten
    by the await). A bucket with no room (its first toucher follows it, or
    the report measures no backward compute after it) stays whole. Returns
    the number of buckets split; ``program._async_schedule`` records the
    decision."""
    if getattr(program, "_async_scheduled", False):
        return 0
    program._async_scheduled = True
    from .. import framework
    from .collectives import _numel_and_dtype

    block = program.global_block()
    ops = block.ops
    cand = [i for i, op in enumerate(ops) if op.type == "c_bucket_allreduce"]
    if not cand:
        program._async_schedule = {"split": 0, "kept": 0}
        return 0
    touched_at: Dict[str, List[int]] = {}
    for j, op in enumerate(ops):
        for nm in set(op.input_arg_names) | set(op.output_arg_names):
            touched_at.setdefault(nm, []).append(j)
    # positions in the collective-free op sequence, the report's
    # coordinates; a report of another program shape is ignored
    compute_pos = []
    k = 0
    for op in ops:
        compute_pos.append(k)
        if not op.type.startswith("c_"):
            k += 1
    if report is not None and int(report.get("n_compute") or -1) != k:
        report = None

    split = kept = 0
    replace_at: Dict[int, object] = {}  # bucket index -> its start op
    before: Dict[int, List] = {}  # op index -> the awaits placed before it
    tail: List = []  # awaits with no later toucher
    for i in cand:
        op = ops[i]
        members = op.input("X")
        first_use = len(ops)
        for g in members:
            c = touched_at.get(g, ())
            kk = bisect.bisect_right(c, i)
            if kk < len(c):
                first_use = min(first_use, c[kk])
        total, dtype, unknown = 0, None, False
        for g in members:
            n_el, dt = _numel_and_dtype(block, scope, g)
            if n_el is None:
                unknown = True
                break
            total += n_el
            dtype = dtype or dt
        if (unknown or first_use <= i + 1
                or not _measured_slack_ok(report, compute_pos, i)):
            kept += 1
            continue
        pname = "bucket_ar_pending_%d" % op._id
        pv = block.create_var(name=pname, shape=(int(total),),
                              dtype=dtype or "float32")
        pv.stop_gradient = True
        s_in = {"X": list(members)}
        s_out = {"Pending": [pname]}
        if op.input("Residual"):
            s_in["Residual"] = list(op.input("Residual"))
            s_out["ResidualOut"] = list(op.output("ResidualOut"))
        start = framework.Operator(
            block, "c_bucket_allreduce_start", s_in, s_out,
            {"ring_id": op.attrs.get("ring_id", 0),
             "quant": op.attrs.get("quant", "none"),
             "strategy": op.attrs.get("strategy", "ring"),
             "use_calc_stream": True})
        start._id = program._next_op_id()
        await_op = framework.Operator(
            block, "c_bucket_allreduce_await",
            {"Pending": [pname], "X": list(members)},
            {"Out": list(members)},
            {"ring_id": op.attrs.get("ring_id", 0),
             "use_calc_stream": True})
        await_op._id = program._next_op_id()
        replace_at[i] = start
        if first_use < len(ops):
            before.setdefault(first_use, []).append(await_op)
        else:
            tail.append(await_op)
        split += 1
    if split:
        new_ops = []
        for i, op in enumerate(ops):
            new_ops.extend(before.get(i, ()))
            new_ops.append(replace_at.get(i, op))
        new_ops.extend(tail)
        block.ops = new_ops
        _bump_version(program)
    program._async_schedule = {"split": split, "kept": kept}
    from .. import observability as _obs

    _obs.inc("parallel.async_buckets", split, state="split")
    if kept:
        _obs.inc("parallel.async_buckets", kept, state="kept")
    return split
