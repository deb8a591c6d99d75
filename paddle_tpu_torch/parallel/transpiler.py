"""Collective program rewrites: the data-parallel passes.

Counterpart of the data-parallel half of ``paddle_tpu/parallel/
transpiler.py`` (the reference's ``transpiler/collective.py``: GradAllReduce
scales the loss grad by 1/nranks and allreduces every grad an optimizer op
reads; LocalSGD averages the parameters). ``ring_id`` stays in the op
attrs; at run time the engine maps it to a group of replicas. The hybrid
passes (sharded embedding, sequence and expert parallelism) come with the
hybrid slice (ROADMAP.md), and the contract check around each pass with
the analysis package.
"""
from __future__ import annotations

from typing import Set

from ..core.registry import GRAD_SUFFIX

OPTIMIZER_OP_TYPES = {
    "sgd", "momentum", "lars_momentum", "adam", "adamw", "adamax", "adagrad",
    "decayed_adagrad", "adadelta", "rmsprop", "ftrl", "lamb", "dpsgd",
    "proximal_gd",
}


def _is_loss_grad_seed(op):
    return (op.type == "fill_constant"
            and op.output("Out")
            and op.output("Out")[0].endswith(GRAD_SUFFIX)
            and float(op.attrs.get("value", 0.0)) == 1.0)


def _new_op(program, block, type, inputs, outputs, attrs):
    from .. import framework

    op = framework.Operator(block, type, inputs, outputs, attrs)
    op._id = program._next_op_id()
    return op


def insert_allreduce_ops(program, nranks: int, ring_id: int = 0,
                         scale_loss: bool = True, skip_grads=None):
    """Rewrite a training program for data parallelism: scale the loss
    grad by 1/nranks and allreduce every grad an optimizer op consumes, in
    place, just before its first optimizer op. Returns the set of grads
    allreduced. A program is rewritten at most once (fleet may transpile
    before the engine sees it). ``skip_grads`` are left alone."""
    if getattr(program, "_grads_allreduced", False):
        return set()
    program._grads_allreduced = True
    skip = set(skip_grads or ())
    block = program.global_block()
    if scale_loss:
        for op in block.ops:
            if _is_loss_grad_seed(op):
                op.attrs["value"] = 1.0 / nranks
    grad_names: Set[str] = set()
    new_ops = []
    for op in block.ops:
        if op.type in OPTIMIZER_OP_TYPES:
            for g in op.input("Grad"):
                if g in skip or g in grad_names:
                    continue
                grad_names.add(g)
                new_ops.append(_new_op(
                    program, block, "c_allreduce_sum", {"X": [g]},
                    {"Out": [g]},
                    {"ring_id": ring_id, "use_calc_stream": True}))
        new_ops.append(op)
    block.ops = new_ops
    return grad_names


def insert_local_sgd_ops(program, nranks: int, k_steps: int = 1,
                         ring_id: int = 0):
    """LocalSGD-style parameter averaging: after the optimizer ops every
    parameter is summed over the replicas and scaled by 1/nranks (every
    step, as in the JAX package)."""
    block = program.global_block()
    params = [p.name for p in program.all_parameters()]
    for name in params:
        block.ops.append(_new_op(program, block, "c_allreduce_sum",
                                 {"X": [name]}, {"Out": [name]},
                                 {"ring_id": ring_id}))
        block.ops.append(_new_op(program, block, "scale", {"X": [name]},
                                 {"Out": [name]},
                                 {"scale": 1.0 / nranks, "bias": 0.0}))
    return params


def _bump_version(program):
    # attr-only rewrites must still invalidate the version-keyed caches
    program._next_op_id()


def _merge_data_axes(program, axes):
    """Union (order kept) with the data axes earlier passes recorded."""
    cur = list(getattr(program, "_data_axes", None) or ())
    for a in axes:
        if a not in cur:
            cur.append(a)
    program._data_axes = tuple(cur)


def shard_optimizer_state(program):
    """After minimize(): the accumulators of a sharded param (same shape,
    read by its optimizer op) shard as it does."""
    specs = getattr(program, "_var_shard_specs", None)
    if not specs:
        return
    block = program.global_block()
    for op in block.ops:
        if op.type not in OPTIMIZER_OP_TYPES:
            continue
        params = op.input("Param")
        if not params or params[0] not in specs:
            continue
        spec = specs[params[0]]
        pvar = block._find_var_recursive(params[0])
        pshape = tuple(pvar.shape) if pvar is not None else None
        grads = set(op.input("Grad"))
        for name in op.input_arg_names:
            if name in specs or name == params[0] or name in grads:
                continue
            v = block._find_var_recursive(name)
            if (v is not None and v.shape is not None
                    and tuple(v.shape) == pshape):
                specs[name] = spec


def mark_sync_batch_norm(program, enable=True):
    """``BuildStrategy.sync_batch_norm``: tag the batch_norm ops and their
    grad ops so that their batch statistics reduce over the replicas, in
    the forward and in the backward (the JAX package tags the forward
    alone, so its grad takes local statistics). Applies the current value
    on every call (the engine keys its caches on it)."""
    if getattr(program, "_sync_bn_marked", None) == enable:
        return
    program._sync_bn_marked = enable
    for block in program.blocks:
        for op in block.ops:
            if op.type in ("batch_norm", "batch_norm_grad"):
                op.attrs["_sync_stats"] = bool(enable)
    _bump_version(program)
