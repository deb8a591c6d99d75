"""Collective program rewrites.

Counterpart of ``paddle_tpu/parallel/transpiler.py``: the data-parallel
passes (the reference's ``transpiler/collective.py``: GradAllReduce scales
the loss grad by 1/nranks and allreduces every grad an optimizer op reads;
LocalSGD averages the parameters) and the hybrid passes
(``:113-316``), which swap a user's ops for their collective-aware twins
(``ops/hybrid_parallel_ops.py``) before the backward is built:
``apply_sharded_embedding`` (``lookup_table`` -> ``c_sharded_lookup``
over ``mp``), ``apply_sequence_parallel`` (``flash_attention`` ->
``c_ring_attention`` over ``sp``) and ``apply_expert_parallel`` (``moe``
over ``ep``). Each records the mesh layout on the program:

- ``_var_shard_specs``: var name -> the mesh axis of each dim;
- ``_feed_shard_specs``: feed name -> the mesh axis of each dim;
- ``_data_axes``: the axes the batch splits over (the loss-grad scale and
  the allreduce), merged by every pass, never overwritten;
- ``_allreduce_skip_grads``: the grads of sharded params and their axes.

``ring_id`` stays in the op attrs; at run time the engine maps it to a
group of replicas.
"""
from __future__ import annotations

from typing import Set

from ..core.registry import GRAD_SUFFIX
from ..analysis.contracts import checked_rewrite

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


@checked_rewrite("insert_allreduce")
def insert_allreduce_ops(program, nranks: int, ring_id: int = 0,
                         scale_loss: bool = True, skip_grads=None,
                         axis_grads=None):
    """Rewrite a training program for data parallelism: scale the loss
    grad by 1/nranks and allreduce every grad an optimizer op consumes, in
    place, just before its first optimizer op. Returns the set of grads
    allreduced. A program is rewritten at most once (fleet may transpile
    before the engine sees it). ``skip_grads`` are left alone;
    ``axis_grads`` (grad -> mesh axes) sum over those axes alone, one
    axis after the other."""
    if getattr(program, "_grads_allreduced", False):
        return set()
    program._grads_allreduced = True
    skip = set(skip_grads or ())
    per_axis = dict(axis_grads or {})
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
                if g in grad_names:
                    continue
                if g in per_axis:
                    grad_names.add(g)
                    for a in per_axis[g]:
                        new_ops.append(_new_op(
                            program, block, "c_allreduce_sum", {"X": [g]},
                            {"Out": [g]},
                            {"ring_id": ring_id, "use_calc_stream": True,
                             "_mesh_axis": a}))
                    continue
                if g in skip:
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


def _mark_shard(program, name: str, spec):
    specs = getattr(program, "_var_shard_specs", None)
    if specs is None:
        specs = program._var_shard_specs = {}
    specs[name] = tuple(spec)


def _skip_grad(program, grad_name: str, axes):
    """Record that ``grad_name`` belongs to a param sharded over ``axes``.
    The engine skips its data-axis allreduce only where the shard axis is
    a data axis (expert parallel: the all-to-all's transpose already sums
    every shard's share); a grad sharded over a model axis (an ``mp``
    table block under dp x mp) still needs the psum over dp."""
    skips = getattr(program, "_allreduce_skip_grads", None)
    if skips is None:
        skips = program._allreduce_skip_grads = {}
    skips[grad_name] = tuple(a for a in axes if a)


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


@checked_rewrite("sharded_embedding")
def apply_sharded_embedding(program, axis: str = "mp", degree: int = 0,
                            startup_program=None):
    """Tensor parallelism for embedding tables: every ``lookup_table[_v2]``
    becomes ``c_sharded_lookup`` with its table row-sharded over ``axis``.
    Call before ``minimize()``. Returns the sharded table names.

    An uneven vocab (V % degree != 0) pads the table to the next multiple
    of ``degree`` in both programs (the pad rows are never looked up: their
    grads are zero and the optimizer leaves them at their init), which is
    why the startup program must be given then. ``is_sparse=True`` becomes
    a dense row-sharded grad, with a warning."""
    block = program.global_block()
    tables = []
    for op in block.ops:
        if op.type not in ("lookup_table", "lookup_table_v2"):
            continue
        w = op.input("W")[0]
        v = block._find_var_recursive(w)
        vocab = int(v.shape[0]) if v is not None and v.shape else 0
        if degree and vocab and vocab % degree:
            v_pad = -(-vocab // degree) * degree
            if startup_program is None:
                raise ValueError(
                    "sharded embedding %r: vocab %d not divisible by "
                    "mp degree %d — pass startup_program so the table "
                    "can be padded to %d rows"
                    % (w, v.shape[0], degree, v_pad))
            # grow the table to v_pad rows in both programs
            _resize_var(program, startup_program, w, v,
                        (v_pad,) + tuple(v.shape[1:]))
        if op.attrs.get("is_sparse"):
            import warnings

            warnings.warn(
                "sharded embedding %r: is_sparse=True becomes a dense "
                "row-sharded gradient under tensor parallelism" % w)
        squeeze = op.type == "lookup_table"  # v2 keeps the trailing dim
        op.type = "c_sharded_lookup"
        op.attrs = {"shard_axis": axis,
                    "padding_idx": int(op.attrs.get("padding_idx", -1)),
                    "squeeze_last": squeeze,
                    "vocab_size": vocab}  # the vocab before padding
        _mark_shard(program, w, (axis,))
        _skip_grad(program, w + GRAD_SUFFIX, (axis,))
        tables.append(w)
    _merge_data_axes(program, ("dp",))
    _bump_version(program)
    return tables


def _resize_var(program, startup_program, name, var, new_shape):
    """Give ``name`` the shape ``new_shape`` in both programs: the var
    shapes and every init op's ``shape`` attr."""
    var.shape = tuple(new_shape)
    for blk in (startup_program.global_block(), program.global_block()):
        for op in blk.ops:
            if name in op.output_arg_names and "shape" in op.attrs:
                op.attrs["shape"] = list(new_shape)
    sv = startup_program.global_block()._find_var_recursive(name)
    if sv is not None:
        sv.shape = tuple(new_shape)


@checked_rewrite("sequence_parallel")
def apply_sequence_parallel(program, axis: str = "sp", degree: int = 0,
                            feed_specs=None, startup_program=None):
    """Sequence parallelism: every ``flash_attention`` becomes
    ``c_ring_attention`` over ``axis``. ``feed_specs`` gives the feeds'
    layouts over the mesh, e.g. ``{"x": ("dp", None, "sp")}`` for ``[B, H,
    S, D]``. A ``Lengths`` input is batch-aligned: it is pinned to ``dp``
    (so an sp-only mesh fails on the missing axis, where it would mask
    with the wrong example's length). ``degree`` checks that the
    attention's sequence divides. Call before ``minimize()``.

    A ``layer_norm`` whose axes take in the sequence (``begin_norm_axis``
    1 over ``[B, S, ...]``, as bench.py's gpt_long normalizes over S x D)
    gets its form over ``axis`` (``shard_axis``): its statistics are the
    whole row's. Its Scale and Bias become vars of the dense model's
    shape (``degree`` times the replica's share, in ``startup_program``
    too, default the current one), held as one sequence block a replica
    (``_var_shard_specs``); their grads skip the sum over ``axis`` and sum
    over the other data axes. The program is then the dense model, whose
    persistables it takes unchanged. The JAX pass leaves such a norm as
    it is, so that each replica normalizes its own block: ROADMAP.md
    lists that as a fault of the JAX package."""
    block = program.global_block()
    for op in block.ops:
        if op.type != "layer_norm":
            continue
        x = block._find_var_recursive(op.input("X")[0])
        rank = len(x.shape) if x is not None and x.shape else 0
        if rank < 3 or int(op.attrs.get("begin_norm_axis", 1)) > 1:
            continue
        if not degree:
            raise ValueError(
                "sequence parallel: layer_norm over the sequence of %r "
                "needs the sp degree, to give its Scale and Bias the dense "
                "model's shape" % op.input("X")[0])
        if startup_program is None:
            from .. import framework

            startup_program = framework.default_startup_program()
        op.attrs = dict(op.attrs)
        op.attrs["shard_axis"] = axis
        for name in op.input("Scale") + op.input("Bias"):
            v = block._find_var_recursive(name)
            _resize_var(program, startup_program, name, v,
                        (int(v.shape[0]) * degree,))
            _mark_shard(program, name, (axis,))
            _skip_grad(program, name + GRAD_SUFFIX, (axis,))
            rest = getattr(program, "_allreduce_rest_grads", None)
            if rest is None:
                rest = program._allreduce_rest_grads = set()
            rest.add(name + GRAD_SUFFIX)
    n = 0
    for op in block.ops:
        if op.type != "flash_attention":
            continue
        for ln in op.input("Lengths"):
            fs = getattr(program, "_feed_shard_specs", None)
            if fs is None:
                fs = program._feed_shard_specs = {}
            fs.setdefault(ln, ("dp",))
        if degree:
            q = block._find_var_recursive(op.input("Q")[0])
            if (q is not None and q.shape is not None and len(q.shape) >= 3
                    and q.shape[2] and q.shape[2] % degree):
                raise ValueError(
                    "sequence parallel: attention seq len %d not "
                    "divisible by sp degree %d (Q=%r)"
                    % (q.shape[2], degree, op.input("Q")[0]))
        op.type = "c_ring_attention"
        op.attrs = {"shard_axis": axis,
                    "causal": bool(op.attrs.get("causal")),
                    "scale": float(op.attrs.get("scale", 0.0))}
        n += 1
    if feed_specs:
        fs = getattr(program, "_feed_shard_specs", None)
        if fs is None:
            fs = program._feed_shard_specs = {}
        fs.update({k: tuple(v) for k, v in feed_specs.items()})
    _merge_data_axes(program, ("dp", axis))
    _bump_version(program)
    return n


@checked_rewrite("expert_parallel")
def apply_expert_parallel(program, axis: str = "ep", degree: int = 1):
    """Expert parallelism: every ``moe`` op's experts shard over ``axis``
    and its tokens (the batch) split over the same axis; two all-to-alls
    route the slots. A dense run of the program routes in ``degree``
    chunks, so both drop the same tokens. Call before ``minimize()``."""
    block = program.global_block()
    experts = []
    for op in block.ops:
        if op.type != "moe":
            continue
        w_in, w_out = op.input("WIn")[0], op.input("WOut")[0]
        for w in (w_in, w_out):
            v = block._find_var_recursive(w)
            if v is not None and v.shape and v.shape[0] % degree:
                raise ValueError(
                    "expert parallel %r: %d experts not divisible by "
                    "ep degree %d" % (w, v.shape[0], degree))
            _mark_shard(program, w, (axis,))
            _skip_grad(program, w + GRAD_SUFFIX, (axis,))
        op.attrs = dict(op.attrs)
        op.attrs["shard_axis"] = axis
        op.attrs["num_groups"] = int(degree)
        experts.append((w_in, w_out))
    _merge_data_axes(program, (axis,))
    _bump_version(program)
    return experts


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
