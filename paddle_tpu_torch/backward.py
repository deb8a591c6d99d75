"""Static-graph autodiff: ``append_backward`` and ``gradients``.

Counterpart of ``paddle_tpu/backward.py`` (``append_backward:106``,
``_emit_recompute_ops:149``, ``_append_backward_impl:192``,
``make_finalize:297``, ``_emit_grad_ops:329``, ``gradients:561``): walk
the block's ops on the path from the parameters to the loss in reverse,
append each op's ``<type>_grad`` op (the registry's auto-VJP op, or what
the op's grad maker emits), sum a var's partial grads where it fans out to
several consumers, and respect ``stop_gradient`` and ``no_grad_set``. The
same op sequence, slots and var names as the JAX package, so the two build
the same training program.

Recompute (``checkpoints``): before the grad ops, every op on the path
that writes a name other than a checkpoint is appended again with its
outputs renamed ``<name>@RECOMPUTE``, and the grad ops read those
recomputed values, so only the checkpoints (and what the path reads from
outside) are kept from the forward for the backward. A re-emitted op
carries the original's id as ``_fwd_op_id``, so a recomputed ``dropout``
draws the forward's mask.

``while`` (``_emit_while_grad``, the JAX package's :434): the body's ops
go through the same engine into a grad sub-block, and one ``while_grad``
host op replays the body a saved trip at a time in reverse
(``ops/control_flow_ops.py``). A while op's inputs and outputs for the
path and the diffable set are what its body reads and writes of the
parent's vars (``_op_io``); a float var the body rewrites is no longer
the stop-gradient constant its initializer made (unless the caller's
``no_grad_set`` names it). The body must write each carry once a trip,
after every read of it (the RNN pattern).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set

from . import framework
from .core import dtypes as _dt
from .core.registry import GRAD_SUFFIX, OpInfoMap, ensure_grad_op


def _op_io(block, op):
    """(inputs, outputs) of an op for the dataflow: a while op declares
    no tensors itself, so its body's reads and writes of the parent's
    vars count as its own."""
    if op.type == "while" and op.attrs.get("sub_block") is not None:
        written, read_first = framework.block_rw(op.attrs["sub_block"])
        ins = [n for n in read_first
               if block._find_var_recursive(n) is not None]
        outs = [n for n in written
                if block._find_var_recursive(n) is not None]
        return (list(op.input_arg_names) + ins,
                list(op.output_arg_names) + outs)
    return list(op.input_arg_names), list(op.output_arg_names)


def _find_op_path(block, loss_name: str, req: Set[str]) -> List[int]:
    """Indices of ops that both depend on a grad-requiring var and
    contribute to the loss."""
    contributes: Set[str] = set(req)
    fwd_ops: Set[int] = set()
    for i, op in enumerate(block.ops):
        ins, outs = _op_io(block, op)
        if any(n in contributes for n in ins):
            fwd_ops.add(i)
            contributes.update(outs)
    needed: Set[str] = {loss_name}
    path: List[int] = []
    for i in reversed(range(len(block.ops))):
        ins, outs = _op_io(block, block.ops[i])
        if i in fwd_ops and any(n in needed for n in outs):
            path.append(i)
            needed.update(ins)
    return list(reversed(path))


def _requires_grad_set(block, parameter_list=None, no_grad_set=None) -> Set[str]:
    no_grad = set(no_grad_set or ())
    req: Set[str] = set()
    if parameter_list is not None:
        for p in parameter_list:
            name = p if isinstance(p, str) else p.name
            if name not in no_grad:
                req.add(name)
    else:
        for p in block.program.all_parameters():
            if getattr(p, "trainable", True) and not p.stop_gradient \
                    and p.name not in no_grad:
                req.add(p.name)
    # any non-stop-gradient var is a differentiable leaf too
    for v in block.vars.values():
        if not v.stop_gradient and v.name not in no_grad:
            req.add(v.name)
    return req


def _ensure_grad_var(block, fwd_name: str, grad_name: str):
    if block.has_var_local(grad_name):
        return block.vars[grad_name]
    fwd = block._find_var_recursive(fwd_name)
    # grad vars stay differentiable: a later append_backward over this
    # program (grad of grad) must be able to flow through them
    return block.create_var(
        name=grad_name, shape=fwd.shape if fwd is not None else None,
        dtype=fwd.dtype if fwd is not None else "float32",
        persistable=False, stop_gradient=False)


_PASS_STATE: Dict = {}


def grad_name_for(n: str) -> str:
    """Canonical grad-var name for ``n`` in the current backward pass: the
    plain ``n@GRAD`` unless an earlier pass already owns it."""
    base = framework.grad_var_name(n)
    if _PASS_STATE.get("times", 1) > 1 \
            and base in _PASS_STATE.get("preexisting", ()):
        return "%s@%d" % (base, _PASS_STATE["times"])
    return base


def bind_partial_grad(block, pending, var_name: str) -> str:
    """A fresh partial-grad name for ``var_name``, registered as pending
    (the first is the canonical name, later ones ``@RENAME@<k>``)."""
    if pending.get(var_name):
        gname = "%s@RENAME@%d" % (grad_name_for(var_name),
                                  len(pending[var_name]))
    else:
        gname = grad_name_for(var_name)
    _ensure_grad_var(block, var_name, gname)
    pending.setdefault(var_name, []).append(gname)
    return gname


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    """Append grad ops computing d(loss)/d(var); returns
    ``[(param, param_grad_var)]``. ``checkpoints`` turns on recompute."""
    block = loss.block
    program = block.program
    program._appending_grad_times += 1
    prev = _PASS_STATE.copy()
    _PASS_STATE["times"] = program._appending_grad_times
    _PASS_STATE["preexisting"] = frozenset(
        n for b in program.blocks for n in b.vars)
    try:
        with program._backward_role_guard():
            return _append_backward_impl(loss, block, program,
                                         parameter_list, no_grad_set,
                                         checkpoints)
    finally:
        _PASS_STATE.clear()
        _PASS_STATE.update(prev)


def _emit_recompute_ops(block, path, checkpoints) -> Dict[str, str]:
    """Append renamed copies of the path's forward ops (checkpoint vars and
    vars made outside the path are read as they are); returns the old ->
    new name map the grad ops read forward values through."""
    keep = {c.name if hasattr(c, "name") else str(c) for c in checkpoints}
    rename: Dict[str, str] = {}
    for idx in path:
        op = block.ops[idx]
        if not any(n and n not in keep for n in op.output_arg_names):
            continue  # writes checkpoints only: stored, not recomputed
        new_inputs = {slot: [rename.get(n, n) for n in names]
                      for slot, names in op.inputs.items()}
        new_outputs = {}
        for slot, names in op.outputs.items():
            outs = []
            for n in names:
                if not n:
                    outs.append(n)
                    continue
                # never the original name: a checkpoint's stored value is
                # read under it, and a persistable output (batch norm's
                # running stats) must not update twice
                nn = n + "@RECOMPUTE"
                if nn not in block.vars:
                    v = block._find_var_recursive(n)
                    nv = block.create_var(
                        name=nn, shape=None if v is None else v.shape,
                        dtype="float32" if v is None else v.dtype)
                    nv.stop_gradient = True
                if n not in keep:
                    rename[n] = nn
                outs.append(nn)
            new_outputs[slot] = outs
        attrs = dict(op.attrs)
        attrs.setdefault("_fwd_op_id", op._id or 0)
        block.append_op(op.type, inputs=new_inputs, outputs=new_outputs,
                        attrs=attrs, infer_shape=False)
    return rename


def _append_backward_impl(loss, block, program, parameter_list=None,
                          no_grad_set=None, checkpoints=None):
    no_grad = {v.name for b in program.blocks for v in b.vars.values()
               if v.stop_gradient}
    user_no_grad = {n if isinstance(n, str) else n.name
                    for n in (no_grad_set or ())}
    no_grad |= user_no_grad
    # a float var a while body rewrites carries grads through the loop,
    # though its initializer (fill_constant) made it stop-gradient
    for op in block.ops:
        if op.type == "while" and op.attrs.get("sub_block") is not None:
            for n in framework.block_rw(op.attrs["sub_block"])[0]:
                v = block._find_var_recursive(n)
                if v is not None and _is_float_var(v) \
                        and n not in user_no_grad:
                    no_grad.discard(n)

    req = _requires_grad_set(block, parameter_list, no_grad)
    # propagate requires-grad forward through the op list
    diffable: Set[str] = set(req)
    for op in block.ops:
        if op.type == "while":
            ins, outs = _op_io(block, op)
            if any(n in diffable for n in ins):
                diffable.update(n for n in outs if n not in no_grad)
            continue
        info = _op_info(op.type)
        if info is None or info.grad is None and not _has_grad_op(op.type):
            continue
        if any(n in diffable for n in op.input_arg_names):
            diffable.update(n for n in op.output_arg_names
                            if n not in no_grad)

    path = _find_op_path(block, loss.name, req)
    recompute_rename: Dict[str, str] = {}
    if checkpoints:
        recompute_rename = _emit_recompute_ops(block, path, checkpoints)

    # seed d(loss)/d(loss) = 1
    loss_grad_name = grad_name_for(loss.name)
    _ensure_grad_var(block, loss.name, loss_grad_name)
    block.append_op(
        "fill_constant", inputs={}, outputs={"Out": loss_grad_name},
        attrs={"shape": list(loss.shape or ()), "value": 1.0,
               "dtype": _dt.dtype_to_enum(loss.dtype), "force_cpu": False},
        infer_shape=False)

    pending: Dict[str, List[str]] = {loss.name: [loss_grad_name]}
    finalize = make_finalize(block, pending)
    _emit_grad_ops(block, [block.ops[i] for i in path], pending, finalize,
                   diffable, no_grad, recompute_rename)

    # finalize the leaves (parameters and data): merge their partial grads
    params_and_grads = []
    target_params = (
        [p if isinstance(p, framework.Variable) else block.var(p)
         for p in parameter_list]
        if parameter_list is not None else program.all_parameters())
    for p in target_params:
        g = finalize(p.name)
        if g is not None:
            params_and_grads.append((p, block.var(g)))
    return params_and_grads


def make_finalize(block, pending: Dict[str, List[str]],
                  clear_on_merge: bool = False):
    """Finalize closure: merge a var's pending partial grads into its
    canonical @GRAD name (a ``sum`` op) and return that name, or None when
    the var has no grad. ``clear_on_merge`` empties the pending list after
    the merge: inside a while grad block one name is both a carry's
    incoming grad (used by its writer's grad) and later the partials of
    its pre-trip value, which must not count the first again."""

    def finalize(var_name: str) -> Optional[str]:
        glist = pending.get(var_name)
        if not glist:
            return None
        canonical = grad_name_for(var_name)
        if len(glist) == 1 and glist[0] == canonical:
            if clear_on_merge:
                pending[var_name] = []
            return canonical
        gv = _ensure_grad_var(block, var_name, canonical)
        if all(getattr(block._find_var_recursive(g), "type", "")
               == "selected_rows" for g in glist):
            gv.type = "selected_rows"  # a sum of sparse grads stays sparse
        block.append_op("sum", inputs={"X": list(glist)},
                        outputs={"Out": canonical}, infer_shape=False)
        pending[var_name] = [] if clear_on_merge else [canonical]
        return canonical

    return finalize


def _emit_grad_ops(block, fwd_ops, pending, finalize, diffable, no_grad,
                   recompute_rename=None):
    """Reverse-walk ``fwd_ops`` appending grad ops into ``block``. Forward
    values are read through ``recompute_rename``; grads keep the original
    names."""
    rn = recompute_rename or {}
    for op in reversed(fwd_ops):
        if op.type == "while":
            _emit_while_grad(block, op, pending, finalize, diffable, no_grad)
            continue
        info = _op_info(op.type)
        if info is None:
            continue
        grad_type = op.type + "_grad"
        # a grad maker owns its op's backward entirely
        if callable(info.grad):
            info.grad(block, op, pending, finalize)
            continue
        if not _has_grad_op(op.type):
            continue
        ginfo = OpInfoMap.instance().get(grad_type)

        # which outputs have incoming grads?
        out_grads = {}
        for slot in info.outputs:
            names = op.output(slot.name)
            if not names:
                continue
            gnames = [finalize(n) or "" for n in names]
            if any(gnames):
                out_grads[slot.name + GRAD_SUFFIX] = gnames
        if not out_grads:
            continue

        # inputs: the forward inputs, the outputs' grads, and forward
        # outputs that a hand-written grad op reads by slot name
        g_inputs = {slot.name: [rn.get(n, n) for n in op.input(slot.name)]
                    for slot in info.inputs if op.input(slot.name)}
        g_inputs.update(out_grads)
        for slot in ginfo.inputs:
            if slot.name in g_inputs or slot.name.endswith(GRAD_SUFFIX):
                continue
            if slot.name in op.outputs:
                g_inputs[slot.name] = [rn.get(n, n)
                                       for n in op.outputs[slot.name]]

        # outputs: a fresh partial-grad name per differentiable input var;
        # no_grad slots (labels, lengths) are never bound
        g_outputs = {}
        for slot in info.inputs:
            names = op.input(slot.name)
            if slot.no_grad or not names:
                continue
            gnames = [bind_partial_grad(block, pending, n)
                      if n in diffable and n not in no_grad else ""
                      for n in names]
            if any(gnames):
                g_outputs[slot.name + GRAD_SUFFIX] = gnames
        if not g_outputs:
            continue

        g_attrs = dict(op.attrs)
        g_attrs["_fwd_op_id"] = op._id
        block.append_op(grad_type, g_inputs, g_outputs, g_attrs,
                        infer_shape=False)


def _is_float_var(v) -> bool:
    if v is None or v.dtype is None:
        return True  # unknown: the runtime decides
    return str(v.dtype).startswith(("float", "bfloat"))


def _emit_while_grad(block, op, pending, finalize, diffable, no_grad):
    """The backward of one while op: a grad sub-block built from the body
    by ``_emit_grad_ops``, and one ``while_grad`` op that runs it a saved
    trip at a time, threading the carries' grads and summing the other
    targets' grads over the trips."""
    sub = op.attrs.get("sub_block")
    if sub is None:
        return
    program = block.program
    written_all, read_first = framework.block_rw(sub)
    parent_written = sorted(n for n in written_all
                            if block._find_var_recursive(n) is not None)
    parent_read = sorted(n for n in read_first
                         if block._find_var_recursive(n) is not None)
    carries = sorted(set(parent_written) & set(read_first))

    # the grads of the loop's outputs (their final values), used up here:
    # the ops before the loop get the pre-loop grads from while_grad
    incoming = {}
    for w in parent_written:
        if not _is_float_var(block._find_var_recursive(w)):
            continue
        g = finalize(w)
        if g is not None:
            incoming[w] = g
            pending[w] = []
    if not incoming:
        return

    targets = [r for r in parent_read
               if r in diffable and r not in no_grad
               and _is_float_var(block._find_var_recursive(r))]
    # every float carry threads its grad through the trips, stop-gradient
    # or not: without it each replayed trip would be seeded with the
    # final output's grad
    float_carries = [c for c in carries
                     if _is_float_var(block._find_var_recursive(c))]
    thread_targets = sorted(set(targets) | set(float_carries))
    if not thread_targets:
        return
    no_grad2 = set(no_grad) - set(float_carries)
    diffable2 = set(diffable) | set(thread_targets)
    for bop in sub.ops:
        if any(n in diffable2 for n in bop.input_arg_names):
            diffable2.update(n for n in bop.output_arg_names
                             if n not in no_grad2)

    gblock = program._create_block()
    gblock.forward_block_idx = sub.idx
    pending2: Dict[str, List[str]] = {}
    seed_names = {}
    # every float carry is seeded, with an outer grad or not: a carry with
    # no consumer outside may still pass grad between carries
    seeded = sorted(set(incoming) | set(float_carries))
    for w in seeded:
        gname = grad_name_for(w)
        _ensure_grad_var(gblock, w, gname)
        pending2[w] = [gname]
        seed_names[w] = gname
    finalize2 = make_finalize(gblock, pending2, clear_on_merge=True)
    _emit_grad_ops(gblock, list(sub.ops), pending2, finalize2, diffable2,
                   no_grad2)
    inner_grads = {}
    for r in thread_targets:
        g = finalize2(r)
        if g is not None:
            inner_grads[r] = g
    program._rollback()
    if not inner_grads:
        return

    tgt_list = sorted(inner_grads)
    # grads leave the loop for the diffable targets only; a carry's that
    # is plumbing stays inside
    out_tgt_list = [r for r in tgt_list if r in targets]
    outer_out = [bind_partial_grad(block, pending, r) for r in out_tgt_list]
    gop = framework.Operator(
        block, "while_grad",
        {"OutGrads": [incoming.get(w, "@EMPTY@") for w in seeded]},
        {"InGrads": outer_out},
        {"sub_block": gblock, "fwd_block": sub,
         "snap_var": "@WHILE_SNAPS@%d" % (op._id or 0),
         "written": seeded,
         "seed_names": [seed_names[w] for w in seeded],
         "targets": tgt_list,
         "inner_grads": [inner_grads[r] for r in tgt_list],
         "out_targets": out_tgt_list,
         "carries": carries})
    gop._id = program._next_op_id()
    block.ops.append(gop)


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """``fluid.gradients``: d(targets)/d(inputs), one target, as the JAX
    package takes; None for an input the target does not reach."""
    if not isinstance(targets, (list, tuple)):
        targets = [targets]
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    assert len(targets) == 1, "multi-target gradients arrive with a later wave"
    loss = targets[0]
    block = loss.block
    append_backward(loss, parameter_list=[v.name for v in inputs]
                    if all(isinstance(v, framework.Variable) for v in inputs)
                    else None,
                    no_grad_set=no_grad_set)
    outs = []
    for v in inputs:
        gname = framework.grad_var_name(v.name)
        outs.append(block.var(gname) if block.has_var(gname) else None)
    return outs


def _op_info(op_type):
    try:
        return OpInfoMap.instance().get(op_type)
    except KeyError:
        return None


def _has_grad_op(op_type):
    if OpInfoMap.instance().has(op_type + "_grad"):
        return True
    return ensure_grad_op(op_type)
