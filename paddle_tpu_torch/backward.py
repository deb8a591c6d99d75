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
draws the forward's mask. The backward of ``while`` loops comes with the
control-flow ops (ROADMAP.md); a program holding one raises.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set

from . import framework
from .core import dtypes as _dt
from .core.registry import GRAD_SUFFIX, OpInfoMap, ensure_grad_op


def _find_op_path(block, loss_name: str, req: Set[str]) -> List[int]:
    """Indices of ops that both depend on a grad-requiring var and
    contribute to the loss."""
    contributes: Set[str] = set(req)
    fwd_ops: Set[int] = set()
    for i, op in enumerate(block.ops):
        if any(n in contributes for n in op.input_arg_names):
            fwd_ops.add(i)
            contributes.update(op.output_arg_names)
    needed: Set[str] = {loss_name}
    path: List[int] = []
    for i in reversed(range(len(block.ops))):
        op = block.ops[i]
        if i in fwd_ops and any(n in needed for n in op.output_arg_names):
            path.append(i)
            needed.update(op.input_arg_names)
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
    no_grad |= {n if isinstance(n, str) else n.name
                for n in (no_grad_set or ())}
    if any(op.type == "while" for op in block.ops):
        raise NotImplementedError(
            "the backward of while loops is not yet ported (ROADMAP.md, "
            "queue 1)")

    req = _requires_grad_set(block, parameter_list, no_grad)
    # propagate requires-grad forward through the op list
    diffable: Set[str] = set(req)
    for op in block.ops:
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


def make_finalize(block, pending: Dict[str, List[str]]):
    """Finalize closure: merge a var's pending partial grads into its
    canonical @GRAD name (a ``sum`` op) and return that name, or None when
    the var has no grad."""

    def finalize(var_name: str) -> Optional[str]:
        glist = pending.get(var_name)
        if not glist:
            return None
        canonical = grad_name_for(var_name)
        if len(glist) == 1 and glist[0] == canonical:
            return canonical
        _ensure_grad_var(block, var_name, canonical)
        block.append_op("sum", inputs={"X": list(glist)},
                        outputs={"Out": canonical}, infer_shape=False)
        pending[var_name] = [canonical]
        return canonical

    return finalize


def _emit_grad_ops(block, fwd_ops, pending, finalize, diffable, no_grad,
                   recompute_rename=None):
    """Reverse-walk ``fwd_ops`` appending grad ops into ``block``. Forward
    values are read through ``recompute_rename``; grads keep the original
    names."""
    rn = recompute_rename or {}
    for op in reversed(fwd_ops):
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
