"""Control-flow host ops and the tensor arrays.

Counterpart of ``paddle_tpu/ops/control_flow_ops.py``: ``while`` (:82),
``while_grad`` (:125), ``conditional_block`` (:288), the tensor arrays
and their grads (``create_lod_tensor_array``, ``write_to_array``,
``read_from_array``, ``lod_array_length``, ``fill_zero_array_like``,
``write_to_array_grad``, ``read_from_array_grad``; :314-500), ``print``
(:515), ``select_input`` (:537), ``select_output`` (:548) and the level-0
``split_lod_tensor`` / ``merge_lod_tensor`` (:617, :634) that ``IfElse``
uses, which despite their names partition a dense tensor's rows by a
``[N, 1]`` mask. The same slots, attrs and grad makers.

They run on the host against the scope and recurse into sub-blocks
through the executor (``CoreExecutor.run_block``), in a child scope. The
tensors stay on the op's device: the JAX package's host ops go through
numpy, these do not. What a host op must know on the host it reads off
the card, one copy each: a ``while`` reads its ``Condition`` once a trip
(the only read the loop itself takes), ``conditional_block`` its
``Cond``, an array op its index, ``select_input`` / ``select_output``
their mask, and ``split_lod_tensor`` / ``merge_lod_tensor`` index by a
boolean mask, whose row count torch reads back.

``while`` in a training program (``is_test`` False) keeps a snapshot of
every outside value its body reads or writes before each trip, under
``@WHILE_SNAPS@<op id>``; ``while_grad`` replays each trip from it in
reverse, runs the grad sub-block ``append_backward`` built from the body
(``backward._emit_while_grad``), threads the carries' grads to the trip
before and sums the other inputs' grads over the trips. A snapshot holds
references, not copies: every op of the port returns new tensors, and
the one that writes in place (the fused optimizer) runs after the
backward.
"""
from __future__ import annotations

import torch

from ..backward import bind_partial_grad
from ..core.registry import GRAD_SUFFIX, In, Out, register_host_op
from ..core.tensor import LoDTensor, LoDTensorArray

_MAX_TRIPS = 10_000_000


def _as_int(t: torch.Tensor) -> int:
    return int(t.reshape(-1)[0].item())


def _as_bool(t: torch.Tensor) -> bool:
    return bool(t.reshape(-1)[0].item())


def _copy_holder(h):
    """A snapshot of a var's holder: tensors are shared, the wrappers
    (which the ops mutate: an array grows) are new."""
    if isinstance(h, LoDTensor):
        return LoDTensor(h.array, h.lod())
    if isinstance(h, LoDTensorArray):
        return LoDTensorArray(None if item is None else _copy_holder(item)
                              for item in h)
    return h


def _snapshot_names(sub_block):
    from ..framework import block_rw

    written, read_first = block_rw(sub_block)
    return sorted(read_first | written)


def _adopt_locals(scope, kid) -> None:
    """A body writes the parent's vars by name: what the child scope holds
    under a name the parent knows goes to the parent."""
    for name in kid.local_var_names():
        if scope.find_var(name) is not None:
            scope.var(name).set(kid.find_local_var(name).raw())


@register_host_op(
    "while",
    inputs=[In("Condition", no_grad=True),
            In("X", duplicable=True, dispensable=True)],
    outputs=[Out("Out", duplicable=True, dispensable=True),
             Out("StepScopes", dispensable=True)],
    attrs={"sub_block": None, "is_test": False,
           "skip_eager_deletion_vars": []},
)
def _while(executor, op, scope):
    sub_block = op.attrs["sub_block"]
    cond_name = op.input("Condition")[0]
    save = not op.attrs.get("is_test", False)
    snaps = [] if save else None
    snap_names = _snapshot_names(sub_block) if save else ()
    trips = 0
    while _as_bool(executor._read_var(scope, cond_name)):
        if save:
            pre = {}
            for name in snap_names:
                var = scope.find_var(name)
                if var is not None and var.is_initialized():
                    pre[name] = _copy_holder(var.raw())
            snaps.append(pre)
        body = scope.new_scope()
        executor.run_block(sub_block, body)
        _adopt_locals(scope, body)
        scope.drop_kids()
        trips += 1
        if trips > _MAX_TRIPS:
            raise RuntimeError("while op exceeded max trip count")
    if save:
        scope.var("@WHILE_SNAPS@%d" % (op._id or 0)).set(snaps)


def _zeros_like_var(scope, name):
    var = scope.find_var(name)
    if var is None or not var.is_initialized():
        return None
    h = var.raw()
    return torch.zeros_like(h.array) if isinstance(h, LoDTensor) \
        and h.array is not None else None


def _zero_array_like(arr) -> LoDTensorArray:
    return LoDTensorArray(
        None if item is None or getattr(item, "array", None) is None
        else LoDTensor(torch.zeros_like(item.array), item.lod())
        for item in arr)


@register_host_op(
    "while_grad",
    inputs=[In("OutGrads", duplicable=True, dispensable=True,
               no_grad=True)],
    outputs=[Out("InGrads", duplicable=True, dispensable=True)],
    attrs={"sub_block": None, "fwd_block": None, "snap_var": "",
           "written": [], "seed_names": [], "targets": [],
           "inner_grads": [], "out_targets": [], "carries": []},
)
def _while_grad(executor, op, scope):
    """For each saved trip, last first: replay the body from its pre-trip
    snapshot (its temporaries are recomputed, not kept), set the carries
    back to their pre-trip values, seed the written vars' grads, run the
    grad sub-block, then hand each carry's grad to the trip before and
    sum every other target's grad over the trips."""
    grad_block = op.attrs["sub_block"]
    fwd_block = op.attrs["fwd_block"]
    written = list(op.attrs["written"])
    seed_names = list(op.attrs["seed_names"])
    targets = list(op.attrs["targets"])
    inner_grads = list(op.attrs["inner_grads"])
    carries = set(op.attrs["carries"])
    snaps_var = scope.find_var(op.attrs["snap_var"])
    snaps = snaps_var.raw() if (snaps_var is not None
                                and snaps_var.is_initialized()) else []

    carry_g = {}  # the incoming grad of each written var
    for w, gname in zip(written, op.input("OutGrads")):
        if gname and gname != "@EMPTY@":
            v = executor._read_var(scope, gname)
            if v is not None:
                carry_g[w] = v
    param_acc = {}
    # grad arrays sum over the trips: a full-length zero array for each
    # array-valued target, once, then each trip's written grad arrays
    # seed the trip before
    persist_arrays = {}
    for r, iname in zip(targets, inner_grads):
        var = scope.find_var(r)
        if var is not None and isinstance(var.raw(), LoDTensorArray):
            persist_arrays[iname] = _zero_array_like(var.raw())
    for pre in reversed(snaps or []):
        gs = scope.new_scope()
        for name, holder in pre.items():
            gs.var(name).set(_copy_holder(holder))
        for name, holder in persist_arrays.items():
            gs.var(name).set(holder)
        executor.run_block(fwd_block, gs)
        # zero seeds shaped as the post-trip values, taken before the
        # carries go back to their pre-trip values
        post_zero = {}
        for w in written:
            if w not in carry_g:
                z = _zeros_like_var(gs, w)
                if z is not None:
                    post_zero[w] = z
        for c in carries:
            if c in pre:
                gs.var(c).set(_copy_holder(pre[c]))
        for w, sname in zip(written, seed_names):
            g = carry_g.get(w, post_zero.get(w))
            if g is not None:
                executor._write_var(gs, sname, g)
        executor.run_block(grad_block, gs)
        for r, iname in zip(targets, inner_grads):
            # this trip's scope only: a stale grad of an earlier run up
            # the chain would count twice
            var = gs.find_local_var(iname)
            h = var.raw() if var is not None else None
            g = h.array if isinstance(h, LoDTensor) else None
            if r in carries:
                if g is not None:
                    carry_g[r] = g
                else:
                    carry_g.pop(r, None)
            elif g is not None:
                acc = param_acc.get(r)
                param_acc[r] = g if acc is None else acc + g
        # a write-only output is overwritten every trip: only the last
        # trip's write sees the outer grad
        for w in written:
            if w not in carries:
                carry_g.pop(w, None)
        for lname in gs.local_var_names():
            if GRAD_SUFFIX in lname and isinstance(
                    gs.find_local_var(lname).raw(), LoDTensorArray):
                persist_arrays[lname] = gs.find_local_var(lname).raw()
        scope.drop_kid(gs)  # one trip's replay alive at a time

    out_targets = list(op.attrs.get("out_targets", targets))
    inner_of = dict(zip(targets, inner_grads))
    for r, oname in zip(out_targets, op.output("InGrads")):
        if not oname or oname == "@EMPTY@":
            continue
        arr_g = persist_arrays.get(inner_of.get(r, ""))
        if arr_g is not None:
            scope.var(oname).set(arr_g)
            continue
        g = carry_g.get(r) if r in carries else param_acc.get(r)
        if g is None:
            g = _zeros_like_var(scope, r)
        if g is not None:
            executor._write_var(scope, oname, g)


@register_host_op(
    "conditional_block",
    inputs=[In("Cond", no_grad=True),
            In("Input", duplicable=True, dispensable=True)],
    outputs=[Out("Out", duplicable=True, dispensable=True),
             Out("Scope", dispensable=True)],
    attrs={"sub_block": None, "is_scalar_condition": True},
)
def _conditional_block(executor, op, scope):
    if _as_bool(executor._read_var(scope, op.input("Cond")[0])):
        kid = scope.new_scope()
        executor.run_block(op.attrs["sub_block"], kid)
        _adopt_locals(scope, kid)
        scope.drop_kids()


def _array_grad_canonical(block, pending, arr_name):
    """Array grads sum in place into one grad array var, the name every
    maker shares. At its first use in a main-block backward a
    ``fill_zero_array_like`` op makes it fresh, full-length and zero (a
    stale array of an earlier run up the scope chain would sum twice).
    In a while body's grad block (``forward_block_idx`` set) while_grad
    seeds the zero arrays once a run instead: an init op there would wipe
    each trip what the trips sum."""
    from .. import framework

    gname = framework.grad_var_name(arr_name)
    if not block.has_var_local(gname):
        block.create_var(name=gname, shape=None, dtype="float32")
    pending.setdefault(arr_name, [])
    if gname not in pending[arr_name]:
        pending[arr_name].append(gname)
        if block.forward_block_idx < 0:
            block.append_op("fill_zero_array_like", {"X": [arr_name]},
                            {"Out": [gname]}, {}, infer_shape=False)
    return gname


@register_host_op(
    "fill_zero_array_like",
    inputs=[In("X", no_grad=True)],
    outputs=[Out("Out")],
)
def _fill_zero_array_like(executor, op, scope):
    src = scope.find_var(op.input("X")[0]).get_lod_tensor_array()
    scope.var(op.output("Out")[0]).set(_zero_array_like(src))


def _write_to_array_grad_maker(block, op, pending, finalize):
    """write_to_array's X grad: the grad array's entry at I (zeros like X
    where no read used that entry)."""
    g_arr = finalize(op.output("Out")[0])
    if g_arr is None:
        return
    gx = bind_partial_grad(block, pending, op.input("X")[0])
    block.append_op(
        "write_to_array_grad",
        {"X": [op.input("X")[0]], "I": [op.input("I")[0]],
         "ArrGrad": [g_arr]},
        {"X@GRAD": [gx]}, {}, infer_shape=False)


def _read_from_array_grad_maker(block, op, pending, finalize):
    """read_from_array's grad adds Out@GRAD into the grad array at I
    (reads of one entry from several trips sum)."""
    g_out = finalize(op.output("Out")[0])
    if g_out is None:
        return
    g_arr = _array_grad_canonical(block, pending, op.input("X")[0])
    block.append_op(
        "read_from_array_grad",
        {"OutGrad": [g_out], "I": [op.input("I")[0]]},
        {"ArrGrad": [g_arr]}, {}, infer_shape=False)


@register_host_op(
    "write_to_array_grad",
    inputs=[In("X", no_grad=True), In("I", no_grad=True),
            In("ArrGrad", no_grad=True)],
    outputs=[Out("X@GRAD")],
)
def _write_to_array_grad(executor, op, scope):
    i = _as_int(executor._read_var(scope, op.input("I")[0]))
    gvar = scope.find_var(op.input("ArrGrad")[0])
    entry = None
    if gvar is not None and gvar.is_initialized():
        arr = gvar.get_lod_tensor_array()
        if i < len(arr) and arr[i] is not None:
            entry = arr[i]
    if entry is None:
        entry = torch.zeros_like(executor._read_var(scope, op.input("X")[0]))
    executor._write_var(scope, op.output("X@GRAD")[0], entry)


@register_host_op(
    "read_from_array_grad",
    inputs=[In("OutGrad", no_grad=True), In("I", no_grad=True)],
    outputs=[Out("ArrGrad")],
)
def _read_from_array_grad(executor, op, scope):
    i = _as_int(executor._read_var(scope, op.input("I")[0]))
    g = executor._read_var(scope, op.input("OutGrad")[0])
    name = op.output("ArrGrad")[0]
    # this scope first: inside a while_grad trip the summed array was
    # seeded here, and one up the chain is a stale one of an earlier run
    var = scope.find_local_var(name)
    if var is None or not var.is_initialized():
        var = scope.find_var(name)
    if var is None or not var.is_initialized():
        var = scope.var(name)
    arr = var.get_lod_tensor_array()
    while len(arr) <= i:
        arr.append(None)
    if arr[i] is None or getattr(arr[i], "array", None) is None:
        arr[i] = LoDTensor(g)
    else:
        arr[i] = LoDTensor(arr[i].array + g)


@register_host_op(
    "write_to_array",
    inputs=[In("X"), In("I", no_grad=True)],
    outputs=[Out("Out")],
    grad=_write_to_array_grad_maker,
)
def _write_to_array(executor, op, scope):
    i = _as_int(executor._read_var(scope, op.input("I")[0]))
    x_var = scope.find_var(op.input("X")[0])
    # the array up the chain first: inside a while body it lives in the
    # parent scope and grows over the trips
    out_name = op.output("Out")[0]
    var = scope.find_var(out_name) or scope.var(out_name)
    arr = var.get_lod_tensor_array()
    while len(arr) <= i:
        arr.append(None)
    arr[i] = x_var.raw()


@register_host_op(
    "create_lod_tensor_array",
    inputs=[],
    outputs=[Out("Out")],
)
def _create_lod_tensor_array(executor, op, scope):
    """An empty array in this scope, so a while body's writes grow one
    array over the trips."""
    scope.var(op.output("Out")[0]).set(LoDTensorArray())


@register_host_op(
    "read_from_array",
    inputs=[In("X"), In("I", no_grad=True)],
    outputs=[Out("Out")],
    grad=_read_from_array_grad_maker,
)
def _read_from_array(executor, op, scope):
    i = _as_int(executor._read_var(scope, op.input("I")[0]))
    arr = scope.find_var(op.input("X")[0]).get_lod_tensor_array()
    executor._write_var(scope, op.output("Out")[0], arr[i])


@register_host_op(
    "lod_array_length",
    inputs=[In("X", no_grad=True)],
    outputs=[Out("Out")],
)
def _lod_array_length(executor, op, scope):
    arr = scope.find_var(op.input("X")[0]).get_lod_tensor_array()
    executor._write_var(scope, op.output("Out")[0], torch.tensor(
        [len(arr)], dtype=torch.int64, device=executor.device))


def _print_grad_maker(block, op, pending, finalize):
    """The grad passes through unprinted."""
    outs = op.output("Out")
    if not outs:
        return
    g = finalize(outs[0])
    if g is not None:
        pending.setdefault(op.input("In")[0], []).append(g)


@register_host_op(
    "print",
    inputs=[In("In")],
    outputs=[Out("Out", dispensable=True)],
    attrs={"first_n": -1, "message": "", "summarize": 20,
           "print_tensor_name": True, "print_tensor_type": True,
           "print_tensor_shape": True, "print_tensor_lod": True,
           "print_phase": "BOTH", "is_forward": True},
    grad=_print_grad_maker,
)
def _print(executor, op, scope):
    name = op.input("In")[0]
    val = executor._read_var(scope, name)
    arr = val.detach().cpu().numpy()
    summarize = op.attrs.get("summarize", 20)
    flat = arr.reshape(-1)[: summarize if summarize > 0 else None]
    print("%s %s shape=%s dtype=%s data=%s" % (
        op.attrs.get("message", ""), name, arr.shape, arr.dtype, flat))
    outs = op.output("Out")
    if outs:
        executor._write_var(scope, outs[0], val)


@register_host_op(
    "select_input",
    inputs=[In("X", duplicable=True), In("Mask", no_grad=True)],
    outputs=[Out("Out")],
)
def _select_input(executor, op, scope):
    m = _as_int(executor._read_var(scope, op.input("Mask")[0]))
    executor._write_var(scope, op.output("Out")[0],
                        executor._read_var(scope, op.input("X")[m]))


@register_host_op(
    "select_output",
    inputs=[In("X"), In("Mask", no_grad=True)],
    outputs=[Out("Out", duplicable=True)],
)
def _select_output(executor, op, scope):
    m = _as_int(executor._read_var(scope, op.input("Mask")[0]))
    executor._write_var(scope, op.output("Out")[m],
                        executor._read_var(scope, op.input("X")[0]))


def _split_lod_tensor_grad_maker(block, op, pending, finalize):
    """dX = merge(dOutTrue, dOutFalse, mask): each op is the other's
    adjoint."""
    from .. import framework

    g_true = finalize(op.output("OutTrue")[0])
    g_false = finalize(op.output("OutFalse")[0])
    if g_true is None and g_false is None:
        return

    def zeros_like(src_name):
        zname = framework.unique_name.generate(src_name + "@GRAD@ZERO")
        block.create_var(name=zname, dtype="float32")
        block.append_op("fill_zeros_like", {"X": [src_name]},
                        {"Out": [zname]}, {}, infer_shape=False)
        return zname

    if g_true is None:
        g_true = zeros_like(op.output("OutTrue")[0])
    if g_false is None:
        g_false = zeros_like(op.output("OutFalse")[0])
    gname = bind_partial_grad(block, pending, op.input("X")[0])
    block.append_op(
        "merge_lod_tensor",
        {"InTrue": [g_true], "InFalse": [g_false],
         "Mask": [op.input("Mask")[0]]},
        {"Out": [gname]}, {"level": op.attrs.get("level", 0)},
        infer_shape=False)


def _merge_lod_tensor_grad_maker(block, op, pending, finalize):
    """dInTrue, dInFalse = split(dOut, mask)."""
    g_out = finalize(op.output("Out")[0])
    if g_out is None:
        return
    g_true = bind_partial_grad(block, pending, op.input("InTrue")[0])
    g_false = bind_partial_grad(block, pending, op.input("InFalse")[0])
    block.append_op(
        "split_lod_tensor",
        {"X": [g_out], "Mask": [op.input("Mask")[0]]},
        {"OutTrue": [g_true], "OutFalse": [g_false]},
        {"level": op.attrs.get("level", 0)}, infer_shape=False)


def _row_mask(executor, scope, op):
    m = executor._read_var(scope, op.input("Mask")[0])
    return m.reshape(-1).to(torch.bool)


@register_host_op(
    "split_lod_tensor",
    inputs=[In("X"), In("Mask", no_grad=True)],
    outputs=[Out("OutTrue"), Out("OutFalse")],
    attrs={"level": 0},
    grad=_split_lod_tensor_grad_maker,
)
def _split_lod_tensor(executor, op, scope):
    """X's rows where the ``[N, 1]`` mask is true, and where it is not."""
    x = executor._read_var(scope, op.input("X")[0])
    mask = _row_mask(executor, scope, op)
    executor._write_var(scope, op.output("OutTrue")[0], x[mask])
    executor._write_var(scope, op.output("OutFalse")[0], x[~mask])


@register_host_op(
    "merge_lod_tensor",
    inputs=[In("InTrue"), In("InFalse"), In("Mask", no_grad=True),
            In("X", dispensable=True, no_grad=True)],
    outputs=[Out("Out")],
    attrs={"level": 0},
    grad=_merge_lod_tensor_grad_maker,
)
def _merge_lod_tensor(executor, op, scope):
    """The rows of InTrue and InFalse back in the mask's order."""
    t = executor._read_var(scope, op.input("InTrue")[0])
    f = executor._read_var(scope, op.input("InFalse")[0])
    mask = _row_mask(executor, scope, op)
    src = t if t.numel() else f
    out = torch.zeros((mask.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    if t.numel():
        out[mask] = t
    if f.numel():
        out[~mask] = f
    executor._write_var(scope, op.output("Out")[0], out)
