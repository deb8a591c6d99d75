"""Tensor creation / shaping / indexing ops.

Counterparts of ``fill_constant`` (:31), ``uniform_random`` (:69),
``gaussian_random`` (:90), ``truncated_gaussian_random`` (:107),
``assign`` (:120), ``assign_value`` (:132),
``reshape2`` (:224), ``transpose2`` (:248), ``expand`` (:483), ``gather``
(:575), ``lookup_table`` (:680), ``lookup_table_v2`` (:694), ``concat``
(:384), ``slice`` (:439), ``where`` (:882), ``range`` (:954),
``fill_zeros_like`` (:150), ``squeeze2`` (:357), ``unsqueeze2`` (:371),
``stack`` (:417), ``one_hot`` (:742) and ``top_k`` (:798) in
``paddle_tpu/ops/tensor_ops.py`` and ``gather_tree``
(``paddle_tpu/ops/misc_ops.py:638``, the beam backtrace over ``[T, B,
W]``), with the same slots and attrs, and of
``lookup_table``'s grad maker and the dense ``lookup_table_grad`` and
``lookup_table_v2_grad`` (:631-677), whose scatter-add becomes
``index_add_``; under ``is_sparse`` the grad maker emits the host op
``lookup_table_sparse_grad`` (:715), whose W@GRAD is a ``SelectedRows``
(rows the looked-up ids, values Out@GRAD's rows), and
``merge_selected_rows`` (:983) sums a SelectedRows' duplicate rows and
``get_tensor_from_selected_rows`` (:999) returns its value rows. ``split``
(:395), ``shape`` (:770) and ``is_empty``
(``paddle_tpu/ops/tail_ops3.py:120``) are the JAX ops' too.
``gather``'s auto-VJP grad is a
scatter-add too (autograd's ``index_select`` backward), so repeated
indices sum. ``range`` is a host op, as in the JAX package (its output's
length depends on its inputs' values). Creation
ops build on the executor's device (``DEVICE_ATTR``); ``uniform_random``
draws from the seeded ``torch.Generator`` the executor hands it
(``GENERATOR_ATTR``), and so do ``gaussian_random`` and
``truncated_gaussian_random`` (a standard normal cut at two standard
deviations, drawn by the inverse CDF as ``jax.random.truncated_normal``
draws it), so the numbers differ from ``jax.random``'s but the
distribution is the same.

``top_k`` breaks ties as ``jax.lax.top_k`` does, the lower index first
(``torch.topk`` promises no order among equal values on the card, and a
finished beam offers V-1 candidates of equal score): over floating
values it takes ``torch.topk`` of unique int64 keys, the value's bits
mapped to an integer that orders as the floats do, above the index
reversed; other types go through a stable descending sort.
"""
from __future__ import annotations

import builtins
import math

import numpy as np
import torch

from ..core import dtypes as _dt
from ..backward import bind_partial_grad
from ..core.registry import (DEVICE_ATTR, GENERATOR_ATTR, In, Out,
                             register_host_op, register_op)
from ..core.tensor import LoDTensor, SelectedRows


@register_op(
    "fill_constant",
    inputs=[In("ShapeTensor", dispensable=True, no_grad=True),
            In("ValueTensor", dispensable=True, no_grad=True)],
    outputs=[Out("Out")],
    attrs={"shape": [], "dtype": 5, "value": 0.0, "force_cpu": False,
           "str_value": ""},
    grad=None,
)
def _fill_constant(ins, attrs):
    dt = _dt.to_torch_dtype(attrs["dtype"])
    shape = tuple(attrs["shape"])
    val = ins.get("ValueTensor")
    if val is None:
        sval = attrs.get("str_value", "")
        fill = float(sval) if sval else attrs.get("value", 0.0)
        out = torch.full(shape, fill, dtype=dt, device=attrs[DEVICE_ATTR])
    else:
        out = val.reshape(()).to(dt).expand(shape).clone()
    return {"Out": out}


@register_op(
    "uniform_random",
    inputs=[In("ShapeTensor", dispensable=True, no_grad=True)],
    outputs=[Out("Out")],
    attrs={"shape": [], "min": -1.0, "max": 1.0, "seed": 0, "dtype": 5},
    grad=None,
    needs_rng=True,
)
def _uniform_random(ins, attrs):
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    u = torch.rand(tuple(attrs["shape"]), generator=attrs[GENERATOR_ATTR],
                   dtype=torch.float32, device=attrs[DEVICE_ATTR])
    return {"Out": (u * (hi - lo) + lo).to(_dt.to_torch_dtype(attrs["dtype"]))}


@register_op(
    "gaussian_random",
    inputs=[],
    outputs=[Out("Out")],
    attrs={"shape": [], "mean": 0.0, "std": 1.0, "seed": 0, "dtype": 5},
    grad=None,
    needs_rng=True,
)
def _gaussian_random(ins, attrs):
    out = torch.randn(tuple(attrs["shape"]),
                      generator=attrs.get(GENERATOR_ATTR),
                      dtype=torch.float32, device=attrs[DEVICE_ATTR])
    out = out * attrs.get("std", 1.0) + attrs.get("mean", 0.0)
    return {"Out": out.to(_dt.to_torch_dtype(attrs["dtype"]))}


@register_op(
    "truncated_gaussian_random",
    inputs=[],
    outputs=[Out("Out")],
    attrs={"shape": [], "mean": 0.0, "std": 1.0, "seed": 0, "dtype": 5},
    grad=None,
    needs_rng=True,
)
def _truncated_gaussian_random(ins, attrs):
    # u uniform over [erf(-2 / sqrt2), erf(2 / sqrt2)), then sqrt2 *
    # erfinv(u), kept strictly inside (-2, 2)
    sqrt2 = 2.0 ** 0.5
    lo, hi = math.erf(-2.0 / sqrt2), math.erf(2.0 / sqrt2)
    u = torch.rand(tuple(attrs["shape"]), generator=attrs.get(GENERATOR_ATTR),
                   dtype=torch.float32, device=attrs[DEVICE_ATTR])
    z = torch.erfinv(u * (hi - lo) + lo) * sqrt2
    edge = math.nextafter(2.0, 0.0)
    z = torch.clamp(z, -edge, edge)
    out = z * attrs.get("std", 1.0) + attrs.get("mean", 0.0)
    return {"Out": out.to(_dt.to_torch_dtype(attrs["dtype"]))}


def _reshape_shape(x, shape_attr):
    """0 copies the input's dim at that position; -1 is inferred."""
    shape = list(shape_attr)
    for i, s in enumerate(shape):
        if s == 0:
            shape[i] = x.shape[i]
    return shape


def _xshape(x):
    # the pre-op shape behind a leading 0, kept for slot parity
    return torch.empty((0,) + tuple(x.shape), dtype=x.dtype, device=x.device)


@register_op(
    "reshape2",
    inputs=[In("X"), In("Shape", dispensable=True, no_grad=True),
            In("ShapeTensor", dispensable=True, no_grad=True,
               duplicable=True)],
    outputs=[Out("Out"), Out("XShape", no_grad=True)],
    attrs={"shape": []},
)
def _reshape2(ins, attrs):
    x = ins["X"]
    return {"Out": x.reshape(_reshape_shape(x, attrs["shape"])),
            "XShape": _xshape(x)}


@register_op(
    "transpose2",
    inputs=[In("X")],
    outputs=[Out("Out"), Out("XShape", no_grad=True)],
    attrs={"axis": []},
)
def _transpose2(ins, attrs):
    # a view: consumers that need contiguous memory (the flash kernel)
    # ask for it themselves
    x = ins["X"]
    return {"Out": x.permute(*attrs["axis"]), "XShape": _xshape(x)}


def _wrap_ids(ids, rows):
    """Ids with [-V, 0) counted from the end, and where they fall in
    [0, V)."""
    wrapped = torch.where(ids < 0, ids + rows, ids)
    return wrapped, (wrapped >= 0) & (wrapped < rows)


def _lookup_table_grad_maker(block, op, pending, finalize):
    """W's grad: the dense ``lookup_table_grad`` op, or under
    ``is_sparse`` the host op ``lookup_table_sparse_grad``, whose grad var
    is typed ``selected_rows`` (so the fused optimizer pass leaves its
    update alone)."""
    og = finalize(op.output("Out")[0])
    if og is None:
        return
    w = op.input("W")[0]
    gname = bind_partial_grad(block, pending, w)
    sparse = bool(op.attrs.get("is_sparse"))
    if sparse:
        block.var(gname).type = "selected_rows"
    block.append_op(
        "lookup_table_sparse_grad" if sparse else op.type + "_grad",
        {"W": [w], "Ids": [op.input("Ids")[0]], "Out@GRAD": [og]},
        {"W@GRAD": [gname]},
        {"padding_idx": op.attrs.get("padding_idx", -1),
         "is_v2": op.type == "lookup_table_v2"},
        infer_shape=False)


def _lookup_table_grad(ins, attrs):
    """dW: the rows of Out@GRAD summed into the rows of W they were read
    from (``index_add_``, which on the card sums in no fixed order).
    Rows read at ``padding_idx`` contribute nothing, nor do ids outside
    [-V, V), as JAX's scatter drops them."""
    w, ids, og = ins["W"], ins["Ids"], ins["Out@GRAD"]
    if not attrs.get("is_v2") and ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    rows = w.shape[0]
    wrapped, keep = _wrap_ids(ids, rows)
    pad = attrs.get("padding_idx", -1)
    if pad is not None and pad >= 0:
        keep = keep & (ids != pad)
    flat = (og.to(w.dtype) * keep[..., None].to(w.dtype)).reshape(
        -1, w.shape[-1])
    g = torch.zeros_like(w)
    g.index_add_(0, wrapped.clamp(0, rows - 1).reshape(-1), flat)
    return {"W@GRAD": g}


for _lt_gtype, _lt_v2 in (("lookup_table_grad", False),
                          ("lookup_table_v2_grad", True)):
    register_op(
        _lt_gtype,
        inputs=[In("W", no_grad=True), In("Ids", no_grad=True),
                In("Out@GRAD", no_grad=True)],
        outputs=[Out("W@GRAD")],
        attrs={"padding_idx": -1, "is_v2": _lt_v2},
        grad=None,
    )(_lookup_table_grad)


@register_host_op(
    "lookup_table_sparse_grad",
    inputs=[In("W", no_grad=True), In("Ids", no_grad=True),
            In("Out@GRAD", no_grad=True)],
    outputs=[Out("W@GRAD")],
    attrs={"padding_idx": -1, "is_v2": False},
)
def _lookup_table_sparse_grad(executor, op, scope):
    """W's grad as a SelectedRows: the looked-up ids as rows (read to the
    host, where a SelectedRows keeps them) and Out@GRAD's rows as values,
    without the rows read at ``padding_idx``; the values stay on the
    device."""
    w = executor._read_var(scope, op.input("W")[0])
    ids = executor._read_var(scope, op.input("Ids")[0])
    og = executor._read_var(scope, op.input("Out@GRAD")[0])
    if not op.attrs.get("is_v2") and ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids[..., 0]
    rows = ids.reshape(-1)
    vals = og.reshape(-1, w.shape[-1]).to(w.dtype)
    pad = op.attrs.get("padding_idx", -1)
    if pad is not None and pad >= 0:
        keep = rows != pad
        rows, vals = rows[keep], vals[keep]
    executor._write_var(scope, op.output("W@GRAD")[0], SelectedRows(
        rows=rows, height=int(w.shape[0]), value=LoDTensor(vals)))


@register_host_op(
    "merge_selected_rows",
    inputs=[In("X", no_grad=True)],
    outputs=[Out("Out")],
)
def _merge_selected_rows(executor, op, scope):
    """A SelectedRows with each row once, duplicates summed."""
    sr = scope.find_var(op.input("X")[0]).raw()
    if not isinstance(sr, SelectedRows):
        raise TypeError("merge_selected_rows expects SelectedRows input")
    vals = sr.get_tensor().array
    uniq, inv = np.unique(np.asarray(sr.rows(), dtype=np.int64),
                          return_inverse=True)
    merged = torch.zeros((len(uniq),) + tuple(vals.shape[1:]),
                         dtype=vals.dtype, device=vals.device).index_add_(
        0, torch.from_numpy(inv.reshape(-1)).to(vals.device), vals)
    scope.var(op.output("Out")[0]).set(SelectedRows(
        rows=uniq.tolist(), height=sr.height(), value=LoDTensor(merged)))


@register_host_op(
    "get_tensor_from_selected_rows",
    inputs=[In("X", no_grad=True)],
    outputs=[Out("Out")],
)
def _get_tensor_from_selected_rows(executor, op, scope):
    """A SelectedRows' value rows as a dense tensor."""
    sr = scope.find_var(op.input("X")[0]).raw()
    if not isinstance(sr, SelectedRows):
        raise TypeError("expects SelectedRows input")
    executor._write_var(scope, op.output("Out")[0], sr.get_tensor().array)


@register_op(
    "split",
    inputs=[In("X")],
    outputs=[Out("Out", duplicable=True)],
    attrs={"num": 0, "sections": [], "axis": 0},
)
def _split(ins, attrs):
    """X cut along ``axis`` into ``num`` equal parts, or into
    ``sections`` (one of which may be -1, the rest)."""
    x = ins["X"]
    axis = attrs.get("axis", 0)
    sections = list(attrs.get("sections") or [])
    if sections:
        known = builtins.sum(s for s in sections if s > 0)
        sections = [s if s > 0 else int(x.shape[axis]) - known
                    for s in sections]
        return {"Out": list(torch.split(x, sections, dim=axis))}
    num, size = attrs["num"], int(x.shape[axis])
    if size % num:
        raise ValueError("split: dim %d of size %d does not divide into %d"
                         % (axis, size, num))
    return {"Out": list(torch.split(x, size // num, dim=axis))}


@register_op(
    "shape",
    inputs=[In("Input", no_grad=True)],
    outputs=[Out("Out")],
    grad=None,
)
def _shape(ins, attrs):
    """Input's dims, int32 (the JAX package's type)."""
    x = ins["Input"]
    return {"Out": torch.tensor(list(x.shape), dtype=torch.int32,
                                device=x.device)}


@register_op(
    "is_empty",
    inputs=[In("X", no_grad=True)],
    outputs=[Out("Out")],
    grad=None,
)
def _is_empty(ins, attrs):
    """A bool scalar: X holds no element."""
    x = ins["X"]
    return {"Out": torch.tensor(x.numel() == 0, device=x.device)}


@register_op(
    "lookup_table",
    inputs=[In("W"), In("Ids", no_grad=True)],
    outputs=[Out("Out")],
    attrs={"padding_idx": -1, "is_sparse": False, "is_distributed": False,
           "remote_prefetch": False},
    grad=_lookup_table_grad_maker,
)
def _lookup_table(ins, attrs):
    """Rows of W at Ids (a trailing Ids dim of 1 is dropped). Rows at
    ``padding_idx`` are zero. As with ``jnp.take``, an id in [-V, 0)
    counts from the end and any other id outside [0, V) gives a NaN row;
    it never faults the device."""
    ids = ins["Ids"]
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    return {"Out": _embedding_lookup(ins["W"], ids,
                                     attrs.get("padding_idx", -1))}


@register_op(
    "lookup_table_v2",
    inputs=[In("W"), In("Ids", no_grad=True)],
    outputs=[Out("Out")],
    attrs={"padding_idx": -1, "is_sparse": False, "is_distributed": False},
    grad=_lookup_table_grad_maker,
)
def _lookup_table_v2(ins, attrs):
    """``lookup_table`` without the squeeze: Out is Ids' shape plus W's
    row (the dygraph ``Embedding``'s op)."""
    return {"Out": _embedding_lookup(ins["W"], ins["Ids"],
                                     attrs.get("padding_idx", -1))}


def _embedding_lookup(w, ids, pad):
    rows = w.shape[0]
    wrapped, in_range = _wrap_ids(ids, rows)
    out = torch.nn.functional.embedding(wrapped.clamp(0, rows - 1), w)
    out = torch.where(in_range[..., None], out,
                      torch.full_like(out, float("nan")))
    if pad is not None and pad >= 0:
        out = out * (ids != pad)[..., None].to(out.dtype)
    return out


@register_op("assign", inputs=[In("X")], outputs=[Out("Out")])
def _assign(ins, attrs):
    # a copy: the fused optimizer updates parameters in place
    return {"Out": ins["X"].clone()}


@register_op(
    "assign_value",
    inputs=[],
    outputs=[Out("Out")],
    attrs={"shape": [], "dtype": 5, "fp32_values": [], "int32_values": [],
           "int64_values": [], "bool_values": []},
    grad=None,
)
def _assign_value(ins, attrs):
    dt = _dt.to_torch_dtype(attrs["dtype"])
    shape = tuple(attrs["shape"])
    dev = attrs[DEVICE_ATTR]
    for k in ("fp32_values", "int32_values", "int64_values", "bool_values"):
        vals = attrs.get(k)
        if vals:
            # built on the host, then one copy to the device
            return {"Out": torch.tensor(vals).to(dt).reshape(shape).to(dev)}
    return {"Out": torch.zeros(shape, dtype=dt, device=dev)}


@register_op(
    "expand",
    inputs=[In("X"), In("ExpandTimes", dispensable=True, no_grad=True)],
    outputs=[Out("Out")],
    attrs={"expand_times": []},
)
def _expand(ins, attrs):
    """``np.tile``: X repeated ``expand_times[i]`` times along dim i (a
    shorter list repeats the trailing dims)."""
    x = ins["X"]
    times = list(attrs["expand_times"])
    times = [1] * (x.dim() - len(times)) + times
    return {"Out": x.repeat(*times)}


@register_op(
    "gather",
    inputs=[In("X"), In("Index", no_grad=True)],
    outputs=[Out("Out")],
    attrs={"overwrite": True},
)
def _gather(ins, attrs):
    """Rows of X at the flattened Index, as ``jnp.take(X, Index, axis=0)``:
    an index in [-N, 0) counts from the end, any other outside [0, N)
    gives a NaN row (a float X) and no grad."""
    x, idx = ins["X"], ins["Index"].reshape(-1)
    rows = x.shape[0]
    wrapped, in_range = _wrap_ids(idx, rows)
    out = torch.index_select(x, 0, wrapped.clamp(0, rows - 1))
    if x.is_floating_point():
        fill = torch.full_like(out, float("nan"))
        keep = in_range.reshape((-1,) + (1,) * (x.dim() - 1))
        out = torch.where(keep, out, fill)
    return {"Out": out}


@register_op(
    "concat",
    inputs=[In("X", duplicable=True),
            In("AxisTensor", dispensable=True, no_grad=True)],
    outputs=[Out("Out")],
    attrs={"axis": 0},
)
def _concat(ins, attrs):
    """The X list joined along ``axis`` (negative counts from the end).
    The JAX op never reads ``AxisTensor``; here a bound one raises rather
    than being ignored."""
    if ins.get("AxisTensor") is not None:
        raise NotImplementedError(
            "concat's AxisTensor input is not supported; set the axis attr")
    return {"Out": torch.cat(list(ins["X"]), dim=attrs.get("axis", 0))}


@register_op(
    "slice",
    inputs=[In("Input"), In("StartsTensor", dispensable=True, no_grad=True),
            In("EndsTensor", dispensable=True, no_grad=True)],
    outputs=[Out("Out")],
    attrs={"axes": [], "starts": [], "ends": [], "decrease_axis": [],
           "infer_flags": []},
)
def _slice(ins, attrs):
    """Input[starts:ends] along ``axes``: a negative bound counts from the
    end (clamped at 0), one past the dim clamps to it; the axes in
    ``decrease_axis`` are squeezed away. As the JAX op, it reads the
    attrs only (not ``StartsTensor`` / ``EndsTensor``)."""
    x = ins["Input"]
    idx = [builtins.slice(None)] * x.dim()
    for ax, st, en in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        d = x.shape[ax]
        st = max(st + d, 0) if st < 0 else min(st, d)
        en = max(en + d, 0) if en < 0 else min(en, d)
        idx[ax] = builtins.slice(st, en)
    out = x[tuple(idx)]
    dec = attrs.get("decrease_axis") or []
    if dec:
        if any(out.shape[a] != 1 for a in dec):
            raise ValueError("slice: decrease_axis %s of a slice of shape "
                             "%s is not of size 1" % (dec, tuple(out.shape)))
        out = out.squeeze(tuple(dec))
    return {"Out": out}


@register_host_op(
    "range",
    inputs=[In("Start", no_grad=True), In("End", no_grad=True),
            In("Step", no_grad=True)],
    outputs=[Out("Out")],
    const_foldable=True,
)
def _range(executor, op, scope):
    """``np.arange(start, end, step)`` in Start's type, on Start's device.
    The output's length depends on the inputs' values, so this is a host
    op (as in the JAX package): reading the three scalars off the card
    (one copy) waits for the work queued before them. With constant
    inputs the whole-program route folds it (``core/compiler_engine``)."""
    start, end, step = (executor._read_var(scope, op.input(s)[0])
                        for s in ("Start", "End", "Step"))
    vals = torch.cat([t.reshape(1).to(start.dtype)
                      for t in (start, end, step)]).tolist()
    executor._write_var(scope, op.output("Out")[0], torch.arange(
        *vals, dtype=start.dtype, device=start.device))


@register_op(
    "where",
    inputs=[In("Condition", no_grad=True), In("X"), In("Y")],
    outputs=[Out("Out")],
)
def _where(ins, attrs):
    return {"Out": torch.where(ins["Condition"], ins["X"], ins["Y"])}


@register_op(
    "fill_zeros_like",
    inputs=[In("X", no_grad=True)],
    outputs=[Out("Out")],
    grad=None,
)
def _fill_zeros_like(ins, attrs):
    return {"Out": torch.zeros_like(ins["X"])}


def _squeeze_axes(x, explicit, op_name):
    """The axes squeeze drops: every size-1 dim when none are listed,
    else the listed ones (in [-ndim, ndim), each of size 1; at shape
    inference an unknown dim passes), as the JAX package resolves them."""
    from ..framework import _SENTINEL

    if not explicit:
        return sorted(i for i, d in enumerate(x.shape) if d == 1)
    axes = set()
    for a in (int(a) for a in explicit):
        if not -x.dim() <= a < x.dim():
            raise ValueError("%s: axis %d out of range for input of rank %d"
                             % (op_name, a, x.dim()))
        axes.add(a + x.dim() if a < 0 else a)
    at_infer = x.device.type == "meta"
    bad = [a for a in sorted(axes) if x.shape[a] != 1
           and not (at_infer and x.shape[a] == _SENTINEL)]
    if bad:
        raise ValueError(
            "%s: axes %r have size != 1 in input shape %r (each explicitly "
            "listed axis must have size 1)" % (op_name, bad, tuple(x.shape)))
    return sorted(axes)


@register_op(
    "squeeze2",
    inputs=[In("X")],
    outputs=[Out("Out"), Out("XShape", no_grad=True)],
    attrs={"axes": []},
)
def _squeeze2(ins, attrs):
    x = ins["X"]
    axes = _squeeze_axes(x, attrs.get("axes"), "squeeze2")
    shape = [d for i, d in enumerate(x.shape) if i not in axes]
    return {"Out": x.reshape(shape), "XShape": _xshape(x)}


@register_op(
    "unsqueeze2",
    inputs=[In("X")],
    outputs=[Out("Out"), Out("XShape", no_grad=True)],
    attrs={"axes": []},
)
def _unsqueeze2(ins, attrs):
    x = ins["X"]
    out = x
    for a in sorted(attrs["axes"]):
        out = out.unsqueeze(a)
    return {"Out": out, "XShape": _xshape(x)}


@register_op(
    "stack",
    inputs=[In("X", duplicable=True)],
    outputs=[Out("Y")],
    attrs={"axis": 0},
)
def _stack(ins, attrs):
    return {"Y": torch.stack(list(ins["X"]), dim=attrs.get("axis", 0))}


@register_op(
    "one_hot",
    inputs=[In("X", no_grad=True)],
    outputs=[Out("Out")],
    attrs={"depth": 1, "dtype": 5, "allow_out_of_range": False},
    grad=None,
)
def _one_hot(ins, attrs):
    """A trailing dim of 1 is dropped; an id outside [0, depth) gives a
    row of zeros, as ``jax.nn.one_hot``."""
    x = ins["X"]
    if x.dim() >= 2 and x.shape[-1] == 1:
        x = x.squeeze(-1)
    depth = int(attrs["depth"])
    classes = torch.arange(depth, dtype=x.dtype, device=x.device)
    return {"Out": (x.unsqueeze(-1) == classes).to(
        _dt.to_torch_dtype(attrs.get("dtype", 5)))}


@register_op(
    "top_k",
    inputs=[In("X"), In("K", dispensable=True, no_grad=True)],
    outputs=[Out("Out"), Out("Indices", no_grad=True)],
    attrs={"k": 1},
)
def _top_k(ins, attrs):
    x, k = ins["X"], attrs.get("k", 1)
    if x.dtype in (torch.float32, torch.bfloat16, torch.float16):
        # one top-k over unique int64 keys: the value's bits made to order
        # as the floats do, then the index, reversed, so that the lower
        # index of two equal values ranks first
        bits = x.float().view(torch.int32)
        ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()
        low = 0xFFFFFFFF - torch.arange(x.shape[-1], device=x.device)
        top = torch.topk(ordered * (1 << 32) + low, k, dim=-1).values
        idx = 0xFFFFFFFF - (top & 0xFFFFFFFF)
    else:
        idx = torch.sort(x, dim=-1, descending=True,
                         stable=True).indices[..., :k]
    return {"Out": torch.gather(x, -1, idx), "Indices": idx}


@register_op(
    "gather_tree",
    inputs=[In("Ids", no_grad=True), In("Parents", no_grad=True)],
    outputs=[Out("Out")],
    grad=None,
)
def _gather_tree(ins, attrs):
    """Walk the parent pointers from the last step: step t of beam w is
    the id its ancestor at t chose."""
    ids, parents = ins["Ids"], ins["Parents"]
    t, b, w = ids.shape
    beams = torch.arange(w, device=ids.device).expand(b, w)
    outs = [None] * t
    for s in range(t - 1, -1, -1):
        outs[s] = torch.gather(ids[s], 1, beams)
        beams = torch.gather(parents[s], 1, beams).long()
    return {"Out": torch.stack(outs, 0)}
