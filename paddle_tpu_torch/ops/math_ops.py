"""``scale`` (:14), ``sum`` (:33), ``mean`` (:64), ``clip`` (:70),
``clip_by_norm`` (:80), ``cast`` (:93), ``increment`` (:127) and
``squared_l2_norm`` (:138) of ``paddle_tpu/ops/math_ops.py``: ``scale`` is
``x * scale + bias``, or ``(x + bias) * scale`` under
``bias_after_scale=False``, in x's type; ``sum`` adds its inputs in
order (the backward's merge of partial grads), over SelectedRows as the
JAX op does: all sparse inputs concatenate their rows, a mix adds the
sparse ones made dense; ``mean`` is the 0-d mean of
every element; ``clip`` bounds x to [min, max]; ``clip_by_norm`` scales x
by ``max_norm / ||x||`` where its L2 norm exceeds ``max_norm``; ``cast``
converts to ``out_dtype``; ``increment`` adds ``step`` in x's type (the
learning-rate schedules' step counter, int64 here where the JAX package,
x64 off, keeps int32); ``squared_l2_norm`` is the [1] sum of squares (the
global-norm clip's terms). All take the auto-VJP grad op.

``cast`` reads only ``out_dtype``: ``in_dtype`` records the input var's
type at build time, which the JAX package (x64 off) may give as int32
for an int64 tensor."""
from __future__ import annotations

import torch

from ..core import dtypes as _dt
from ..core.registry import In, Out, register_op
from ..core.tensor import LoDTensor, SelectedRows


@register_op(
    "scale",
    inputs=[In("X"), In("ScaleTensor", dispensable=True, no_grad=True)],
    outputs=[Out("Out")],
    attrs={"scale": 1.0, "bias": 0.0, "bias_after_scale": True},
)
def _scale(ins, attrs):
    x = ins["X"]
    s = ins.get("ScaleTensor")
    scale = s.reshape(()) if s is not None else attrs.get("scale", 1.0)
    # the bias takes x's type first (an integer x truncates it), as
    # jnp.asarray(bias, dtype=x.dtype) does; a Python number, so that no
    # scalar is copied to the card
    bias = attrs.get("bias", 0.0)
    if not x.is_floating_point():
        bias = int(bias)
    if attrs.get("bias_after_scale", True):
        out = x * scale + bias
    else:
        out = (x + bias) * scale
    return {"Out": out.to(x.dtype)}


@register_op(
    "sum",
    inputs=[In("X", duplicable=True)],
    outputs=[Out("Out")],
    attrs={"use_mkldnn": False},
)
def _sum(ins, attrs):
    xs = [x for x in ins["X"] if x is not None]
    if any(isinstance(x, SelectedRows) for x in xs):
        if all(isinstance(x, SelectedRows) for x in xs):
            # rows and values concatenated; duplicates add up when used
            vals = torch.cat([x.get_tensor().array for x in xs])
            return {"Out": SelectedRows(
                rows=[r for x in xs for r in x.rows()],
                height=xs[0].height(), value=LoDTensor(vals))}
        xs = [x.to_dense() if isinstance(x, SelectedRows) else x
              for x in xs]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": out}


@register_op("mean", inputs=[In("X")], outputs=[Out("Out")])
def _mean(ins, attrs):
    return {"Out": ins["X"].mean()}


@register_op("clip", inputs=[In("X")], outputs=[Out("Out")],
             attrs={"min": 0.0, "max": 0.0})
def _clip(ins, attrs):
    return {"Out": torch.clamp(ins["X"], attrs["min"], attrs["max"])}


@register_op("clip_by_norm", inputs=[In("X")], outputs=[Out("Out")],
             attrs={"max_norm": 1.0})
def _clip_by_norm(ins, attrs):
    x = ins["X"]
    max_norm = attrs["max_norm"]
    norm = torch.sqrt(torch.sum(torch.square(x)))
    scale = torch.where(norm > max_norm,
                        max_norm / torch.clamp_min(norm, 1e-12), 1.0)
    return {"Out": x * scale}


@register_op(
    "cast",
    inputs=[In("X")],
    outputs=[Out("Out")],
    attrs={"in_dtype": 5, "out_dtype": 5},
)
def _cast(ins, attrs):
    return {"Out": ins["X"].to(_dt.to_torch_dtype(attrs["out_dtype"]))}


@register_op("increment", inputs=[In("X")], outputs=[Out("Out")],
             attrs={"step": 1.0})
def _increment(ins, attrs):
    # the step takes x's type first (an integer counter truncates it), as
    # jnp.asarray(step, dtype=x.dtype) does; a Python number, so that no
    # scalar is copied to the card
    x = ins["X"]
    step = attrs.get("step", 1.0)
    if not x.is_floating_point():
        step = int(step)
    return {"Out": (x + step).to(x.dtype)}


@register_op("squared_l2_norm", inputs=[In("X")], outputs=[Out("Out")])
def _squared_l2_norm(ins, attrs):
    return {"Out": torch.sum(torch.square(ins["X"])).reshape(1)}
