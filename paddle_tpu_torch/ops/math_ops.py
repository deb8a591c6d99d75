"""``scale`` (:14), ``sum`` (:33), ``mean`` (:64) and ``cast`` (:93) of
``paddle_tpu/ops/math_ops.py``: ``scale`` is ``x * scale + bias``, or
``(x + bias) * scale`` under ``bias_after_scale=False``, in x's type;
``sum`` adds its dense inputs in order (the backward's merge of partial
grads); ``mean`` is the 0-d mean of every element; ``cast`` converts to
``out_dtype``. All take the auto-VJP grad op.

``cast`` reads only ``out_dtype``: ``in_dtype`` records the input var's
type at build time, which the JAX package (x64 off) may give as int32
for an int64 tensor."""
from __future__ import annotations

from ..core import dtypes as _dt
from ..core.registry import In, Out, register_op


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
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": out}


@register_op("mean", inputs=[In("X")], outputs=[Out("Out")])
def _mean(ins, attrs):
    return {"Out": ins["X"].mean()}


@register_op(
    "cast",
    inputs=[In("X")],
    outputs=[Out("Out")],
    attrs={"in_dtype": 5, "out_dtype": 5},
)
def _cast(ins, attrs):
    return {"Out": ins["X"].to(_dt.to_torch_dtype(attrs["out_dtype"]))}
