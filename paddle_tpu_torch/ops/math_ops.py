"""``sum`` (:33) and ``mean`` (:64) of ``paddle_tpu/ops/math_ops.py``:
``sum`` adds its dense inputs in order (the backward's merge of partial
grads), ``mean`` is the 0-d mean of every element. Both take the auto-VJP
grad op."""
from __future__ import annotations

from ..core.registry import In, Out, register_op


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
