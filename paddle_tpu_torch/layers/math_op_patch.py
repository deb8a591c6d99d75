"""``Variable.__add__`` / ``__radd__`` (counterpart of
``paddle_tpu/layers/math_op_patch.py:64-65``): ``x + y`` of two Variables
appends ``elementwise_add`` with ``axis=-1``. The scalar forms and the
other operators need ``scale`` and the other elementwise ops, which come
with a later slice (ROADMAP.md)."""
from __future__ import annotations

from .. import framework
from ..layer_helper import LayerHelper


def _add(x, y):
    if not isinstance(y, framework.Variable):
        raise NotImplementedError(
            "Variable + %s needs the `scale` op, not yet ported "
            "(ROADMAP.md, queue 1)" % type(y).__name__)
    helper = LayerHelper("elementwise_add", input=x)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("elementwise_add", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"axis": -1})
    return out


def monkey_patch_variable(cls=None):
    cls = cls or framework.Variable
    cls.__add__ = _add
    cls.__radd__ = _add
