"""The compare layers of ``paddle_tpu/layers/control_flow.py`` (``_cmp_layer``
and ``less_than`` … ``not_equal``, :31-62): each appends its compare op
(``ops/compare_ops.py``) writing a bool var that takes no grad. The
learning-rate schedules build their ``where`` chains on ``less_than``.
``While``, ``cond``, ``Switch`` and the arrays wait for the control-flow
ops (ROADMAP.md, queue 1 item 4)."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["less_than", "less_equal", "greater_than", "greater_equal",
           "equal", "not_equal"]


def _cmp_layer(op_type, x, y, cond=None):
    helper = LayerHelper(op_type, input=x)
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool",
                                                         stop_gradient=True)
    helper.append_op(op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [cond]})
    return cond


def less_than(x, y, force_cpu=None, cond=None):
    return _cmp_layer("less_than", x, y, cond)


def less_equal(x, y, cond=None):
    return _cmp_layer("less_equal", x, y, cond)


def greater_than(x, y, cond=None):
    return _cmp_layer("greater_than", x, y, cond)


def greater_equal(x, y, cond=None):
    return _cmp_layer("greater_equal", x, y, cond)


def equal(x, y, cond=None):
    return _cmp_layer("equal", x, y, cond)


def not_equal(x, y, cond=None):
    return _cmp_layer("not_equal", x, y, cond)
