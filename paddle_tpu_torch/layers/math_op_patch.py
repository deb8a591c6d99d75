"""Operator overloads of ``Variable`` (counterpart of
``paddle_tpu/layers/math_op_patch.py:13-75``): ``+ - * / // % **`` and
unary ``-`` append ``elementwise_*`` ops with ``axis=-1``, and a Python
number on the right of ``+ - * /`` (or the left of ``+ - *``) becomes a
``scale`` op, as in the JAX package; any other number is a
``fill_constant`` of x's shape. ``< <= > >=`` append the compare ops of
``ops/compare_ops.py``; ``==`` and ``!=`` stay identity, as in the JAX
package."""
from __future__ import annotations

from .. import framework
from ..layer_helper import LayerHelper


def _scalar_op(var, scale, bias):
    helper = LayerHelper("scale", input=var)
    out = helper.create_variable_for_type_inference(var.dtype)
    helper.append_op("scale", inputs={"X": [var]}, outputs={"Out": [out]},
                     attrs={"scale": float(scale), "bias": float(bias)})
    return out


def _binary_op(op_type, x, y, reverse=False):
    if not isinstance(y, framework.Variable):
        if op_type == "elementwise_add":
            return _scalar_op(x, 1.0, y)
        if op_type == "elementwise_sub":
            if reverse:
                return _scalar_op(x, -1.0, y)
            return _scalar_op(x, 1.0, -y)
        if op_type == "elementwise_mul":
            return _scalar_op(x, y, 0.0)
        if op_type == "elementwise_div" and not reverse:
            return _scalar_op(x, 1.0 / y, 0.0)
        from .tensor import fill_constant

        y = fill_constant(list(x.shape) if x.shape else [1], x.dtype, y)
    if reverse:
        x, y = y, x
    helper = LayerHelper(op_type, input=x)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"axis": -1})
    return out


def _cmp_op(op_type):
    """``x < y`` and the like: a number on the right becomes a
    ``fill_constant`` of x's shape and type, and the compare op writes a
    bool var that takes no grad (the JAX package's ``_cmp_op`` and
    ``control_flow._cmp_layer``)."""

    def impl(self, other):
        from .control_flow import _cmp_layer

        if not isinstance(other, framework.Variable):
            from .tensor import fill_constant

            other = fill_constant(list(self.shape) if self.shape else [1],
                                  self.dtype, other)
        return _cmp_layer(op_type, self, other)

    return impl


def monkey_patch_variable(cls=None):
    cls = cls or framework.Variable

    def _make(op_type, reverse=False):
        def impl(self, other):
            return _binary_op(op_type, self, other, reverse)

        return impl

    cls.__add__ = _make("elementwise_add")
    cls.__radd__ = _make("elementwise_add")
    cls.__sub__ = _make("elementwise_sub")
    cls.__rsub__ = lambda self, other: _binary_op(
        "elementwise_sub", self, other, reverse=True) if isinstance(
        other, framework.Variable) else _scalar_op(
        _scalar_op(self, -1.0, 0.0), 1.0, other)
    cls.__mul__ = _make("elementwise_mul")
    cls.__rmul__ = _make("elementwise_mul")
    cls.__truediv__ = _make("elementwise_div")
    cls.__rtruediv__ = _make("elementwise_div", reverse=True)
    cls.__floordiv__ = _make("elementwise_floordiv")
    cls.__mod__ = _make("elementwise_mod")
    cls.__pow__ = _make("elementwise_pow")
    cls.__neg__ = lambda self: _scalar_op(self, -1.0, 0.0)
    cls.__lt__ = _cmp_op("less_than")
    cls.__le__ = _cmp_op("less_equal")
    cls.__gt__ = _cmp_op("greater_than")
    cls.__ge__ = _cmp_op("greater_equal")
