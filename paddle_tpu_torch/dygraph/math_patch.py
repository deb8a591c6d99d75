"""Operator overloads of ``VarBase``.

Counterpart of ``paddle_tpu/dygraph/math_patch.py``: ``+ - * /`` with a
number become a traced ``scale``; otherwise ``elementwise_*`` with
``axis=-1`` (a number other than those becomes a traced ``fill_constant``
of shape [1]); ``@`` is ``matmul``; ``< <= > >=`` trace the compare ops
(``ops/compare_ops.py``), a number promoted with x's type as in the JAX
package; ``==`` / ``!=`` stay identity; ``bool()`` reads a one-element
value. No overload reads a value on the host, so none flushes the lazy
queue but ``bool()``.
"""
from __future__ import annotations

import numpy as np

from ..core import dtypes as _dt
from .tracer import current_tracer
from .varbase import VarBase


def _trace(op_type, ins, attrs=None):
    return current_tracer().trace_op(op_type, ins, {}, attrs or {})


def _const(value, dtype):
    return _trace("fill_constant", {},
                  {"shape": [1], "value": float(value),
                   "dtype": _dt.dtype_to_enum(dtype),
                   "force_cpu": False})["Out"][0]


def _scale(x, scale, bias):
    return _trace("scale", {"X": x}, {"scale": float(scale),
                                      "bias": float(bias)})["Out"][0]


def _binary(op_type, x, y, reverse=False):
    if not isinstance(y, VarBase):
        if op_type == "elementwise_add":
            return _scale(x, 1.0, y)
        if op_type == "elementwise_sub":
            return _scale(x, -1.0, y) if reverse else _scale(x, 1.0, -y)
        if op_type == "elementwise_mul":
            return _scale(x, y, 0.0)
        if op_type == "elementwise_div" and not reverse:
            return _scale(x, 1.0 / float(y), 0.0)
        y = _const(y, x.dtype)
    a, b = (y, x) if reverse else (x, y)
    return _trace(op_type, {"X": a, "Y": b}, {"axis": -1})["Out"][0]


def _cmp(op_type):
    def impl(self, other):
        if not isinstance(other, VarBase):
            # an int tensor against a float threshold compares as float
            dt = np.promote_types(np.dtype(self.dtype),
                                  np.asarray(other).dtype)
            other = _const(other, "float32" if dt.kind == "f" else dt.name)
        return _trace(op_type, {"X": self, "Y": other})["Out"][0]

    return impl


def _bool(self):
    arr = self.numpy()
    if arr.size != 1:
        raise ValueError(
            "The truth value of a multi-element VarBase is ambiguous; "
            "use .any()/.all() reductions")
    return bool(arr.reshape(-1)[0])


def monkey_patch_varbase():
    def _make(op_type, reverse=False):
        def impl(self, other):
            return _binary(op_type, self, other, reverse)

        return impl

    VarBase.__add__ = _make("elementwise_add")
    VarBase.__radd__ = _make("elementwise_add")
    VarBase.__sub__ = _make("elementwise_sub")
    VarBase.__rsub__ = _make("elementwise_sub", reverse=True)
    VarBase.__mul__ = _make("elementwise_mul")
    VarBase.__rmul__ = _make("elementwise_mul")
    VarBase.__truediv__ = _make("elementwise_div")
    VarBase.__rtruediv__ = _make("elementwise_div", reverse=True)
    VarBase.__pow__ = _make("elementwise_pow")
    VarBase.__mod__ = _make("elementwise_mod")
    VarBase.__neg__ = lambda self: _scale(self, -1.0, 0.0)
    VarBase.__matmul__ = lambda self, other: _trace(
        "matmul", {"X": self, "Y": other},
        {"transpose_X": False, "transpose_Y": False, "alpha": 1.0})["Out"][0]
    VarBase.__lt__ = _cmp("less_than")
    VarBase.__le__ = _cmp("less_equal")
    VarBase.__gt__ = _cmp("greater_than")
    VarBase.__ge__ = _cmp("greater_equal")
    VarBase.__bool__ = _bool


monkey_patch_varbase()
