"""Tensor-creation layers ``create_global_var`` (:56), ``cast`` (:69),
``assign`` (:98), ``fill_constant`` (:125) and ``range`` (:211) of
``paddle_tpu/layers/tensor.py``: the same ops, slots and attrs."""
from __future__ import annotations

import math

import numpy as np

from .. import framework
from ..core import dtypes as _dt
from ..layer_helper import LayerHelper

__all__ = ["create_global_var", "cast", "assign", "fill_constant", "range"]


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A var of the main program's global block, set to ``value`` by a
    ``fill_constant`` op in the startup program; it takes no grad."""
    from ..initializer import ConstantInitializer

    helper = LayerHelper("global_var", name=name)
    var = helper.main_program.global_block().create_var(
        dtype=dtype, shape=list(shape), persistable=persistable,
        name=name or framework.unique_name.generate("global_var"))
    var.stop_gradient = True
    helper.set_variable_initializer(var, ConstantInitializer(float(value)))
    return var


def cast(x, dtype):
    helper = LayerHelper("cast", input=x)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"in_dtype": _dt.dtype_to_enum(x.dtype),
                            "out_dtype": _dt.dtype_to_enum(dtype)})
    return out


def assign(input, output=None):
    """A Variable is copied by ``assign``; a numpy array (or anything
    ``np.asarray`` takes) becomes an ``assign_value`` op holding its
    values."""
    helper = LayerHelper("assign")
    if isinstance(input, framework.Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op("assign", inputs={"X": [input]},
                         outputs={"Out": [output]})
        return output
    value = np.asarray(input)
    if output is None:
        output = helper.create_variable_for_type_inference(str(value.dtype))
    if value.dtype.kind == "f":
        key, vals = "fp32_values", [float(v) for v in value.reshape(-1)]
    elif value.dtype == np.int64:
        key, vals = "int64_values", [int(v) for v in value.reshape(-1)]
    else:
        key, vals = "int32_values", [int(v) for v in value.reshape(-1)]
    helper.append_op("assign_value", outputs={"Out": [output]},
                     attrs={"shape": list(value.shape),
                            "dtype": _dt.dtype_to_enum(str(value.dtype)),
                            key: vals})
    return output


def fill_constant(shape, dtype, value, force_cpu=False, out=None, name=None):
    helper = LayerHelper("fill_constant", name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype)
    out.stop_gradient = True
    helper.append_op("fill_constant", outputs={"Out": [out]},
                     attrs={"shape": list(shape),
                            "dtype": _dt.dtype_to_enum(dtype),
                            "value": float(value), "force_cpu": force_cpu})
    return out


def range(start, end, step, dtype="float32"):
    """``arange``; numbers become ``fill_constant`` ops of shape [1]. The
    output's length depends on the inputs' values, so shape inference
    does not run the op: with numbers, the length is set here."""
    helper = LayerHelper("range")

    def _to_var(v):
        if isinstance(v, framework.Variable):
            return v
        return fill_constant([1], dtype, v)

    out = helper.create_variable_for_type_inference(dtype)
    if all(isinstance(v, (int, float)) for v in (start, end, step)) \
            and step != 0:
        out.shape = (max(0, int(math.ceil((end - start) / step))),)
    helper.append_op("range",
                     inputs={"Start": [_to_var(start)], "End": [_to_var(end)],
                             "Step": [_to_var(step)]},
                     outputs={"Out": [out]}, infer_shape=False)
    return out
