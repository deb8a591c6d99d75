"""Tensor layers ``create_parameter`` (:44), ``create_global_var`` (:56),
``cast`` (:69), ``concat`` (:82), ``sums`` (:90), ``assign`` (:98),
``fill_constant`` (:125), ``ones`` / ``zeros`` (:156-161),
``zeros_like`` (:172) and ``range`` (:211) of
``paddle_tpu/layers/tensor.py``: the same ops, slots and attrs."""
from __future__ import annotations

import math

import numpy as np

from .. import framework
from ..core import dtypes as _dt
from ..layer_helper import LayerHelper

__all__ = ["create_parameter", "create_global_var", "cast", "concat",
           "assign", "fill_constant", "range", "sums", "ones", "zeros",
           "zeros_like"]


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    from ..param_attr import ParamAttr

    helper = LayerHelper("create_parameter", param_attr=attr, name=name)
    attr = ParamAttr._to_attr(attr)
    if name is not None and attr.name is None:
        attr.name = name
    return helper.create_parameter(attr, list(shape), dtype, is_bias,
                                   default_initializer)


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


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", input=input, name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op("concat", inputs={"X": list(input)},
                     outputs={"Out": [out]}, attrs={"axis": axis})
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


def sums(input, out=None):
    helper = LayerHelper("sum", input=input)
    if out is None:
        out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op("sum", inputs={"X": list(input)}, outputs={"Out": [out]})
    return out


def ones(shape, dtype="float32", force_cpu=False):
    return fill_constant(shape, dtype, 1.0, force_cpu)


def zeros(shape, dtype="float32", force_cpu=False):
    return fill_constant(shape, dtype, 0.0, force_cpu)


def zeros_like(x, out=None):
    helper = LayerHelper("fill_zeros_like", input=x)
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("fill_zeros_like", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out
