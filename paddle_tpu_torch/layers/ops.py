"""``scale`` (counterpart of ``paddle_tpu/layers/ops.py:42``), ``pow``
(:55), ``increment`` (:102) and the unary layers ``tanh``, ``sigmoid``,
``exp``, ``log``, ``sqrt``, ``abs``, ``square``, ``ceil``, ``floor``,
``cos``, ``sign`` and ``gelu``, made as the JAX package's
``_make_unary`` (:24) makes them."""
from __future__ import annotations

from ..layer_helper import LayerHelper

_UNARY = ["tanh", "sigmoid", "exp", "log", "sqrt", "abs", "square", "ceil",
          "floor", "cos", "sign", "gelu"]

__all__ = _UNARY + ["scale", "pow", "increment"]


def _make_unary(op_type):
    def layer(x, name=None):
        helper = LayerHelper(op_type, input=x, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(op_type, inputs={"X": [x]}, outputs={"Out": [out]})
        return out

    layer.__name__ = op_type
    layer.__doc__ = "Elementwise %s (see ops/activation_ops.py)" % op_type
    return layer


for _name in _UNARY:
    globals()[_name] = _make_unary(_name)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper("scale", input=x, act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("scale", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out)


def pow(x, factor=1.0, name=None):
    helper = LayerHelper("pow", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("pow", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"factor": float(factor)})
    return out


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment", input=x)
    out = x if in_place else helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("increment", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"step": float(value)})
    return out
