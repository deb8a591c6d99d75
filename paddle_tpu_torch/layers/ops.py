"""``scale`` (counterpart of ``paddle_tpu/layers/ops.py:42``) and the
unary layers ``tanh`` and ``sigmoid``, made as the JAX package's
``_make_unary`` (:24) makes them."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["tanh", "sigmoid", "scale"]


def _make_unary(op_type):
    def layer(x, name=None):
        helper = LayerHelper(op_type, input=x, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(op_type, inputs={"X": [x]}, outputs={"Out": [out]})
        return out

    layer.__name__ = op_type
    layer.__doc__ = "Elementwise %s (see ops/activation_ops.py)" % op_type
    return layer


tanh = _make_unary("tanh")
sigmoid = _make_unary("sigmoid")


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper("scale", input=x, act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("scale", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out)
