"""``relu``, ``sigmoid``, ``tanh``, ``gelu`` and ``softmax`` (counterparts
of ``paddle_tpu/ops/activation_ops.py:29-31``, ``:55`` and ``:107``), and
the unary math of the learning-rate schedules, the clip and the
regularizers: ``exp``, ``log``, ``sqrt``, ``abs``, ``square``, ``ceil``,
``floor``, ``cos`` (:32-44), ``pow`` (:95, ``x ** factor``) and ``sign``
(:104). ``gelu`` is the exact erf form unless ``approximate`` asks for
the tanh form. Their grads are the auto-VJP, as in the JAX package:
relu's is 0 at 0, as ``jax.nn.relu``'s, and abs's is 1 at 0, as
``jnp.abs``'s. With these four, every activation of the epilogue pass
(``core.fusion.EPILOGUE_ACTS``) is registered."""
from __future__ import annotations

import torch

from ..core.registry import In, Out, register_op


@register_op("relu", inputs=[In("X")], outputs=[Out("Out")])
def _relu(ins, attrs):
    return {"Out": torch.relu(ins["X"])}


@register_op("sigmoid", inputs=[In("X")], outputs=[Out("Out")])
def _sigmoid(ins, attrs):
    return {"Out": torch.sigmoid(ins["X"])}


@register_op("tanh", inputs=[In("X")], outputs=[Out("Out")])
def _tanh(ins, attrs):
    return {"Out": torch.tanh(ins["X"])}


@register_op("gelu", inputs=[In("X")], outputs=[Out("Out")],
             attrs={"approximate": False})
def _gelu(ins, attrs):
    approx = "tanh" if attrs.get("approximate", False) else "none"
    return {"Out": torch.nn.functional.gelu(ins["X"], approximate=approx)}


@register_op("softmax", inputs=[In("X")], outputs=[Out("Out")],
             attrs={"axis": -1, "use_cudnn": False, "use_mkldnn": False})
def _softmax(ins, attrs):
    return {"Out": torch.softmax(ins["X"], dim=attrs.get("axis", -1))}


def _unary(name, f, attrs=None):
    @register_op(name, inputs=[In("X")], outputs=[Out("Out")],
                 attrs=dict(attrs or {}))
    def _op(ins, a, _f=f):
        return {"Out": _f(ins["X"], a)}

    return _op


_unary("exp", lambda x, a: torch.exp(x))
_unary("log", lambda x, a: torch.log(x))
_unary("sqrt", lambda x, a: torch.sqrt(x))
# the x branch at 0, so that the grad there is 1, as jnp.abs's
_unary("abs", lambda x, a: torch.where(x >= 0, x, -x))
_unary("square", lambda x, a: torch.square(x))
_unary("ceil", lambda x, a: torch.ceil(x))
_unary("floor", lambda x, a: torch.floor(x))
_unary("cos", lambda x, a: torch.cos(x))
_unary("pow", lambda x, a: torch.pow(x, a.get("factor", 1.0)),
       attrs={"factor": 1.0})
_unary("sign", lambda x, a: torch.sign(x))
