"""``relu``, ``sigmoid``, ``tanh``, ``gelu`` and ``softmax`` (counterparts
of ``paddle_tpu/ops/activation_ops.py:29-31``, ``:55`` and ``:107``).
``gelu`` is the exact erf form unless ``approximate`` asks for the tanh
form. Their grads are the auto-VJP (relu's is 0 at 0, as
``jax.nn.relu``'s). With these four, every activation of the epilogue
pass (``core.fusion.EPILOGUE_ACTS``) is registered."""
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
