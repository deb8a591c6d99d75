"""``sequence_mask`` (counterpart of ``paddle_tpu/ops/sequence_ops.py:140-156``):
``Y[..., j] = j < X[...]`` over ``j < maxlen``, in ``out_dtype``. ``maxlen``
is a static attr, as in the JAX package; no grad. The LoD sequence ops
come with a later slice (ROADMAP.md)."""
from __future__ import annotations

import torch

from ..core import dtypes as _dt
from ..core.registry import In, Out, register_op


@register_op(
    "sequence_mask",
    inputs=[In("X", no_grad=True),
            In("MaxLenTensor", dispensable=True, no_grad=True)],
    outputs=[Out("Y")],
    attrs={"maxlen": -1, "out_dtype": 5},
    grad=None,
)
def _sequence_mask(ins, attrs):
    x = ins["X"]
    maxlen = attrs.get("maxlen", -1)
    if maxlen < 0:
        raise ValueError("sequence_mask takes a static maxlen attr (the "
                         "MaxLenTensor form is not ported)")
    r = torch.arange(maxlen, device=x.device)
    mask = r[None, :] < x.reshape(-1, 1)
    return {"Y": mask.reshape(tuple(x.shape) + (maxlen,)).to(
        _dt.to_torch_dtype(attrs.get("out_dtype", 5)))}
