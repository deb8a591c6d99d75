"""``mul`` and ``matmul`` (counterparts of ``paddle_tpu/ops/matmul_ops.py:27``
and ``:54``). ``mul`` is the fully-connected product: ``x_num_col_dims`` /
``y_num_col_dims`` flatten each side to 2-D. ``matmul`` swaps the last two
dims of an operand under ``transpose_X`` / ``transpose_Y``, broadcasts the
batch dims and multiplies by ``alpha``. Each product is one
``torch.matmul`` (float32 stays float32 unless the caller enables TF32)."""
from __future__ import annotations

import math

import torch

from ..core.registry import In, Out, register_op


def _flat2d(x, num_col_dims):
    lead = math.prod(x.shape[:num_col_dims]) if num_col_dims > 0 else 1
    # explicit trailing size: reshape(-1) would divide by a zero lead
    return x.reshape(lead, math.prod(x.shape[num_col_dims:]))


@register_op(
    "mul",
    inputs=[In("X"), In("Y")],
    outputs=[Out("Out")],
    attrs={"x_num_col_dims": 1, "y_num_col_dims": 1,
           "scale_x": 1.0, "scale_y": [1.0], "scale_out": 1.0},
)
def _mul(ins, attrs):
    x, y = ins["X"], ins["Y"]
    xd = attrs.get("x_num_col_dims", 1)
    yd = attrs.get("y_num_col_dims", 1)
    out = torch.matmul(_flat2d(x, xd), _flat2d(y, yd))
    return {"Out": out.reshape(tuple(x.shape[:xd]) + tuple(y.shape[yd:]))}


def _maybe_transpose(a, t):
    return a.transpose(-1, -2) if t and a.dim() > 1 else a


@register_op(
    "matmul",
    inputs=[In("X"), In("Y")],
    outputs=[Out("Out")],
    attrs={"transpose_X": False, "transpose_Y": False, "alpha": 1.0},
)
def _matmul(ins, attrs):
    x = _maybe_transpose(ins["X"], attrs.get("transpose_X", False))
    y = _maybe_transpose(ins["Y"], attrs.get("transpose_Y", False))
    out = torch.matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": out}
