"""Broadcast binary elementwise ops (counterpart of
``paddle_tpu/ops/elementwise_ops.py``): add, sub, mul, div, min, max, pow,
mod and floordiv, with the Fluid ``axis`` broadcast rule: with ``axis >=
0`` Y's dims align to X starting at ``axis`` (trailing size-1 dims of Y
trimmed); ``axis == -1`` is numpy-style right alignment. Grads come from
the auto-VJP, whose autograd sums a broadcast operand's grad back over the
broadcast axes."""
from __future__ import annotations

import torch

from ..core.registry import In, Out, register_op


def _align(x, y, axis):
    if x.dim() == y.dim():
        return x, y
    if x.dim() < y.dim():
        y2, x2 = _align(y, x, axis)
        return x2, y2
    yshape = list(y.shape)
    while len(yshape) > 1 and yshape[-1] == 1:
        yshape.pop()
    if axis == -1:
        axis = x.dim() - len(yshape)
    new_shape = [1] * x.dim()
    new_shape[axis:axis + len(yshape)] = yshape
    return x, y.reshape(new_shape)


def _floordiv(x, y):
    # torch has no grad for floor_divide; the quotient is piecewise
    # constant, so its grad is zero, as jax.vjp gives
    return torch.floor_divide(x.detach(), y.detach())


def _binary(name, f):
    @register_op(
        name,
        inputs=[In("X"), In("Y")],
        outputs=[Out("Out")],
        attrs={"axis": -1, "use_mkldnn": False, "scale_x": 1.0,
               "scale_y": 1.0, "scale_out": 1.0},
    )
    def _op(ins, attrs, _f=f):
        x, y = _align(ins["X"], ins["Y"], attrs.get("axis", -1))
        return {"Out": _f(x, y)}

    return _op


_binary("elementwise_add", torch.add)
_binary("elementwise_sub", torch.sub)
_binary("elementwise_mul", torch.mul)
_binary("elementwise_div", torch.div)
_binary("elementwise_min", torch.minimum)
_binary("elementwise_max", torch.maximum)
_binary("elementwise_pow", torch.pow)
# C++ truncated-modulo semantics (sign of the dividend), int and float
_binary("elementwise_mod", torch.fmod)
_binary("elementwise_floordiv", _floordiv)
