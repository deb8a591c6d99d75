"""Parameter initializers used by the ported layers.

Counterpart of the ``Constant``, ``Uniform``, ``Normal`` and ``Xavier``
initializers of ``paddle_tpu/initializer.py``: each appends the same init
op with the same attrs to the startup program block that holds the
parameter. ``Normal`` (``gaussian_random``) is ``conv2d``'s default weight
init, ``Normal(0, sqrt(2 / fan_in))``.
"""
from __future__ import annotations

import math

from .core import dtypes as _dt


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError

    def _seed(self, block):
        return getattr(block.program, "random_seed", 0)


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self._value = value

    def __call__(self, var, block):
        return block.append_op(
            "fill_constant",
            outputs={"Out": var},
            attrs={"shape": list(var.shape),
                   "dtype": _dt.dtype_to_enum(var.dtype),
                   "value": float(self._value)},
            infer_shape=False)


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self._low, self._high, self._seed_ = low, high, seed

    def __call__(self, var, block):
        return block.append_op(
            "uniform_random",
            outputs={"Out": var},
            attrs={"shape": list(var.shape), "min": self._low,
                   "max": self._high,
                   "seed": self._seed_ or self._seed(block),
                   "dtype": _dt.dtype_to_enum(var.dtype)},
            infer_shape=False)


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self._mean, self._std, self._seed_ = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            "gaussian_random",
            outputs={"Out": var},
            attrs={"shape": list(var.shape), "mean": self._mean,
                   "std": self._std,
                   "seed": self._seed_ or self._seed(block),
                   "dtype": _dt.dtype_to_enum(var.dtype)},
            infer_shape=False)


def _fan_in_out(var):
    shape = var.shape
    if len(shape) < 2:
        return (shape[0] if shape else 1), (shape[0] if shape else 1)
    receptive = math.prod(shape[2:])
    if len(shape) > 2:
        return shape[1] * receptive, shape[0] * receptive
    return shape[0], shape[1]


class XavierInitializer(Initializer):
    """Xavier: uniform (the default weight initializer) or normal."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self._uniform, self._fan_in, self._fan_out, self._seed_ = (
            uniform, fan_in, fan_out, seed)

    def __call__(self, var, block):
        fi, fo = _fan_in_out(var)
        fan_in = self._fan_in if self._fan_in is not None else fi
        fan_out = self._fan_out if self._fan_out is not None else fo
        if self._uniform:
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            return UniformInitializer(-limit, limit, self._seed_)(var, block)
        std = math.sqrt(2.0 / (fan_in + fan_out))
        return NormalInitializer(0.0, std, self._seed_)(var, block)

