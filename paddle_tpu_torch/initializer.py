"""Parameter initializers.

Counterpart of ``paddle_tpu/initializer.py``, whole: ``Constant``,
``Uniform``, ``Normal``, ``TruncatedNormal`` (:79), ``Xavier``, ``MSRA``
(:125), ``NumpyArray`` (:139) and ``Bilinear`` (:162), their short aliases
and ``force_init_on_cpu``. Each appends the same init op with the same
attrs to the startup program block that holds the parameter. ``Normal``
(``gaussian_random``) is ``conv2d``'s default weight init,
``Normal(0, sqrt(2 / fan_in))``; ``TruncatedNormal`` draws
``truncated_gaussian_random`` (cut at two standard deviations); ``MSRA``
is uniform over ``sqrt(6 / fan_in)`` or normal with ``sqrt(2 / fan_in)``;
``NumpyArray`` and ``Bilinear`` (the upsampling kernel of a transposed
conv) write their values with ``assign_value``.
"""
from __future__ import annotations

import math

import numpy as np

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


class TruncatedNormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self._mean, self._std, self._seed_ = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            "truncated_gaussian_random",
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



class MSRAInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, seed=0):
        self._uniform, self._fan_in, self._seed_ = uniform, fan_in, seed

    def __call__(self, var, block):
        fi, _ = _fan_in_out(var)
        fan_in = self._fan_in if self._fan_in is not None else fi
        if self._uniform:
            limit = math.sqrt(6.0 / fan_in)
            return UniformInitializer(-limit, limit, self._seed_)(var, block)
        std = math.sqrt(2.0 / fan_in)
        return NormalInitializer(0.0, std, self._seed_)(var, block)


class NumpyArrayInitializer(Initializer):
    def __init__(self, value):
        self._value = np.asarray(value)

    def __call__(self, var, block):
        v = self._value
        if v.dtype.kind in "fc":
            key, vals = "fp32_values", [float(x) for x in v.reshape(-1)]
        else:
            key, vals = "int32_values", [int(x) for x in v.reshape(-1)]
        return block.append_op(
            "assign_value",
            outputs={"Out": var},
            attrs={"shape": list(v.shape),
                   "dtype": _dt.dtype_to_enum(var.dtype), key: vals},
            infer_shape=False)


class BilinearInitializer(Initializer):
    """The bilinear upsampling kernel over a [C_out, C_in, H, W] filter,
    the JAX package's construction step for step."""

    def __call__(self, var, block):
        shape = var.shape
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        weight = np.zeros(shape, dtype=np.float32)
        size = shape[2] * shape[3]
        for i in range(int(np.prod(shape))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            w = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
            weight.reshape(-1)[i % size] = w
        weight = np.broadcast_to(
            weight.reshape(shape[0], shape[1], -1)[0, 0],
            (shape[0], shape[1], size)).reshape(shape)
        return NumpyArrayInitializer(weight)(var, block)


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer


def force_init_on_cpu():
    return False
