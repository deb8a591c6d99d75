"""``dygraph.nn`` layers: ``Conv2D`` (NCHW), ``Pool2D``, ``Linear`` /
``FC``, ``BatchNorm``, ``Embedding``, ``LayerNorm`` and ``Dropout``.

Counterparts of the same classes of ``paddle_tpu/dygraph/nn.py`` (:50,
:114, :134, :158, :202, :216, :248): the same parameters, shapes, default
initializers and traced ops with the same attrs. ``Embedding`` traces
``lookup_table_v2``. The rest of that file (``Conv2DTranspose``,
``GRUUnit``, ``PRelu``, ``GroupNorm``, ``InstanceNorm``, ``Conv3D``, ...)
comes with a later slice (ROADMAP.md).
"""
from __future__ import annotations

import math

from .. import framework
from ..initializer import (ConstantInitializer, NormalInitializer,
                           XavierInitializer)
from ..param_attr import ParamAttr
from ..utils import unique_name
from .layers import Layer
from .varbase import ParamBase

__all__ = ["Conv2D", "Pool2D", "Linear", "FC", "BatchNorm", "Embedding",
           "LayerNorm", "Dropout"]


def _tracer():
    t = framework._dygraph_tracer()
    if t is None:
        raise RuntimeError("dygraph layers require dygraph.guard()")
    return t


def _create_param(shape, dtype, attr, is_bias=False, default_init=None):
    attr = ParamAttr._to_attr(attr)
    if attr is False:
        return None
    if default_init is None:
        default_init = (ConstantInitializer(0.0) if is_bias
                        else XavierInitializer())
    attr._with_initializer(default_init)
    name = attr.name or unique_name.generate("param")
    p = ParamBase.create(name, shape, dtype, attr.initializer,
                         trainable=attr.trainable)
    _tracer().register_parameter(p)
    return p


def _pair(x, n=2):
    return list(x) if isinstance(x, (list, tuple)) else [x] * n


def _act(out, act):
    if act:
        out = _tracer().trace_op(act, {"X": out}, {}, {})["Out"][0]
    return out


class Conv2D(Layer):
    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=None, param_attr=None,
                 bias_attr=None, use_cudnn=True, act=None, dtype="float32"):
        super().__init__()
        groups = groups or 1
        fs = _pair(filter_size)
        self._attrs = {"strides": _pair(stride), "paddings": _pair(padding),
                       "dilations": _pair(dilation), "groups": groups}
        self._act = act
        fan_in = num_channels * fs[0] * fs[1] // groups
        self.weight = _create_param(
            [num_filters, num_channels // groups] + fs, dtype, param_attr,
            default_init=NormalInitializer(0.0, (2.0 / fan_in) ** 0.5))
        self.bias = _create_param([num_filters], dtype, bias_attr,
                                  is_bias=True)

    def forward(self, input):
        out = _tracer().trace_op(
            "conv2d", {"Input": input, "Filter": self.weight}, {},
            self._attrs)["Output"][0]
        if self.bias is not None:
            out = _tracer().trace_op(
                "elementwise_add", {"X": out, "Y": self.bias}, {},
                {"axis": 1})["Out"][0]
        return _act(out, self._act)


class Pool2D(Layer):
    def __init__(self, pool_size=-1, pool_type="max", pool_stride=1,
                 pool_padding=0, global_pooling=False, use_cudnn=True,
                 ceil_mode=False, exclusive=True):
        super().__init__()
        self._attrs = {"pooling_type": pool_type, "ksize": _pair(pool_size),
                       "strides": _pair(pool_stride),
                       "paddings": _pair(pool_padding),
                       "global_pooling": global_pooling,
                       "ceil_mode": ceil_mode, "exclusive": exclusive}

    def forward(self, input):
        return _tracer().trace_op("pool2d", {"X": input}, {},
                                  self._attrs)["Out"][0]


class Linear(Layer):
    def __init__(self, input_dim, output_dim, param_attr=None, bias_attr=None,
                 act=None, dtype="float32"):
        super().__init__()
        self.weight = _create_param([input_dim, output_dim], dtype,
                                    param_attr)
        self.bias = _create_param([output_dim], dtype, bias_attr,
                                  is_bias=True)
        self._act = act

    def forward(self, input):
        out = _tracer().trace_op(
            "matmul", {"X": input, "Y": self.weight}, {},
            {"transpose_X": False, "transpose_Y": False,
             "alpha": 1.0})["Out"][0]
        if self.bias is not None:
            out = _tracer().trace_op(
                "elementwise_add", {"X": out, "Y": self.bias}, {},
                {"axis": len(out.shape) - 1})["Out"][0]
        return _act(out, self._act)


FC = Linear


class BatchNorm(Layer):
    def __init__(self, num_channels, act=None, is_test=False, momentum=0.9,
                 epsilon=1e-5, param_attr=None, bias_attr=None,
                 dtype="float32", data_layout="NCHW", in_place=False,
                 moving_mean_name=None, moving_variance_name=None,
                 do_model_average_for_mean_and_var=True,
                 use_global_stats=False, trainable_statistics=False):
        super().__init__()
        self.weight = _create_param([num_channels], dtype, param_attr,
                                    default_init=ConstantInitializer(1.0))
        self.bias = _create_param([num_channels], dtype, bias_attr,
                                  is_bias=True)
        self._mean = ParamBase.create(
            moving_mean_name or unique_name.generate("bn_mean"),
            [num_channels], dtype, ConstantInitializer(0.0), trainable=False)
        self._variance = ParamBase.create(
            moving_variance_name or unique_name.generate("bn_var"),
            [num_channels], dtype, ConstantInitializer(1.0), trainable=False)
        self.register_buffer("_mean_buf", self._mean)
        self.register_buffer("_variance_buf", self._variance)
        self._attrs = {"momentum": momentum, "epsilon": epsilon,
                       "data_layout": data_layout,
                       "use_global_stats": use_global_stats}
        self._act = act

    def forward(self, input):
        attrs = dict(self._attrs)
        attrs["is_test"] = not self.training
        res = _tracer().trace_op(
            "batch_norm",
            {"X": input, "Scale": self.weight, "Bias": self.bias,
             "Mean": self._mean, "Variance": self._variance}, {}, attrs)
        # the running statistics update in place (MeanOut / VarianceOut)
        self._mean._array = res["MeanOut"][0]._array
        self._variance._array = res["VarianceOut"][0]._array
        return _act(res["Y"][0], self._act)


class Embedding(Layer):
    def __init__(self, size, is_sparse=False, is_distributed=False,
                 padding_idx=None, param_attr=None, dtype="float32"):
        super().__init__()
        self.weight = _create_param(list(size), dtype, param_attr,
                                    default_init=XavierInitializer())
        self._padding_idx = -1 if padding_idx is None else padding_idx

    def forward(self, input):
        return _tracer().trace_op(
            "lookup_table_v2", {"W": self.weight, "Ids": input}, {},
            {"padding_idx": self._padding_idx})["Out"][0]


class LayerNorm(Layer):
    def __init__(self, normalized_shape, scale=True, shift=True,
                 epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
                 dtype="float32"):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        n = math.prod(normalized_shape)
        self.weight = _create_param(
            [n], dtype, param_attr,
            default_init=ConstantInitializer(1.0)) if scale else None
        self.bias = _create_param([n], dtype, bias_attr,
                                  is_bias=True) if shift else None
        self._epsilon = epsilon
        self._act = act
        self._normalized_ndim = len(normalized_shape)

    def forward(self, input):
        ins = {"X": input}
        if self.weight is not None:
            ins["Scale"] = self.weight
        if self.bias is not None:
            ins["Bias"] = self.bias
        out = _tracer().trace_op(
            "layer_norm", ins, {},
            {"epsilon": self._epsilon,
             "begin_norm_axis": len(input.shape) - self._normalized_ndim}
        )["Y"][0]
        return _act(out, self._act)


class Dropout(Layer):
    def __init__(self, p=0.5, seed=None,
                 dropout_implementation="downgrade_in_infer",
                 is_test=False):
        super().__init__()
        self._attrs = {"dropout_prob": p, "seed": seed or 0,
                       "fix_seed": seed is not None,
                       "dropout_implementation": dropout_implementation}

    def forward(self, input):
        attrs = dict(self._attrs)
        attrs["is_test"] = not self.training
        return _tracer().trace_op("dropout", {"X": input}, {},
                                  attrs)["Out"][0]
