"""``dygraph.nn`` layers: ``Conv2D`` (NCHW), ``Pool2D``, ``Linear`` /
``FC``, ``BatchNorm``, ``Embedding``, ``LayerNorm``, ``Dropout`` and
the tail: ``Conv2DTranspose``, ``GRUUnit``, ``PRelu``, ``GroupNorm``,
``InstanceNorm``, ``Conv3D``, ``Conv3DTranspose``,
``BilinearTensorProduct``, ``NCE``, ``SequenceConv``, ``RowConv``,
``SpectralNorm`` and ``TreeConv``.

Counterparts of the same classes of ``paddle_tpu/dygraph/nn.py`` (:50-620):
the same parameters, shapes, default initializers and traced ops with the
same attrs (the tail's ops: ``ops/nn_tail_ops.py``). ``Embedding`` traces
``lookup_table_v2``. ``tree_conv`` is a host op: ``TreeConv`` runs it as a
one-op program on the guard's place, as the JAX package does, so its
output takes no grad.
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
           "LayerNorm", "Dropout", "Conv2DTranspose", "GRUUnit", "PRelu",
           "GroupNorm", "InstanceNorm", "Conv3D", "Conv3DTranspose",
           "BilinearTensorProduct", "NCE", "SequenceConv", "RowConv",
           "SpectralNorm", "TreeConv"]


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


def _trace(op_type, ins, attrs, out_slot="Out"):
    return _tracer().trace_op(op_type, ins, {}, attrs)[out_slot][0]


def _biased(out, bias, axis=1):
    if bias is not None:
        out = _trace("elementwise_add", {"X": out, "Y": bias},
                     {"axis": axis})
    return out


class _ConvNd(Layer):
    """Conv2DTranspose, Conv3D and Conv3DTranspose: the filter, the bias
    added on the channel axis, the activation."""

    def __init__(self, op_type, nd, filter_shape, num_filters, stride,
                 padding, dilation, groups, param_attr, bias_attr, act,
                 dtype):
        super().__init__()
        self._op_type = op_type
        self._attrs = {"strides": _pair(stride, nd),
                       "paddings": _pair(padding, nd),
                       "dilations": _pair(dilation, nd), "groups": groups}
        self._act = act
        self.weight = _create_param(filter_shape, dtype, param_attr)
        self.bias = _create_param([num_filters], dtype, bias_attr,
                                  is_bias=True)

    def forward(self, input):
        out = _trace(self._op_type, {"Input": input, "Filter": self.weight},
                     self._attrs, "Output")
        return _act(_biased(out, self.bias), self._act)


class Conv2DTranspose(_ConvNd):
    def __init__(self, num_channels, num_filters, filter_size,
                 output_size=None, padding=0, stride=1, dilation=1,
                 groups=None, param_attr=None, bias_attr=None,
                 use_cudnn=True, act=None, dtype="float32"):
        groups = groups or 1
        super().__init__("conv2d_transpose", 2,
                         [num_channels, num_filters // groups]
                         + _pair(filter_size), num_filters, stride, padding,
                         dilation, groups, param_attr, bias_attr, act, dtype)


class Conv3D(_ConvNd):
    """NCDHW, over conv3d."""

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=None, param_attr=None,
                 bias_attr=None, use_cudnn=True, act=None,
                 dtype="float32"):
        groups = groups or 1
        super().__init__("conv3d", 3,
                         [num_filters, num_channels // groups]
                         + _pair(filter_size, 3), num_filters, stride,
                         padding, dilation, groups, param_attr, bias_attr,
                         act, dtype)


class Conv3DTranspose(_ConvNd):
    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=None, param_attr=None,
                 bias_attr=None, use_cudnn=True, act=None,
                 dtype="float32"):
        groups = groups or 1
        super().__init__("conv3d_transpose", 3,
                         [num_channels, num_filters // groups]
                         + _pair(filter_size, 3), num_filters, stride,
                         padding, dilation, groups, param_attr, bias_attr,
                         act, dtype)


class GRUUnit(Layer):
    def __init__(self, size, param_attr=None, bias_attr=None,
                 activation="tanh", gate_activation="sigmoid",
                 origin_mode=False, dtype="float32"):
        super().__init__()
        d = size // 3
        self.weight = _create_param([d, d * 3], dtype, param_attr)
        self.bias = _create_param([1, d * 3], dtype, bias_attr,
                                  is_bias=True)
        self._attrs = {"origin_mode": origin_mode}

    def forward(self, input, hidden):
        ins = {"Input": input, "HiddenPrev": hidden, "Weight": self.weight}
        if self.bias is not None:
            ins["Bias"] = self.bias
        res = _tracer().trace_op("gru_unit", ins, {}, self._attrs)
        return res["Hidden"][0], res["ResetHiddenPrev"][0], res["Gate"][0]


class PRelu(Layer):
    def __init__(self, mode="all", channel=None, input_shape=None,
                 param_attr=None, dtype="float32"):
        super().__init__()
        shape = {"all": [1], "channel": [channel]}.get(mode) or \
            list(input_shape[1:])
        self.weight = _create_param(shape, dtype, param_attr,
                                    default_init=ConstantInitializer(0.25))
        self._mode = mode

    def forward(self, input):
        return _trace("prelu", {"X": input, "Alpha": self.weight},
                      {"mode": self._mode})


class GroupNorm(Layer):
    def __init__(self, channels, groups, epsilon=1e-5, param_attr=None,
                 bias_attr=None, act=None, dtype="float32"):
        super().__init__()
        self.weight = _create_param([channels], dtype, param_attr,
                                    default_init=ConstantInitializer(1.0))
        self.bias = _create_param([channels], dtype, bias_attr,
                                  is_bias=True)
        self._attrs = {"groups": groups, "epsilon": epsilon}
        self._act = act

    def forward(self, input):
        out = _trace("group_norm", {"X": input, "Scale": self.weight,
                                    "Bias": self.bias}, self._attrs, "Y")
        return _act(out, self._act)


class InstanceNorm(Layer):
    def __init__(self, num_channels, epsilon=1e-5, param_attr=None,
                 bias_attr=None, dtype="float32"):
        super().__init__()
        self.weight = _create_param([num_channels], dtype, param_attr,
                                    default_init=ConstantInitializer(1.0))
        self.bias = _create_param([num_channels], dtype, bias_attr,
                                  is_bias=True)
        self._epsilon = epsilon

    def forward(self, input):
        return _trace("instance_norm", {"X": input, "Scale": self.weight,
                                        "Bias": self.bias},
                      {"epsilon": self._epsilon}, "Y")


class BilinearTensorProduct(Layer):
    """out_k = x W_k y^T + b."""

    def __init__(self, input1_dim, input2_dim, output_dim, name=None,
                 act=None, param_attr=None, bias_attr=None,
                 dtype="float32"):
        super().__init__()
        self.weight = _create_param([output_dim, input1_dim, input2_dim],
                                    dtype, param_attr)
        self.bias = _create_param([1, output_dim], dtype, bias_attr,
                                  is_bias=True)
        self._act = act

    def forward(self, x, y):
        ins = {"X": x, "Y": y, "Weight": self.weight}
        if self.bias is not None:
            ins["Bias"] = self.bias
        return _act(_trace("bilinear_tensor_product", ins, {}), self._act)


class NCE(Layer):
    """Over nce (its cost scaled by 1 / (negatives + 1), as the JAX
    layer's)."""

    def __init__(self, num_total_classes, dim, sample_weight=None,
                 param_attr=None, bias_attr=None, num_neg_samples=10,
                 sampler="uniform", seed=0, is_sparse=False,
                 dtype="float32"):
        super().__init__()
        self.weight = _create_param([num_total_classes, dim], dtype,
                                    param_attr)
        self.bias = _create_param([num_total_classes, 1], dtype, bias_attr,
                                  is_bias=True)
        self._attrs = {"num_total_classes": int(num_total_classes),
                       "num_neg_samples": int(num_neg_samples),
                       "seed": seed,
                       "sampler": {"uniform": 0, "log_uniform": 1}[sampler],
                       "is_sparse": is_sparse}
        self._num_neg = num_neg_samples

    def forward(self, input, label, sample_weight=None):
        ins = {"Input": input, "Label": label, "Weight": self.weight}
        if self.bias is not None:
            ins["Bias"] = self.bias
        if sample_weight is not None:
            ins["SampleWeight"] = sample_weight
        cost = _trace("nce", ins, self._attrs, "Cost")
        return _trace("scale", {"X": cost},
                      {"scale": 1.0 / (self._num_neg + 1), "bias": 0.0})


class SequenceConv(Layer):
    """Over sequence_conv (a context window a row, within its sequence);
    the JAX layer's ``input_dim`` up front."""

    def __init__(self, name_scope=None, num_filters=1, filter_size=3,
                 filter_stride=1, padding=None, bias_attr=None,
                 param_attr=None, act=None, input_dim=None,
                 dtype="float32"):
        super().__init__()
        if input_dim is None:
            raise ValueError(
                "SequenceConv needs input_dim (the reference defers "
                "parameter creation to first forward; pass it up front)")
        size = int(filter_size)
        self.weight = _create_param([size * int(input_dim), num_filters],
                                    dtype, param_attr)
        self.bias = _create_param([num_filters], dtype, bias_attr,
                                  is_bias=True)
        self._attrs = {"contextLength": size, "contextStart": -(size // 2),
                       "contextStride": int(filter_stride),
                       "paddingTrainable": False}
        self._act = act

    def forward(self, input):
        out = _trace("sequence_conv", {"X": input, "Filter": self.weight},
                     self._attrs)
        return _act(_biased(out, self.bias), self._act)


class RowConv(Layer):
    """Over row_conv (a lookahead conv over [batch, time, dim])."""

    def __init__(self, name_scope=None, future_context_size=2,
                 param_attr=None, act=None, input_dim=None,
                 dtype="float32"):
        super().__init__()
        if input_dim is None:
            raise ValueError("RowConv needs input_dim")
        self.weight = _create_param([future_context_size + 1,
                                     int(input_dim)], dtype, param_attr)
        self._act = act

    def forward(self, input):
        return _act(_trace("row_conv", {"X": input, "Filter": self.weight},
                           {}), self._act)


class SpectralNorm(Layer):
    """Over spectral_norm (power iteration on the largest singular
    value); U and V take no grad."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32"):
        super().__init__()
        self._attrs = {"dim": int(dim), "power_iters": int(power_iters),
                       "eps": float(eps)}
        h = int(weight_shape[dim])
        w = int(math.prod(weight_shape)) // h
        self.weight_u = _create_param(
            [h], dtype, None, default_init=NormalInitializer(0.0, 1.0))
        self.weight_u.stop_gradient = True
        self.weight_v = _create_param(
            [w], dtype, None, default_init=NormalInitializer(0.0, 1.0))
        self.weight_v.stop_gradient = True

    def forward(self, weight):
        return _trace("spectral_norm", {"Weight": weight,
                                        "U": self.weight_u,
                                        "V": self.weight_v}, self._attrs)


def _run_host_op_eager(op_type, ins, out_slots, attrs):
    """A host op in dygraph: one-op program on the guard's place (its
    outputs take no grad)."""
    from ..core.scope import Scope
    from ..executor import Executor
    from .varbase import VarBase

    prog = framework.Program()
    blk = prog.global_block()
    feed, in_map = {}, {}
    for slot, v in ins.items():
        arr = v._force() if isinstance(v, VarBase) else v
        name = "_eager_%s" % slot.lower()
        var = blk.create_var(name=name, shape=tuple(arr.shape),
                             dtype=arr.dtype)
        var.is_data = True
        feed[name], in_map[slot] = arr, [name]
    out_map = {s: ["_eager_out_%s" % s.lower()] for s in out_slots}
    for names in out_map.values():
        blk.create_var(name=names[0], dtype="float32")
    blk.append_op(op_type, in_map, out_map, dict(attrs), infer_shape=False)
    outs = Executor(framework._dygraph_place_).run(
        prog, feed=feed, fetch_list=[out_map[s][0] for s in out_slots],
        scope=Scope(), return_numpy=False)
    return [VarBase(o.array, stop_gradient=True) for o in outs]


class TreeConv(Layer):
    """Over tree_conv (TBCNN), a host op run as a one-op program."""

    def __init__(self, feature_size, output_size, num_filters=1,
                 max_depth=8, act="tanh", param_attr=None, bias_attr=None,
                 name=None, dtype="float32"):
        super().__init__()
        self.weight = _create_param(
            [feature_size, 3, output_size, num_filters], dtype, param_attr)
        self.bias = _create_param([num_filters], dtype, bias_attr,
                                  is_bias=True)
        self._attrs = {"max_depth": int(max_depth)}
        self._act = act

    def forward(self, nodes_vector, edge_set):
        (out,) = _run_host_op_eager(
            "tree_conv", {"NodesVector": nodes_vector, "EdgeSet": edge_set,
                          "Filter": self.weight}, ["Out"], self._attrs)
        return _act(_biased(out, self.bias, axis=-1), self._act)
