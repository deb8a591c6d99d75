"""Layers ``fc`` (:125), ``embedding`` (:167), ``conv2d`` (:204),
``pool2d`` (:413), ``batch_norm`` (:485), ``layer_norm`` (:552),
``softmax`` (:661), ``matmul`` (:671), ``expand`` (:811), ``gather``
(:842), ``reduce_sum`` (:931), ``mean`` (:971), ``relu`` (:1023),
``reshape``, ``transpose``, ``dropout`` (:641), ``slice`` (:785),
``clip`` (:959), ``clip_by_norm`` (:965), ``elementwise_add`` /
``_sub`` / ``_mul`` / ``_div`` / ``_min`` / ``_mod`` / ``_floordiv``
(:1159-1191), ``squeeze`` (:747), ``unsqueeze`` (:758), ``stack``
(:823), ``one_hot`` (:868), ``topk`` (:877), ``reduce_mean`` /
``reduce_max`` / ``reduce_min`` (:939-947), ``where`` (:1111),
``split`` (:769), ``shape`` (:914), ``reduce_prod`` / ``reduce_all`` /
``reduce_any`` (:947-955), ``elementwise_max`` / ``_pow`` (:1175,
:1183), ``gaussian_random`` (:1214) and ``uniform_random`` (:1228) of
``paddle_tpu/layers/nn.py``. Each emits the same ops, slots, attrs and
parameter names as its JAX counterpart."""
from __future__ import annotations

import math

from ..core import dtypes as _dt
from ..initializer import ConstantInitializer, NormalInitializer
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["fc", "embedding", "conv2d", "pool2d", "batch_norm", "layer_norm",
           "softmax", "matmul", "expand", "gather", "reduce_sum", "mean",
           "relu", "reshape", "transpose", "dropout", "slice",
           "elementwise_add", "elementwise_sub", "elementwise_mul",
           "elementwise_div", "elementwise_min", "clip", "clip_by_norm",
           "elementwise_mod", "elementwise_floordiv", "squeeze", "unsqueeze",
           "stack", "one_hot", "topk", "reduce_mean", "reduce_max",
           "reduce_min", "where", "split", "shape", "reduce_prod",
           "reduce_all", "reduce_any", "elementwise_max", "elementwise_pow",
           "gaussian_random", "uniform_random", "mul", "conv2d_transpose",
           "conv3d", "instance_norm", "group_norm", "prelu"]


def _pair(x, n=2):
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x] * n


def _single_out_op(helper, op_type, inputs, attrs):
    out = helper.create_variable_for_type_inference(helper.input_dtype())
    helper.append_op(op_type, inputs=inputs, outputs={"Out": [out]},
                     attrs=attrs)
    return out


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Fully connected: ``mul`` per input, ``sum`` of several, bias
    ``elementwise_add``, activation."""
    helper = LayerHelper("fc", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = helper.input_dtype()
    inputs = helper.input()
    mul_results = []
    for inp, attr in zip(inputs, helper.multiple_param_attr(len(inputs))):
        w = helper.create_parameter(
            attr=attr, shape=[math.prod(inp.shape[num_flatten_dims:]), size],
            dtype=dtype)
        tmp = helper.create_variable_for_type_inference(dtype)
        helper.append_op("mul", inputs={"X": [inp], "Y": [w]},
                         outputs={"Out": [tmp]},
                         attrs={"x_num_col_dims": num_flatten_dims,
                                "y_num_col_dims": 1})
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(dtype)
        helper.append_op("sum", inputs={"X": mul_results},
                         outputs={"Out": [pre_bias]}, attrs={})
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    helper = LayerHelper("embedding", param_attr=param_attr)
    w = helper.create_parameter(attr=helper.param_attr, shape=list(size),
                                dtype=dtype, is_bias=False)
    tmp = helper.create_variable_for_type_inference(dtype)
    padding_idx = (-1 if padding_idx is None
                   else padding_idx if padding_idx >= 0
                   else size[0] + padding_idx)
    helper.append_op("lookup_table", inputs={"W": [w], "Ids": [input]},
                     outputs={"Out": [tmp]},
                     attrs={"is_sparse": is_sparse,
                            "is_distributed": is_distributed,
                            "padding_idx": padding_idx,
                            "remote_prefetch": False})
    return tmp


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format="NCHW"):
    """2-D convolution, filter ``[num_filters, C / groups, KH, KW]`` with
    the default init ``Normal(0, sqrt(2 / fan_in))``."""
    helper = LayerHelper("conv2d", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    groups = groups or 1
    filter_size = _pair(filter_size)
    num_channels = input.shape[1] if data_format == "NCHW" \
        else input.shape[-1]
    fan_in = num_channels * filter_size[0] * filter_size[1] // groups
    w = helper.create_parameter(
        attr=helper.param_attr,
        shape=[num_filters, num_channels // groups] + filter_size,
        dtype=dtype,
        default_initializer=NormalInitializer(0.0, (2.0 / fan_in) ** 0.5))
    pre_bias = helper.create_variable_for_type_inference(dtype)
    op_type = "depthwise_conv2d" if (
        groups == num_channels and num_filters % num_channels == 0
        and not use_cudnn) else "conv2d"
    helper.append_op(
        op_type, inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [pre_bias]},
        attrs={"strides": _pair(stride), "paddings": _pair(padding),
               "dilations": _pair(dilation), "groups": groups,
               "use_cudnn": use_cudnn, "data_format": data_format})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, exclusive=True, name=None, data_format="NCHW"):
    helper = LayerHelper("pool2d", input=input, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "pool2d", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"pooling_type": pool_type, "ksize": _pair(pool_size),
               "strides": _pair(pool_stride),
               "paddings": _pair(pool_padding),
               "global_pooling": global_pooling, "ceil_mode": ceil_mode,
               "exclusive": exclusive, "data_format": data_format})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None,
               do_model_average_for_mean_and_var=True,
               use_global_stats=False):
    """Batch norm; the running mean and variance are non-trainable
    parameters that the op's ``MeanOut`` / ``VarianceOut`` write back."""
    helper = LayerHelper("batch_norm", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    shape = [input.shape[1] if data_layout == "NCHW" else input.shape[-1]]
    scale = helper.create_parameter(
        attr=helper.param_attr, shape=shape, dtype=dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(attr=helper.bias_attr, shape=shape,
                                   dtype=dtype, is_bias=True)
    mean = helper.create_parameter(
        attr=ParamAttr(name=moving_mean_name, trainable=False),
        shape=shape, dtype=dtype,
        default_initializer=ConstantInitializer(0.0))
    mean.stop_gradient = True
    variance = helper.create_parameter(
        attr=ParamAttr(name=moving_variance_name, trainable=False),
        shape=shape, dtype=dtype,
        default_initializer=ConstantInitializer(1.0))
    variance.stop_gradient = True
    saved_mean = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [variance]},
        outputs={"Y": [out], "MeanOut": [mean], "VarianceOut": [variance],
                 "SavedMean": [saved_mean], "SavedVariance": [saved_var]},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "data_layout": data_layout,
               "use_global_stats": use_global_stats})
    return helper.append_activation(out)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    param_shape = [math.prod(input.shape[begin_norm_axis:])]
    inputs = {"X": [input]}
    if scale:
        inputs["Scale"] = [helper.create_parameter(
            attr=helper.param_attr, shape=param_shape, dtype=dtype,
            default_initializer=ConstantInitializer(1.0))]
    if shift:
        inputs["Bias"] = [helper.create_parameter(
            attr=helper.bias_attr, shape=param_shape, dtype=dtype,
            is_bias=True)]
    mean_out = helper.create_variable_for_type_inference(dtype,
                                                         stop_gradient=True)
    var_out = helper.create_variable_for_type_inference(dtype,
                                                        stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("layer_norm", inputs=inputs,
                     outputs={"Y": [out], "Mean": [mean_out],
                              "Variance": [var_out]},
                     attrs={"epsilon": epsilon,
                            "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(out)


def softmax(input, use_cudnn=False, name=None, axis=-1):
    helper = LayerHelper("softmax", input=input, name=name)
    return _single_out_op(helper, "softmax", {"X": [input]}, {"axis": axis})


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0,
           name=None):
    helper = LayerHelper("matmul", input=x, name=name)
    return _single_out_op(helper, "matmul", {"X": [x], "Y": [y]},
                          {"transpose_X": transpose_x,
                           "transpose_Y": transpose_y,
                           "alpha": float(alpha)})


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", input=x, name=name)
    return _single_out_op(helper, "expand", {"X": [x]},
                          {"expand_times": list(expand_times)})


def gather(input, index, overwrite=True, name=None):
    helper = LayerHelper("gather", input=input, name=name)
    return _single_out_op(helper, "gather", {"X": [input], "Index": [index]},
                          {"overwrite": overwrite})


def _reduce(op_type, input, dim, keep_dim, name):
    helper = LayerHelper(op_type, input=input, name=name)
    if dim is None:
        attrs = {"dim": [0], "keep_dim": keep_dim, "reduce_all": True}
    else:
        dims = dim if isinstance(dim, (list, tuple)) else [dim]
        attrs = {"dim": list(dims), "keep_dim": keep_dim,
                 "reduce_all": False}
    return _single_out_op(helper, op_type, {"X": [input]}, attrs)


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_sum", input, dim, keep_dim, name)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_mean", input, dim, keep_dim, name)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_max", input, dim, keep_dim, name)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_min", input, dim, keep_dim, name)


def relu(x, name=None):
    helper = LayerHelper("relu", input=x, name=name)
    return _single_out_op(helper, "relu", {"X": [x]}, {})


def mean(x, name=None):
    helper = LayerHelper("mean", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("mean", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={})
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=False,
            name=None):
    helper = LayerHelper("reshape2", input=x, act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype,
                                                       stop_gradient=True)
    helper.append_op("reshape2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"shape": list(shape)})
    return helper.append_activation(out)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose2", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype,
                                                       stop_gradient=True)
    helper.append_op("transpose2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axis": list(perm)})
    return out


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference(x.dtype,
                                                     stop_gradient=True)
    helper.append_op("dropout", inputs={"X": [x]},
                     outputs={"Out": [out], "Mask": [mask]},
                     attrs={"dropout_prob": dropout_prob,
                            "is_test": is_test,
                            "fix_seed": seed is not None,
                            "seed": seed or 0,
                            "dropout_implementation":
                                dropout_implementation})
    return out


def slice(input, axes, starts, ends, name=None):
    helper = LayerHelper("slice", input=input, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("slice", inputs={"Input": [input]},
                     outputs={"Out": [out]},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends), "decrease_axis": []})
    return out


def _elementwise(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, input=x, act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return helper.append_activation(out)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_add", x, y, axis, act, name)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_sub", x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mul", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_div", x, y, axis, act, name)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_min", x, y, axis, act, name)


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", input=x, name=name)
    return _single_out_op(helper, "clip", {"X": [x]},
                          {"min": float(min), "max": float(max)})


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", input=x, name=name)
    return _single_out_op(helper, "clip_by_norm", {"X": [x]},
                          {"max_norm": float(max_norm)})


def elementwise_mod(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mod", x, y, axis, act, name)


def elementwise_floordiv(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_floordiv", x, y, axis, act, name)


def _shape_op(op_type, input, axes, name):
    helper = LayerHelper(op_type, input=input, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    xshape = helper.create_variable_for_type_inference(input.dtype,
                                                       stop_gradient=True)
    helper.append_op(op_type, inputs={"X": [input]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axes": list(axes)})
    return out


def squeeze(input, axes, name=None):
    return _shape_op("squeeze2", input, axes, name)


def unsqueeze(input, axes, name=None):
    return _shape_op("unsqueeze2", input, axes, name)


def stack(x, axis=0, name=None):
    from .. import framework

    if isinstance(x, framework.Variable):
        x = [x]
    helper = LayerHelper("stack", input=x, name=name)
    out = helper.create_variable_for_type_inference(x[0].dtype)
    helper.append_op("stack", inputs={"X": list(x)}, outputs={"Y": [out]},
                     attrs={"axis": axis})
    return out


def one_hot(input, depth, allow_out_of_range=False):
    helper = LayerHelper("one_hot", input=input)
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op("one_hot", inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs={"depth": depth,
                            "allow_out_of_range": allow_out_of_range})
    return out


def topk(input, k, name=None):
    helper = LayerHelper("top_k", input=input, name=name)
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference("int64",
                                                        stop_gradient=True)
    helper.append_op("top_k", inputs={"X": [input]},
                     outputs={"Out": [values], "Indices": [indices]},
                     attrs={"k": k})
    return values, indices


def where(condition, x, y, name=None):
    """``x`` where ``condition`` holds, else ``y`` (the JAX package's
    one-argument form, ``where_index``, is not ported)."""
    helper = LayerHelper("where", input=condition, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("where", inputs={"Condition": [condition], "X": [x],
                                      "Y": [y]},
                     outputs={"Out": [out]})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", input=input, name=name)
    dim = dim if dim >= 0 else dim + len(input.shape)
    if isinstance(num_or_sections, int):
        num = num_or_sections
        attrs = {"num": num, "sections": [], "axis": dim}
    else:
        num = len(num_or_sections)
        attrs = {"num": 0, "sections": list(num_or_sections), "axis": dim}
    outs = [helper.create_variable_for_type_inference(input.dtype)
            for _ in range(num)]
    helper.append_op("split", inputs={"X": [input]}, outputs={"Out": outs},
                     attrs=attrs)
    return outs


def shape(input):
    helper = LayerHelper("shape", input=input)
    out = helper.create_variable_for_type_inference("int32",
                                                    stop_gradient=True)
    helper.append_op("shape", inputs={"Input": [input]},
                     outputs={"Out": [out]})
    return out


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_prod", input, dim, keep_dim, name)


def reduce_all(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_all", input, dim, keep_dim, name)


def reduce_any(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_any", input, dim, keep_dim, name)


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_max", x, y, axis, act, name)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_pow", x, y, axis, act, name)


def _random(op_type, shape, dtype, name, **attrs):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(dtype)
    # no shape inference: a draw needs the executor's generator, which a
    # meta run has not
    helper.append_op(op_type, inputs={}, outputs={"Out": [out]},
                     attrs=dict(attrs, shape=list(shape),
                                dtype=_dt.dtype_to_enum(dtype)),
                     infer_shape=False)
    out.shape = tuple(shape)
    return out


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32",
                    name=None):
    return _random("gaussian_random", shape, dtype, name, mean=mean,
                   std=std, seed=seed)


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0,
                   name=None):
    return _random("uniform_random", shape, dtype, name, min=min, max=max,
                   seed=seed)


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("mul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"x_num_col_dims": x_num_col_dims,
                            "y_num_col_dims": y_num_col_dims})
    return out


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    """Transposed 2-D convolution (NCHW), filter ``[C, num_filters /
    groups, KH, KW]``; ``filter_size`` follows from ``output_size`` when
    not given."""
    helper = LayerHelper("conv2d_transpose", input=input,
                         param_attr=param_attr, bias_attr=bias_attr, act=act,
                         name=name)
    dtype = input.dtype
    groups = groups or 1
    stride, padding, dilation = _pair(stride), _pair(padding), \
        _pair(dilation)
    if filter_size is None:
        if output_size is None:
            raise ValueError("output_size or filter_size must be given")
        output_size = _pair(output_size)
        h, w_ = input.shape[2], input.shape[3]
        filter_size = [
            output_size[0] - (h - 1) * stride[0] + 2 * padding[0],
            output_size[1] - (w_ - 1) * stride[1] + 2 * padding[1]]
    else:
        filter_size = _pair(filter_size)
    w = helper.create_parameter(
        attr=helper.param_attr,
        shape=[input.shape[1], num_filters // groups] + filter_size,
        dtype=dtype)
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "conv2d_transpose", inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [pre_bias]},
        attrs={"strides": stride, "paddings": padding,
               "dilations": dilation, "groups": groups,
               "use_cudnn": use_cudnn})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None):
    """3-D convolution (NCDHW), filter ``[num_filters, C / groups, KD, KH,
    KW]``."""
    helper = LayerHelper("conv3d", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    groups = groups or 1
    w = helper.create_parameter(
        attr=helper.param_attr,
        shape=[num_filters, input.shape[1] // groups]
        + _pair(filter_size, 3), dtype=dtype)
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "conv3d", inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [pre_bias]},
        attrs={"strides": _pair(stride, 3), "paddings": _pair(padding, 3),
               "dilations": _pair(dilation, 3), "groups": groups})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None,
                  name=None):
    helper = LayerHelper("instance_norm", input=input,
                         param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    dtype = input.dtype
    shape = [input.shape[1]]
    scale = helper.create_parameter(
        attr=helper.param_attr, shape=shape, dtype=dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(attr=helper.bias_attr, shape=shape,
                                   dtype=dtype, is_bias=True)
    saved_mean = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "instance_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias]},
        outputs={"Y": [out], "SavedMean": [saved_mean],
                 "SavedVariance": [saved_var]},
        attrs={"epsilon": epsilon})
    return out


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, data_layout="NCHW", name=None):
    helper = LayerHelper("group_norm", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    shape = [input.shape[1]]
    inputs = {"X": [input]}
    if helper.param_attr is not False:
        inputs["Scale"] = [helper.create_parameter(
            attr=helper.param_attr, shape=shape, dtype=dtype,
            default_initializer=ConstantInitializer(1.0))]
    if helper.bias_attr is not False:
        inputs["Bias"] = [helper.create_parameter(
            attr=helper.bias_attr, shape=shape, dtype=dtype, is_bias=True)]
    mean_out = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    var_out = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "group_norm", inputs=inputs,
        outputs={"Y": [out], "Mean": [mean_out], "Variance": [var_out]},
        attrs={"epsilon": epsilon, "groups": groups,
               "data_layout": data_layout})
    return helper.append_activation(out)


def prelu(x, mode, param_attr=None, name=None):
    helper = LayerHelper("prelu", input=x, param_attr=param_attr, name=name)
    if mode == "all":
        alpha_shape = [1]
    elif mode == "channel":
        alpha_shape = [x.shape[1]]
    else:
        alpha_shape = list(x.shape[1:])
    alpha = helper.create_parameter(
        attr=helper.param_attr, shape=alpha_shape, dtype=x.dtype,
        default_initializer=ConstantInitializer(0.25))
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("prelu", inputs={"X": [x], "Alpha": [alpha]},
                     outputs={"Out": [out]}, attrs={"mode": mode})
    return out
