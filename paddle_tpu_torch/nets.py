"""Composite network blocks: ``simple_img_conv_pool``,
``img_conv_group`` and ``sequence_conv_pool`` (:72) of
``paddle_tpu/nets.py``, compositions of the port's layers that emit the
JAX package's ops. ``glu`` (it needs ``split``) and
``scaled_dot_product_attention`` are still to come (ROADMAP.md)."""
from __future__ import annotations

from . import layers

__all__ = ["simple_img_conv_pool", "img_conv_group", "sequence_conv_pool"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1,
                         conv_padding=0, conv_dilation=1, conv_groups=1,
                         param_attr=None, bias_attr=None, act=None,
                         use_cudnn=True):
    conv_out = layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        stride=conv_stride, padding=conv_padding, dilation=conv_dilation,
        groups=conv_groups, param_attr=param_attr, bias_attr=bias_attr,
        act=act)
    return layers.pool2d(
        input=conv_out, pool_size=pool_size, pool_type=pool_type,
        pool_stride=pool_stride, pool_padding=pool_padding,
        global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    """Stacked conv (+ batch_norm + dropout) layers, then one pool: the VGG
    block."""
    if not isinstance(conv_num_filter, (list, tuple)):
        raise TypeError("conv_num_filter must be a list or tuple")

    def expand(v):
        if not hasattr(v, "__len__"):
            return [v] * len(conv_num_filter)
        if len(v) != len(conv_num_filter):
            raise ValueError("%r does not give one value per conv" % (v,))
        return list(v)

    conv_padding = expand(conv_padding)
    conv_filter_size = expand(conv_filter_size)
    param_attr = expand(param_attr)
    conv_with_batchnorm = expand(conv_with_batchnorm)
    conv_batchnorm_drop_rate = expand(conv_batchnorm_drop_rate)
    tmp = input
    for i, n_filters in enumerate(conv_num_filter):
        tmp = layers.conv2d(
            input=tmp, num_filters=n_filters,
            filter_size=conv_filter_size[i], padding=conv_padding[i],
            param_attr=param_attr[i],
            act=None if conv_with_batchnorm[i] else conv_act)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            if abs(conv_batchnorm_drop_rate[i]) > 1e-5:
                tmp = layers.dropout(x=tmp,
                                     dropout_prob=conv_batchnorm_drop_rate[i])
    return layers.pool2d(input=tmp, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max", bias_attr=None):
    """``sequence_conv`` (with its bias and ``act``), then
    ``sequence_pool``: one row per sequence."""
    conv_out = layers.sequence_conv(input=input, num_filters=num_filters,
                                    filter_size=filter_size,
                                    param_attr=param_attr, act=act,
                                    bias_attr=bias_attr)
    return layers.sequence_pool(input=conv_out, pool_type=pool_type)
