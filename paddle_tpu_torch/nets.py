"""Composite network blocks: ``simple_img_conv_pool``,
``img_conv_group``, ``sequence_conv_pool`` (:72), ``glu`` (:81) and
``scaled_dot_product_attention`` (:87) of ``paddle_tpu/nets.py``,
compositions of the port's layers that emit the JAX package's ops."""
from __future__ import annotations

from . import layers

__all__ = ["simple_img_conv_pool", "img_conv_group", "sequence_conv_pool",
           "glu", "scaled_dot_product_attention"]


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


def glu(input, dim=-1):
    """The gated linear unit: ``input`` split in two along ``dim``, a *
    sigmoid(b)."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Multi-head scaled dot-product attention over dense [B, L, D]
    tensors: heads split and merged by reshape and transpose, softmax(Q
    K^T / sqrt(d)) V by two ``matmul`` ops."""
    if len(queries.shape) != 3 or len(keys.shape) != 3 or \
            len(values.shape) != 3:
        raise ValueError("inputs must be 3-D [batch, len, dim]")
    d_model = int(queries.shape[-1])
    if d_model % num_heads != 0:
        raise ValueError("hidden size %d not divisible by num_heads %d"
                         % (d_model, num_heads))

    def split_heads(x):
        if num_heads == 1:
            return x
        b, n = x.shape[0], x.shape[1]
        reshaped = layers.reshape(
            x, shape=[int(b), int(n), num_heads, d_model // num_heads])
        return layers.transpose(reshaped, perm=[0, 2, 1, 3])

    def merge_heads(x):
        if num_heads == 1:
            return x
        t = layers.transpose(x, perm=[0, 2, 1, 3])
        return layers.reshape(
            t, shape=[int(t.shape[0]), int(t.shape[1]),
                      int(t.shape[2]) * int(t.shape[3])])

    q, k, v = split_heads(queries), split_heads(keys), split_heads(values)
    key_dim = float(d_model // num_heads)
    product = layers.matmul(layers.scale(q, scale=key_dim ** -0.5), k,
                            transpose_y=True)
    weights = layers.softmax(product)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate,
                                 is_test=False)
    return merge_heads(layers.matmul(weights, v))
