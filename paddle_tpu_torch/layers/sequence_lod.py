"""The sequence (LoD) layers of ``paddle_tpu/layers/sequence_lod.py``:
``sequence_pool`` (:23), ``sequence_conv`` (:38), ``sequence_enumerate``
(:75), ``sequence_erase`` (:93), ``sequence_first_step`` /
``sequence_last_step`` (:113-118), ``sequence_softmax``,
``sequence_expand``, ``sequence_expand_as``, ``sequence_mask``,
``sequence_pad``, ``sequence_reshape`` and ``sequence_concat``. Each emits
the JAX layer's ops, slots, attrs and parameter names, and sets the output
shapes it sets (a LoD op's rows are known only at run time: -1)."""
from __future__ import annotations

from ..core import dtypes as _dt
from ..layer_helper import LayerHelper

__all__ = ["sequence_pool", "sequence_softmax", "sequence_expand",
           "sequence_expand_as", "sequence_mask", "sequence_pad",
           "sequence_reshape", "sequence_concat", "sequence_first_step",
           "sequence_last_step", "sequence_conv", "sequence_enumerate",
           "sequence_erase"]


def sequence_pool(input, pool_type, is_test=False, pad_value=0.0):
    helper = LayerHelper("sequence_pool", input=input)
    out = helper.create_variable_for_type_inference(input.dtype)
    max_index = helper.create_variable_for_type_inference(
        "int32", stop_gradient=True)
    helper.append_op(
        "sequence_pool", inputs={"X": [input]},
        outputs={"Out": [out], "MaxIndex": [max_index]},
        attrs={"pooltype": pool_type.upper(), "is_test": is_test,
               "pad_value": pad_value})
    return out


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=True, padding_start=None, bias_attr=None,
                  param_attr=None, act=None, name=None):
    """Context-window convolution over LoD sequences; a Filter
    [filter_size * D, num_filters], then the bias and ``act``."""
    helper = LayerHelper("sequence_conv", input=input,
                         param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    d = int(input.shape[-1])
    filt = helper.create_parameter(param_attr,
                                   shape=[filter_size * d, num_filters],
                                   dtype=input.dtype)
    if padding_start is None:
        padding_start = -int(filter_size // 2)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "sequence_conv", inputs={"X": [input], "Filter": [filt]},
        outputs={"Out": [out]},
        attrs={"contextLength": int(filter_size),
               "contextStart": int(padding_start),
               "contextStride": int(filter_stride),
               "paddingTrainable": False})
    # the LoD default would carry D through: the width is num_filters,
    # which the bias sizes itself from
    out.shape = (-1, int(num_filters))
    out = helper.append_bias_op(out) if bias_attr is not False else out
    return helper.append_activation(out)


def sequence_enumerate(input, win_size, pad_value=0, name=None):
    helper = LayerHelper("sequence_enumerate", input=input, name=name)
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    stop_gradient=True)
    helper.append_op("sequence_enumerate", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"win_size": int(win_size),
                            "pad_value": int(pad_value)},
                     infer_shape=False)
    out.shape = (-1, int(win_size))
    return out


def sequence_erase(input, tokens, name=None):
    helper = LayerHelper("sequence_erase", input=input, name=name)
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    stop_gradient=True)
    helper.append_op("sequence_erase", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"tokens": [int(t) for t in tokens]},
                     infer_shape=False)
    out.shape = (-1, 1)
    return out


def sequence_first_step(input):
    return sequence_pool(input, "first")


def sequence_last_step(input):
    return sequence_pool(input, "last")


def sequence_softmax(input, use_cudnn=False, name=None):
    helper = LayerHelper("sequence_softmax", input=input, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("sequence_softmax", inputs={"X": [input]},
                     outputs={"Out": [out]})
    return out


def sequence_expand(x, y, ref_level=-1, name=None):
    helper = LayerHelper("sequence_expand", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("sequence_expand", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"ref_level": ref_level})
    return out


def sequence_expand_as(x, y, name=None):
    helper = LayerHelper("sequence_expand_as", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("sequence_expand_as", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    helper = LayerHelper("sequence_mask", input=x, name=name)
    out = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    helper.append_op("sequence_mask", inputs={"X": [x]}, outputs={"Y": [out]},
                     attrs={"maxlen": maxlen if maxlen is not None else -1,
                            "out_dtype": _dt.dtype_to_enum(dtype)})
    return out


def sequence_pad(x, pad_value, maxlen=None, name=None):
    """([N, maxlen, ...] padded, [N] int64 lengths)."""
    helper = LayerHelper("sequence_pad", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    length = helper.create_variable_for_type_inference("int64",
                                                       stop_gradient=True)
    helper.append_op(
        "sequence_pad", inputs={"X": [x], "PadValue": [pad_value]},
        outputs={"Out": [out], "Length": [length]},
        attrs={"padded_length": maxlen if maxlen is not None else -1},
        infer_shape=False)
    # the layers after it (fc) size their parameters from this
    out.shape = (-1, maxlen if maxlen is not None else -1) \
        + tuple(x.shape[1:])
    length.shape = (-1,)
    return out, length


def sequence_reshape(input, new_dim):
    helper = LayerHelper("sequence_reshape", input=input)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("sequence_reshape", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"new_dim": new_dim})
    return out


def sequence_concat(input, name=None):
    helper = LayerHelper("sequence_concat", input=input, name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op("sequence_concat", inputs={"X": list(input)},
                     outputs={"Out": [out]})
    return out
