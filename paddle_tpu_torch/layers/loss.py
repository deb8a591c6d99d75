"""``cross_entropy``, ``softmax_with_cross_entropy``, ``square_error_cost``,
``mse_loss`` and ``nce`` (counterparts of ``paddle_tpu/layers/loss.py:22``,
``:34``, ``:62``, ``:144`` and ``:186``): the same ops, slots and
attrs."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["cross_entropy", "softmax_with_cross_entropy",
           "square_error_cost", "mse_loss", "nce"]


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy", input=input)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("cross_entropy",
                     inputs={"X": [input], "Label": [label]},
                     outputs={"Y": [out]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    helper = LayerHelper("softmax_with_cross_entropy", input=logits)
    softmax = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op(
        "softmax_with_cross_entropy",
        inputs={"Logits": [logits], "Label": [label]},
        outputs={"Softmax": [softmax], "Loss": [loss]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index,
               "numeric_stable_mode": numeric_stable_mode, "axis": axis})
    if return_softmax:
        return loss, softmax
    return loss


def square_error_cost(input, label):
    helper = LayerHelper("square_error_cost", input=input)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("square_error_cost",
                     inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [out]})
    return out


def mse_loss(input, label):
    from .nn import reduce_mean

    return reduce_mean(square_error_cost(input, label))


def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=None, name=None,
        sampler="uniform", custom_dist=None, seed=0, is_sparse=False):
    """Noise-contrastive estimation loss, ``cost / (num_neg_samples +
    1)``; ``custom_dist`` becomes a frozen parameter the op samples
    from."""
    import numpy as np

    from ..initializer import NumpyArrayInitializer
    from ..param_attr import ParamAttr
    from .ops import scale

    helper = LayerHelper("nce", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    dim = int(input.shape[1])
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[num_total_classes, dim],
                                is_bias=False, dtype=input.dtype)
    inputs = {"Input": [input], "Label": [label], "Weight": [w]}
    if helper.bias_attr:
        inputs["Bias"] = [helper.create_parameter(
            attr=helper.bias_attr, shape=[num_total_classes, 1],
            is_bias=True, dtype=input.dtype)]
    if sample_weight is not None:
        inputs["SampleWeight"] = [sample_weight]
    sampler_id = {"uniform": 0, "log_uniform": 1, "custom_dist": 2}[sampler]
    if sampler == "custom_dist":
        if custom_dist is None:
            raise ValueError("custom_dist sampler needs custom_dist probs")
        probs = helper.create_parameter(
            attr=ParamAttr(), shape=[num_total_classes], dtype="float32",
            default_initializer=NumpyArrayInitializer(
                np.asarray(custom_dist, "float32")))
        probs.stop_gradient = True
        inputs["CustomDistProbs"] = [probs]
    if num_neg_samples is None:
        num_neg_samples = 10
    cost = helper.create_variable_for_type_inference(input.dtype)
    sample_logits = helper.create_variable_for_type_inference(input.dtype)
    sample_labels = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        "nce", inputs=inputs,
        outputs={"Cost": [cost], "SampleLogits": [sample_logits],
                 "SampleLabels": [sample_labels]},
        attrs={"num_total_classes": int(num_total_classes),
               "num_neg_samples": int(num_neg_samples), "seed": seed,
               "sampler": sampler_id, "is_sparse": is_sparse,
               "remote_prefetch": is_sparse},
        infer_shape=False)
    cost.shape = (int(input.shape[0]), 1)
    return scale(cost, scale=1.0 / (num_neg_samples + 1))
