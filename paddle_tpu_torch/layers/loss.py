"""``cross_entropy``, ``softmax_with_cross_entropy``, ``square_error_cost``
and ``mse_loss`` (counterparts of ``paddle_tpu/layers/loss.py:22``,
``:34``, ``:62`` and ``:144``): the same ops, slots and attrs."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["cross_entropy", "softmax_with_cross_entropy",
           "square_error_cost", "mse_loss"]


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
