"""Op lists steering mixed-precision rewriting.

Counterpart of ``paddle_tpu/contrib/mixed_precision/fp16_lists.py``:
``AutoMixedPrecisionLists`` and the white, black and gray sets, letter for
letter. White-list ops (the products) run in the low-precision type,
black-list ops (reductions, losses, normalisations) in float32, gray-list
ops follow their inputs; ``fp16_utils.rewrite_program`` forces any other
op to float32. User overrides move an op between the white and black
sets; an op on both custom lists raises ``ValueError``.
"""
from __future__ import annotations

import copy


class AutoMixedPrecisionLists:
    """Merge built-in white/black lists with user-supplied overrides."""

    def __init__(self, custom_white_list=None, custom_black_list=None):
        self._custom_white_list = custom_white_list
        self._custom_black_list = custom_black_list
        self.white_list = copy.copy(white_list)
        self.black_list = copy.copy(black_list)
        self.gray_list = copy.copy(gray_list)
        self._update_list()

    def _update_list(self):
        if self._custom_white_list and self._custom_black_list:
            for op_name in self._custom_white_list:
                if op_name in self._custom_black_list:
                    raise ValueError(
                        "Custom white list overlap custom black list: %s"
                        % op_name)
        if self._custom_white_list:
            for op_name in self._custom_white_list:
                if op_name in self.black_list:
                    self.black_list.remove(op_name)
                self.white_list.add(op_name)
        if self._custom_black_list:
            for op_name in self._custom_black_list:
                if op_name in self.white_list:
                    self.white_list.remove(op_name)
                self.black_list.add(op_name)


# the products: always in the low type (the reference's white_list)
white_list = {
    "conv2d",
    "conv3d",
    "conv2d_transpose",
    "matmul",
    "mul",
}

# numerically sensitive reductions, losses and normalisations: float32
# (the reference's black_list, with the normalisations moved here from its
# gray set, as the JAX package moves them)
black_list = {
    "exp",
    "square",
    "log",
    "mean",
    "sum",
    "cos_sim",
    "softmax",
    "softmax_with_cross_entropy",
    "sigmoid_cross_entropy_with_logits",
    "cross_entropy",
    "cross_entropy2",
    "batch_norm",
    "layer_norm",
    "instance_norm",
    "group_norm",
}

# follow their inputs (the reference's gray_list)
gray_list = {
    "elementwise_add",
    "elementwise_sub",
    "elementwise_mul",
    "elementwise_div",
    "elementwise_max",
    "elementwise_min",
    "elementwise_pow",
    "elementwise_mod",
    "elementwise_floordiv",
    "tanh",
    "sigmoid",
    "lookup_table",
    "top_k",
    "pool2d",
    "pool3d",
    "dropout",
    "relu",
    "relu6",
    "leaky_relu",
    "soft_relu",
    "flatten2",
    "stack",
    "unstack",
    "uniform_random_batch_size_like",
    "gaussian_random",
    "gaussian_random_batch_size_like",
    "slice",
    "rank",
    "scale",
    "transpose2",
    "reshape2",
    "gather",
    "fill_constant",
    "get_tensor_from_selected_rows",
    "sign",
    "cast",
}
