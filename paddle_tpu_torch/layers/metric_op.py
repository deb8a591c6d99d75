"""``accuracy`` and ``auc`` (counterparts of
``paddle_tpu/layers/metric_op.py:10`` and ``:36``): the same ops, slots,
attrs and var names (``auc_stat_pos`` / ``auc_stat_neg``, the persistable
statistics, zeroed by the startup program)."""
from __future__ import annotations

from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper

__all__ = ["accuracy", "auc"]


def accuracy(input, label, k=1, correct=None, total=None):
    helper = LayerHelper("accuracy", input=input)
    topk_out = helper.create_variable_for_type_inference(input.dtype)
    topk_indices = helper.create_variable_for_type_inference(
        "int64", stop_gradient=True)
    helper.append_op("top_k", inputs={"X": [input]},
                     outputs={"Out": [topk_out], "Indices": [topk_indices]},
                     attrs={"k": k})
    acc_out = helper.create_variable_for_type_inference("float32",
                                                        stop_gradient=True)
    if correct is None:
        correct = helper.create_variable_for_type_inference(
            "int32", stop_gradient=True)
    if total is None:
        total = helper.create_variable_for_type_inference(
            "int32", stop_gradient=True)
    helper.append_op(
        "accuracy",
        inputs={"Out": [topk_out], "Indices": [topk_indices],
                "Label": [label]},
        outputs={"Accuracy": [acc_out], "Correct": [correct],
                 "Total": [total]})
    return acc_out


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1):
    helper = LayerHelper("auc", input=input)
    gb = helper.main_program.global_block()
    stats = []
    for name in ("auc_stat_pos", "auc_stat_neg"):
        v = gb.vars.get(name) or gb.create_var(
            name=name, dtype="int64", shape=[num_thresholds + 1],
            persistable=True)
        v.stop_gradient = True
        helper.set_variable_initializer(v, ConstantInitializer(0))
        stats.append(v)
    stat_pos, stat_neg = stats
    auc_out = helper.create_variable_for_type_inference("float64",
                                                        stop_gradient=True)
    helper.append_op(
        "auc",
        inputs={"Predict": [input], "Label": [label],
                "StatPos": [stat_pos], "StatNeg": [stat_neg]},
        outputs={"AUC": [auc_out], "StatPosOut": [stat_pos],
                 "StatNegOut": [stat_neg]},
        attrs={"curve": curve, "num_thresholds": num_thresholds,
               "slide_steps": slide_steps})
    return auc_out, [auc_out], [stat_pos, stat_neg]
