"""``accuracy`` and ``auc`` (counterparts of
``paddle_tpu/ops/metrics_ops.py:13`` and ``:38``), with the same slots and
attrs (reference metrics/accuracy_op.cc, auc_op.cc).

- ``accuracy``: the share of rows whose top-k ``Indices`` hold the label;
  ``Correct`` and ``Total`` are int32, as the JAX op gives them.
- ``auc``: each prediction (column 1 of a two-column ``Predict``) adds one
  to its threshold bucket of ``StatPos`` or ``StatNeg``, written back in
  place; the AUC is the trapezoid over the descending thresholds of the
  cumulated true- and false-positive rates. The port keeps the
  reference's int64 statistics and float64 area where the JAX package,
  with x64 off, runs int32 and float32: the counts agree exactly, the
  area to float32's rounding.
"""
from __future__ import annotations

import torch

from ..core.registry import In, Out, register_op


@register_op(
    "accuracy",
    inputs=[In("Out", no_grad=True), In("Indices", no_grad=True),
            In("Label", no_grad=True)],
    outputs=[Out("Accuracy"), Out("Correct"), Out("Total")],
    grad=None,
)
def _accuracy(ins, attrs):
    indices, label = ins["Indices"], ins["Label"]
    if label.dim() == indices.dim() - 1:
        label = label[..., None]
    hit = (indices == label).any(dim=-1)
    total = hit.shape[0]
    correct = hit.sum(dtype=torch.int32)
    return {
        "Accuracy": (correct.to(torch.float32) / float(total)).reshape(1),
        "Correct": correct.reshape(1),
        "Total": torch.full((1,), total, dtype=torch.int32,
                            device=indices.device),
    }


@register_op(
    "auc",
    inputs=[In("Predict", no_grad=True), In("Label", no_grad=True),
            In("StatPos", no_grad=True), In("StatNeg", no_grad=True)],
    outputs=[Out("AUC"), Out("StatPosOut"), Out("StatNegOut")],
    attrs={"curve": "ROC", "num_thresholds": 4095, "slide_steps": 1},
    grad=None,
)
def _auc(ins, attrs):
    num_t = attrs.get("num_thresholds", 4095)
    pred = ins["Predict"]
    pred = pred[:, 1] if pred.dim() == 2 else pred
    label = ins["Label"].reshape(-1)
    bucket = (pred * num_t).to(torch.int32).clamp(0, num_t).long()
    pos = ins["StatPos"].reshape(-1).to(torch.int64).index_add(
        0, bucket, (label > 0).to(torch.int64))
    neg = ins["StatNeg"].reshape(-1).to(torch.int64).index_add(
        0, bucket, (label <= 0).to(torch.int64))
    pos_rev = torch.cumsum(pos.flip(0), 0).to(torch.float64)
    neg_rev = torch.cumsum(neg.flip(0), 0).to(torch.float64)
    tpr = pos_rev / pos_rev[-1].clamp(min=1.0)
    fpr = neg_rev / neg_rev[-1].clamp(min=1.0)
    area = torch.trapezoid(tpr, fpr)
    return {
        "AUC": area.reshape(1),
        "StatPosOut": pos.reshape(ins["StatPos"].shape).to(
            ins["StatPos"].dtype),
        "StatNegOut": neg.reshape(ins["StatNeg"].shape).to(
            ins["StatNeg"].dtype),
    }
