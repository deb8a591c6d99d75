"""``cross_entropy`` and ``softmax_with_cross_entropy`` (counterparts of
``paddle_tpu/ops/loss_ops.py:33`` and ``:64``), ``square_error_cost`` and
``squared_l2_distance`` (``:105``, ``:115``), with the same slots and
attrs. ``cross_entropy`` takes probabilities, clipped to [1e-20, 1] before
the log as the reference does (max then min, so a value on a bound splits
its grad as JAX's ``clip`` does); ``softmax_with_cross_entropy`` is the
numerically stable form, log-softmax over ``axis`` then the label's entry.
Hard labels equal to ``ignore_index`` give a loss of 0; soft labels take
the full cross entropy. ``squared_l2_distance`` sums the squared
difference over the last axis and also gives the difference. Every grad
is the auto-VJP op."""
from __future__ import annotations

import torch

from ..core.registry import In, Out, register_op


def _label_xent(logp, label, ignore_index=-100, soft=False):
    if soft:
        return -(label * logp).sum(dim=-1, keepdim=True)
    lbl = label
    if lbl.dim() == logp.dim() and lbl.shape[-1] == 1:
        lbl = lbl.squeeze(-1)
    keep = (lbl != ignore_index)[..., None]
    idx = torch.where(keep[..., 0], lbl, torch.zeros_like(lbl))
    picked = torch.gather(logp, -1, idx[..., None].long())
    return torch.where(keep, -picked, torch.zeros_like(picked))


@register_op(
    "cross_entropy",
    inputs=[In("X"), In("Label", no_grad=True)],
    outputs=[Out("Y")],
    attrs={"soft_label": False, "ignore_index": -100},
)
def _cross_entropy(ins, attrs):
    x, label = ins["X"], ins["Label"]
    # filled on the device: a copy from the host cannot be captured
    lo = torch.full((), 1e-20, dtype=x.dtype, device=x.device)
    hi = torch.full((), 1.0, dtype=x.dtype, device=x.device)
    logp = torch.log(torch.minimum(torch.maximum(x, lo), hi))
    return {"Y": _label_xent(logp, label, attrs.get("ignore_index", -100),
                             attrs.get("soft_label", False))}


@register_op(
    "softmax_with_cross_entropy",
    inputs=[In("Logits"), In("Label", no_grad=True)],
    outputs=[Out("Softmax"), Out("Loss")],
    attrs={"soft_label": False, "ignore_index": -100,
           "numeric_stable_mode": True, "axis": -1},
)
def _softmax_with_cross_entropy(ins, attrs):
    logits, label = ins["Logits"], ins["Label"]
    axis = attrs.get("axis", -1)
    soft = attrs.get("soft_label", False)
    ignore = attrs.get("ignore_index", -100)
    logp = torch.log_softmax(logits, dim=axis)
    softmax = torch.exp(logp)
    if axis not in (-1, logits.dim() - 1):
        # move the class axis last for the gather, then back
        lbl = label.movedim(axis, -1) if soft else label
        loss = _label_xent(logp.movedim(axis, -1), lbl, ignore, soft)
        loss = loss.movedim(-1, axis)
    else:
        loss = _label_xent(logp, label, ignore, soft)
    return {"Softmax": softmax, "Loss": loss}


@register_op(
    "square_error_cost",
    inputs=[In("X"), In("Y")],
    outputs=[Out("Out")],
)
def _square_error_cost(ins, attrs):
    return {"Out": torch.square(ins["X"] - ins["Y"])}


@register_op(
    "squared_l2_distance",
    inputs=[In("X"), In("Y")],
    outputs=[Out("Out"), Out("sub_result", no_grad=True)],
)
def _squared_l2_distance(ins, attrs):
    sub = ins["X"] - ins["Y"]
    return {"Out": torch.square(sub).sum(dim=-1, keepdim=True),
            "sub_result": sub}
