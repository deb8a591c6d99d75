"""``batch_norm``, ``layer_norm`` and ``dropout`` (counterparts of
``paddle_tpu/ops/norm_ops.py:18``, ``:105`` and ``:183``).

``batch_norm`` keeps the five-output contract: ``Y``; ``MeanOut`` and
``VarianceOut``, the running statistics, bound to the same variables as
``Mean`` and ``Variance`` (the executor writes every output back to the
scope, so they update in place there); ``SavedMean`` and ``SavedVariance``,
the latter the inverse standard deviation. It is written out in plain torch
ops in the JAX package's order, not ``F.batch_norm``: the running update is
``running * momentum + batch * (1 - momentum)`` with the biased batch
variance, where torch's ``momentum`` weights the new value and its
running variance is unbiased. Cross-replica statistics (``_sync_stats``)
raise until the parallel package is ported.

``layer_norm`` normalises over the dims from ``begin_norm_axis`` on, then
scales and shifts; ``Mean`` and ``Variance`` are flattened over the leading
dims.

``dropout`` keeps an element with probability ``1 - dropout_prob``: its
``Mask`` (X's type, 1 kept, 0 dropped) comes from uniform draws of the
``torch.Generator`` the executor seeds for it (``GENERATOR_ATTR``, on the
executor's device, from its ``seed`` attr when set, else from the
executor's seed, the step and the op's id), so the numbers differ from
``jax.random``'s and the contract is the distribution and the mask: the
grad op (the auto-VJP, which re-runs this function with a generator
seeded alike) multiplies by the forward's mask. ``upscale_in_train``
scales the kept elements by ``1 / (1 - p)`` in training (zeros at
``p >= 1``) and passes X through under ``is_test``;
``downgrade_in_infer`` keeps them as they are in training and scales X by
``1 - p`` under ``is_test``, where no mask is drawn."""
from __future__ import annotations

import math

import torch

from ..core.registry import GENERATOR_ATTR, In, Out, register_op


@register_op(
    "batch_norm",
    inputs=[
        In("X"),
        In("Scale"),
        In("Bias"),
        In("Mean", no_grad=True),
        In("Variance", no_grad=True),
        In("MomentumTensor", dispensable=True, no_grad=True),
    ],
    outputs=[
        Out("Y"),
        Out("MeanOut", no_grad=True),
        Out("VarianceOut", no_grad=True),
        Out("SavedMean", no_grad=True),
        Out("SavedVariance", no_grad=True),
        Out("ReserveSpace", dispensable=True, no_grad=True),
    ],
    attrs={
        "momentum": 0.9,
        "epsilon": 1e-5,
        "is_test": False,
        "data_layout": "NCHW",
        "use_global_stats": False,
        "trainable_statistics": False,
        "fuse_with_relu": False,
        "use_mkldnn": False,
    },
)
def _batch_norm(ins, attrs):
    x = ins["X"]
    scale, bias = ins["Scale"], ins["Bias"]
    mean, var = ins["Mean"], ins["Variance"]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    layout = attrs.get("data_layout", "NCHW")
    use_global = attrs.get("is_test", False) or attrs.get(
        "use_global_stats", False)

    c_axis = 1 if layout == "NCHW" else x.dim() - 1
    red = tuple(i for i in range(x.dim()) if i != c_axis)
    bshape = [1] * x.dim()
    bshape[c_axis] = x.shape[c_axis]

    if use_global:
        use_mean, use_var = mean, var
        mean_out, var_out = mean, var
    else:
        if attrs.get("_sync_stats"):
            raise NotImplementedError(
                "batch_norm with cross-replica statistics (_sync_stats) "
                "needs the parallel package, not yet ported (ROADMAP.md, "
                "queue 1)")
        use_mean = x.mean(dim=red)
        use_var = (x - use_mean.reshape(bshape)).square().mean(dim=red)
        mean_out = mean * momentum + use_mean * (1 - momentum)
        var_out = var * momentum + use_var * (1 - momentum)

    inv_std = torch.rsqrt(use_var + eps)
    y = ((x - use_mean.reshape(bshape)) * (scale * inv_std).reshape(bshape)
         + bias.reshape(bshape))
    return {
        "Y": y,
        "MeanOut": mean_out,
        "VarianceOut": var_out,
        "SavedMean": use_mean,
        "SavedVariance": inv_std,  # the reference saves the inverse std
        "ReserveSpace": None,
    }


@register_op(
    "layer_norm",
    inputs=[In("X"), In("Scale", dispensable=True),
            In("Bias", dispensable=True)],
    outputs=[Out("Y"), Out("Mean", no_grad=True),
             Out("Variance", no_grad=True)],
    attrs={"epsilon": 1e-5, "begin_norm_axis": 1},
)
def _layer_norm(ins, attrs):
    x = ins["X"]
    eps = attrs.get("epsilon", 1e-5)
    axis = attrs.get("begin_norm_axis", 1)
    red = tuple(range(axis, x.dim()))
    mean = x.mean(dim=red, keepdim=True)
    var = (x - mean).square().mean(dim=red, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    norm_shape = (1,) * axis + tuple(x.shape[axis:])
    if ins.get("Scale") is not None:
        y = y * ins["Scale"].reshape(norm_shape)
    if ins.get("Bias") is not None:
        y = y + ins["Bias"].reshape(norm_shape)
    lead = math.prod(x.shape[:axis])
    return {"Y": y, "Mean": mean.reshape(lead),
            "Variance": var.reshape(lead)}


@register_op(
    "dropout",
    inputs=[In("X"), In("Seed", dispensable=True, no_grad=True)],
    outputs=[Out("Out"), Out("Mask", no_grad=True)],
    attrs={
        "dropout_prob": 0.5,
        "is_test": False,
        "fix_seed": False,
        "seed": 0,
        "dropout_implementation": "downgrade_in_infer",
    },
    needs_rng=True,
)
def _dropout(ins, attrs):
    x = ins["X"]
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if attrs.get("is_test", False):
        out = x if impl == "upscale_in_train" else x * (1.0 - p)
        return {"Out": out, "Mask": None}
    u = torch.rand(x.shape, generator=attrs.get(GENERATOR_ATTR),
                   dtype=torch.float32, device=x.device)
    mask = (u < 1.0 - p).to(x.dtype)
    if impl == "upscale_in_train":
        out = torch.zeros_like(x) if p >= 1.0 else x * mask / (1.0 - p)
    else:
        out = x * mask
    return {"Out": out, "Mask": mask}
