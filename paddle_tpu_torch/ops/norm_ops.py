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
running variance is unbiased. Cross-replica statistics (``_sync_stats``,
``BuildStrategy.sync_batch_norm``) take the JAX package's math: the
pmean of the local mean and of the local E[x^2], var = E[x^2] - mean^2.
Its grad op reduces over the replicas too: ``batch_norm_grad``'s form over
the replicas of one process differentiates every replica's forward as one
graph through the shared statistics, and across processes the psum
differentiates as a psum of the cotangents. So the replicas' input grads
are the full batch's, as the reference's ``sync_batch_norm_op.cu`` grad
gives them; the JAX package's grad takes local statistics there.

``layer_norm`` normalises over the dims from ``begin_norm_axis`` on, then
scales and shifts; ``Mean`` and ``Variance`` are flattened over the leading
dims. Where those dims take in a sequence that sequence parallelism split
(``shard_axis``, set by ``parallel/transpiler.apply_sequence_parallel``),
its form over the replicas takes the statistics of the whole row, and its
grad op differentiates every replica's forward as one graph, as sync
batch norm's does.

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

from ..core.registry import (GENERATOR_ATTR, In, OpInfoMap, Out,
                             register_op, set_group_form, vjp_grad_group)
from .collective_ops import group_for_axis


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
    group = _sync_group(attrs)
    if group is not None and group.in_process:
        raise RuntimeError("batch_norm with _sync_stats reached one replica "
                           "of an in-process group outside the replica walk")
    return _batch_norm_group([ins], attrs, group)[0]


def _sync_group(attrs):
    """The group a sync batch norm's statistics reduce over, else None."""
    if not attrs.get("_sync_stats") or attrs.get("is_test", False) or \
            attrs.get("use_global_stats", False):
        return None
    from .collective_ops import axis_for_ring

    return axis_for_ring(attrs.get("_sync_ring_id", 0))


def _batch_norm_group(ins_list, attrs, group):
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    layout = attrs.get("data_layout", "NCHW")
    use_global = attrs.get("is_test", False) or attrs.get(
        "use_global_stats", False)
    x0 = ins_list[0]["X"]
    c_axis = 1 if layout == "NCHW" else x0.dim() - 1
    red = tuple(i for i in range(x0.dim()) if i != c_axis)
    bshape = [1] * x0.dim()
    bshape[c_axis] = x0.shape[c_axis]

    if group is not None:
        # pmean of the local mean and of the local E[x^2]
        n = group.nranks
        means = _psum(group, [ins["X"].mean(dim=red) for ins in ins_list])
        sqs = _psum(group, [ins["X"].square().mean(dim=red)
                            for ins in ins_list])
        stats = [(m / n, s / n - (m / n).square())
                 for m, s in zip(means, sqs)]
    outs = []
    for r, ins in enumerate(ins_list):
        x = ins["X"]
        scale, bias = ins["Scale"], ins["Bias"]
        mean, var = ins["Mean"], ins["Variance"]
        if use_global:
            use_mean, use_var = mean, var
            mean_out, var_out = mean, var
        else:
            if group is not None:
                use_mean, use_var = stats[r]
            else:
                use_mean = x.mean(dim=red)
                use_var = (x - use_mean.reshape(bshape)).square().mean(
                    dim=red)
            mean_out = mean * momentum + use_mean * (1 - momentum)
            var_out = var * momentum + use_var * (1 - momentum)
        inv_std = torch.rsqrt(use_var + eps)
        y = ((x - use_mean.reshape(bshape))
             * (scale * inv_std).reshape(bshape) + bias.reshape(bshape))
        outs.append({
            "Y": y,
            "MeanOut": mean_out,
            "VarianceOut": var_out,
            "SavedMean": use_mean,
            "SavedVariance": inv_std,  # the reference saves the inverse std
            "ReserveSpace": None,
        })
    return outs


class _ProcessPsum(torch.autograd.Function):
    """psum over a process group whose grad is the psum of the
    cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.psum([x])[0]

    @staticmethod
    def backward(ctx, g):
        return ctx.group.psum([g.contiguous()])[0], None


def _psum(group, xs):
    """The group's psum, differentiable: in one process its rank-order sum
    is torch ops already."""
    if group.in_process or not torch.is_grad_enabled():
        return group.psum(xs)
    return [_ProcessPsum.apply(x, group) for x in xs]


def _batch_norm_grad_group(ins_list, attrs, group):
    """The auto-VJP of every replica's sync batch norm as one graph."""
    return vjp_grad_group(
        OpInfoMap.instance().get("batch_norm"), ins_list, attrs,
        lambda rebuilt, a: _batch_norm_group(rebuilt, a, group))


set_group_form("batch_norm", _sync_group, _batch_norm_group)
set_group_form("batch_norm_grad", _sync_group, _batch_norm_grad_group)


@register_op(
    "layer_norm",
    inputs=[In("X"), In("Scale", dispensable=True),
            In("Bias", dispensable=True)],
    outputs=[Out("Y"), Out("Mean", no_grad=True),
             Out("Variance", no_grad=True)],
    attrs={"epsilon": 1e-5, "begin_norm_axis": 1},
)
def _layer_norm(ins, attrs):
    group = _seq_group(attrs)
    if group is not None and group.in_process:
        raise RuntimeError("layer_norm over a split sequence reached one "
                           "replica outside the replica walk")
    return _layer_norm_group([ins], attrs, group)[0]


def _seq_group(attrs):
    """The group a layer norm over a split sequence reduces over (its
    ``shard_axis``, set by the sequence-parallel pass), else None."""
    return group_for_axis(attrs.get("shard_axis") or None)


def _layer_norm_group(ins_list, attrs, group):
    """Each replica holds one block of the normalized row (its share of
    the sequence) and the Scale and Bias blocks that go with it. Over a
    group the mean is the psum of the replicas' sums over the whole
    row's count, and the variance the psum of their sums of squared
    deviations from that mean, so every replica normalizes by the
    statistics of the whole row, as the dense op does (two passes, as
    the dense op takes them)."""
    eps = attrs.get("epsilon", 1e-5)
    axis = attrs.get("begin_norm_axis", 1)
    x0 = ins_list[0]["X"]
    red = tuple(range(axis, x0.dim()))
    if group is None:
        stats = [None] * len(ins_list)
    else:
        count = math.prod(x0.shape[axis:]) * group.nranks
        sums = _psum(group, [ins["X"].sum(dim=red, keepdim=True)
                             for ins in ins_list])
        means = [s / count for s in sums]
        sqs = _psum(group, [(ins["X"] - m).square().sum(dim=red,
                                                        keepdim=True)
                            for ins, m in zip(ins_list, means)])
        stats = [(m, q / count) for m, q in zip(means, sqs)]
    outs = []
    for ins, st in zip(ins_list, stats):
        x = ins["X"]
        if st is None:
            mean = x.mean(dim=red, keepdim=True)
            var = (x - mean).square().mean(dim=red, keepdim=True)
        else:
            mean, var = st
        y = (x - mean) * torch.rsqrt(var + eps)
        norm_shape = (1,) * axis + tuple(x.shape[axis:])
        if ins.get("Scale") is not None:
            y = y * ins["Scale"].reshape(norm_shape)
        if ins.get("Bias") is not None:
            y = y + ins["Bias"].reshape(norm_shape)
        lead = math.prod(x.shape[:axis])
        outs.append({"Y": y, "Mean": mean.reshape(lead),
                     "Variance": var.reshape(lead)})
    return outs


def _layer_norm_grad_group(ins_list, attrs, group):
    """The auto-VJP of every replica's layer norm as one graph through the
    shared statistics."""
    return vjp_grad_group(
        OpInfoMap.instance().get("layer_norm"), ins_list, attrs,
        lambda rebuilt, a: _layer_norm_group(rebuilt, a, group))


set_group_form("layer_norm", _seq_group, _layer_norm_group)
set_group_form("layer_norm_grad", _seq_group, _layer_norm_grad_group)


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
