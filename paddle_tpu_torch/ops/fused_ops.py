"""Fused ops: ``fc``, ``fused_bias_act``, ``fused_residual_layer_norm`` and
``flash_attention`` (counterparts of ``paddle_tpu/ops/fused_ops.py:84``,
``:117``, ``:165`` and ``:193``).

``fc`` is what ``ir.FcFusePass`` turns ``mul -> elementwise_add [->
relu]`` into when the inference predictor loads a model: it flattens
``Input`` at ``in_num_col_dims`` and runs the registered ``mul``, the bias
add and ``relu``, in that order, so it gives the chain's bits. It is a
device op (the whole-program route captures it) with the auto-VJP grad,
as the JAX op has.

The two epilogue ops are what ``core.fusion.apply_fused_epilogues`` turns
a forward chain into: ``elementwise_add -> act [-> dropout]`` and
``elementwise_add -> layer_norm``. Each stage calls the port's registered
function of the op it replaces, in program order, so the fused op gives
the chain's bits, its dropout mask included: the fused op draws from the
absorbed ``dropout`` op's stream (``_rng_op_id``), the stream the
pre-built ``dropout_grad`` draws from. Every intermediate the pre-built
backward reads (``AddOut``, ``ActOut``, ``Mask``, ``Mean``,
``Variance``) is emitted under its original name. Neither op has a grad
(``grad=None``): the backward stays the chain's.

``flash_attention`` is attention over ``[B, H, S, D]`` through the
hand-written CUDA kernels on the card and their plain versions on the CPU
(``ops/cuda/flash_attention.py``). ``Lengths`` ([B] int) is the
kernel-side key padding mask. The op runs ``FlashAttentionFunction``, so
its auto-VJP grad op re-runs the forward kernel (K1) and then the
backward kernels (K2 for dQ, K3 for dK and dV), as JAX's auto-VJP re-runs
``_flash_fwd`` under ``jax.vjp``."""
from __future__ import annotations

import torch

from ..core.registry import GENERATOR_ATTR, In, OpInfoMap, Out, register_op
from .cuda.flash_attention import FlashAttentionFunction


def _registry_fn(op_type):
    return OpInfoMap.instance().get(op_type).fn


@register_op(
    "fc",
    inputs=[In("Input"), In("W"), In("Bias", dispensable=True)],
    outputs=[Out("Out")],
    attrs={"in_num_col_dims": 1, "activation_type": ""},
)
def _fc(ins, attrs):
    k = int(attrs.get("in_num_col_dims", 1))
    out = _registry_fn("mul")({"X": ins["Input"], "Y": ins["W"]},
                              {"x_num_col_dims": k,
                               "y_num_col_dims": 1})["Out"]
    if ins.get("Bias") is not None:
        out = out + ins["Bias"].reshape(-1)
    act = attrs.get("activation_type", "")
    if act == "relu":
        out = _registry_fn("relu")({"X": out}, {})["Out"]
    elif act:
        raise NotImplementedError("fc activation %r" % act)
    return {"Out": out}


@register_op(
    "fused_bias_act",
    inputs=[In("X"), In("Y")],
    outputs=[Out("Out"), Out("AddOut", dispensable=True),
             Out("ActOut", dispensable=True),
             Out("Mask", dispensable=True, no_grad=True)],
    attrs={"act": "relu", "axis": -1, "approximate": False,
           "alpha": 0.02, "dropout_prob": -1.0, "is_test": False,
           "fix_seed": False, "seed": 0,
           "dropout_implementation": "downgrade_in_infer"},
    grad=None,
    needs_rng=True,
)
def _fused_bias_act(ins, attrs):
    """``elementwise_add``, the activation ``act`` and, when
    ``dropout_prob >= 0``, ``dropout``, each through its registered
    function."""
    inter = _registry_fn("elementwise_add")(
        {"X": ins["X"], "Y": ins["Y"]},
        {"axis": attrs.get("axis", -1)})["Out"]
    out = _registry_fn(attrs.get("act", "relu"))({"X": inter},
                                                  dict(attrs))["Out"]
    act_out = out
    mask = None
    if float(attrs.get("dropout_prob", -1.0)) >= 0.0:
        d = _registry_fn("dropout")(
            {"X": out, "Seed": None},
            {"dropout_prob": attrs.get("dropout_prob"),
             "is_test": attrs.get("is_test", False),
             "dropout_implementation": attrs.get(
                 "dropout_implementation", "downgrade_in_infer"),
             GENERATOR_ATTR: attrs.get(GENERATOR_ATTR)})
        out, mask = d["Out"], d.get("Mask")
    return {"Out": out, "AddOut": inter, "ActOut": act_out, "Mask": mask}


@register_op(
    "fused_residual_layer_norm",
    inputs=[In("X"), In("Y"), In("Scale", dispensable=True),
            In("Bias", dispensable=True)],
    outputs=[Out("Out"), Out("AddOut", dispensable=True),
             Out("Mean", dispensable=True, no_grad=True),
             Out("Variance", dispensable=True, no_grad=True)],
    attrs={"axis": -1, "epsilon": 1e-5, "begin_norm_axis": 1},
    grad=None,
)
def _fused_residual_layer_norm(ins, attrs):
    """``elementwise_add`` then ``layer_norm``, each through its
    registered function."""
    inter = _registry_fn("elementwise_add")(
        {"X": ins["X"], "Y": ins["Y"]},
        {"axis": attrs.get("axis", -1)})["Out"]
    ln = _registry_fn("layer_norm")(
        {"X": inter, "Scale": ins.get("Scale"), "Bias": ins.get("Bias")},
        {"epsilon": attrs.get("epsilon", 1e-5),
         "begin_norm_axis": attrs.get("begin_norm_axis", 1)})
    return {"Out": ln["Y"], "AddOut": inter, "Mean": ln["Mean"],
            "Variance": ln["Variance"]}


@register_op(
    "flash_attention",
    inputs=[In("Q"), In("K"), In("V"),
            In("Lengths", dispensable=True, no_grad=True)],
    outputs=[Out("Out")],
    attrs={"causal": False, "scale": 0.0},
)
def _flash_attention(ins, attrs):
    # Q, K, V arrive as views from transpose2; the kernel reads
    # contiguous [B, H, S, D] memory
    q, k, v = (ins[s].contiguous() for s in ("Q", "K", "V"))
    if q.device.type == "meta":  # shape inference
        return {"Out": torch.empty_like(q)}
    scale = attrs.get("scale", 0.0) or float(q.shape[-1]) ** -0.5
    out = FlashAttentionFunction.apply(q, k, v, ins.get("Lengths"),
                                       bool(attrs.get("causal")), scale)
    return {"Out": out}
