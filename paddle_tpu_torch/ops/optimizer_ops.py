"""Optimizer update ops: ``sgd``, ``momentum``, ``adam``, ``adamw`` and
``fused_optimizer``.

Counterparts of ``paddle_tpu/ops/optimizer_ops.py`` (:45, :62, :109, :139
and :341-458), with the same slots and attrs. Param and moment inputs are
re-bound through the same-named ``*Out`` outputs, so the executor's write
back is the update. None is ever differentiated (``grad=None``).

The per-parameter ops are the update math in plain torch, term for term
as in JAX (they are no Pallas kernel there either). ``fused_optimizer``
applies one optimizer instance's update to all its parameters at once
(``core/fusion.py`` builds it), in one of two layouts:

- ``chain``: StateA/StateB are the per-parameter accumulators and the
  shared update math (``fused_optimizer_update_reference``) runs pair by
  pair, in plain torch;
- ``flat``: StateA/StateB are single flat state vars; params and grads
  are flattened and zero-padded to ``padded_size``, and one
  ``fused_optimizer_update`` call updates the whole buffer: the K4 CUDA
  kernel on the card (in place), its plain version on the CPU. Updated
  params are slices of the flat buffer.

Either layout gives every element the same operations as the per-param
ops, so all three agree bit for bit. The ``use_pallas`` attr is kept so
that programs read the same in both packages; the port chooses by the
tensors' device, never by an attr.
"""
from __future__ import annotations

import torch

from ..core.registry import In, Out, register_op
from .cuda.fused_optimizer import (fused_optimizer_update,
                                   fused_optimizer_update_reference)


def _op(name, inputs, outputs, attrs, fn):
    register_op(name, inputs=[In(i) for i in inputs],
                outputs=[Out(o) for o in outputs], attrs=attrs,
                grad=None)(fn)


def _lr(ins):
    return ins["LearningRate"].reshape(())


def _sgd(ins, attrs):
    return {"ParamOut": ins["Param"] - _lr(ins) * ins["Grad"]}


_op("sgd", ["Param", "Grad", "LearningRate"], ["ParamOut"], {}, _sgd)


def _momentum(ins, attrs):
    mu = attrs.get("mu", 0.9)
    v = mu * ins["Velocity"] + ins["Grad"]
    if attrs.get("use_nesterov", False):
        p = ins["Param"] - (ins["Grad"] + mu * v) * _lr(ins)
    else:
        p = ins["Param"] - _lr(ins) * v
    return {"ParamOut": p, "VelocityOut": v}


_op("momentum", ["Param", "Grad", "Velocity", "LearningRate"],
    ["ParamOut", "VelocityOut"],
    {"mu": 0.9, "use_nesterov": False, "regularization_method": "",
     "regularization_coeff": 0.0}, _momentum)


def _adam(ins, attrs):
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    p, g = ins["Param"], ins["Grad"]
    m1 = b1 * ins["Moment1"] + (1 - b1) * g
    m2 = b2 * ins["Moment2"] + (1 - b2) * torch.square(g)
    b1pow = ins["Beta1Pow"].reshape(())
    b2pow = ins["Beta2Pow"].reshape(())
    lr = _lr(ins) * torch.sqrt(1 - b2pow) / (1 - b1pow)
    p_out = p - lr * m1 / (torch.sqrt(m2) + eps)
    return {"ParamOut": p_out, "Moment1Out": m1, "Moment2Out": m2,
            "Beta1PowOut": (b1pow * b1).reshape(ins["Beta1Pow"].shape),
            "Beta2PowOut": (b2pow * b2).reshape(ins["Beta2Pow"].shape)}


_ADAM_IN = ["Param", "Grad", "LearningRate", "Moment1", "Moment2",
            "Beta1Pow", "Beta2Pow"]
_ADAM_OUT = ["ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
             "Beta2PowOut"]
_op("adam", _ADAM_IN, _ADAM_OUT,
    {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8, "lazy_mode": False,
     "min_row_size_to_use_multithread": 1000}, _adam)


def _adamw(ins, attrs):
    out = _adam(ins, attrs)
    wd = attrs.get("weight_decay", 0.01)
    out["ParamOut"] = out["ParamOut"] - _lr(ins) * wd * ins["Param"]
    return out


_op("adamw", _ADAM_IN, _ADAM_OUT,
    {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8, "weight_decay": 0.01},
    _adamw)


@register_op(
    "fused_optimizer",
    inputs=[In("Param", duplicable=True), In("Grad", duplicable=True),
            In("LearningRate"),
            In("StateA", duplicable=True, dispensable=True),
            In("StateB", duplicable=True, dispensable=True),
            In("Beta1Pow", duplicable=True, dispensable=True),
            In("Beta2Pow", duplicable=True, dispensable=True)],
    outputs=[Out("ParamOut", duplicable=True),
             Out("StateAOut", duplicable=True, dispensable=True),
             Out("StateBOut", duplicable=True, dispensable=True),
             Out("Beta1PowOut", duplicable=True, dispensable=True),
             Out("Beta2PowOut", duplicable=True, dispensable=True)],
    attrs={"op_type": "sgd", "layout": "chain", "padded_size": 0,
           "use_pallas": True},
    grad=None,
)
def _fused_optimizer(ins, attrs):
    op_type = attrs["op_type"]
    params, grads = ins["Param"], ins["Grad"]
    lr = ins["LearningRate"].reshape(())
    b1pow = ins["Beta1Pow"][0].reshape(()) if ins.get("Beta1Pow") else None
    b2pow = ins["Beta2Pow"][0].reshape(()) if ins.get("Beta2Pow") else None

    result = {}
    if attrs.get("layout", "chain") == "flat":
        sizes = [p.numel() for p in params]
        padded = int(attrs.get("padded_size") or sum(sizes))

        def flat_pad(xs):
            flat = torch.cat([x.reshape(-1) for x in xs])
            if padded > flat.numel():
                flat = torch.cat([flat, flat.new_zeros(padded - flat.numel())])
            return flat

        sa = ins["StateA"][0] if ins.get("StateA") else None
        sb = ins["StateB"][0] if ins.get("StateB") else None
        p_new, sa_out, sb_out = fused_optimizer_update(
            op_type, attrs, flat_pad(params),
            flat_pad([g.to(params[0].dtype) for g in grads]),
            lr.reshape(1), sa, sb,
            None if b1pow is None else b1pow.reshape(1),
            None if b2pow is None else b2pow.reshape(1))
        result["ParamOut"] = [
            chunk.view(p.shape) for p, chunk in
            zip(params, p_new[:sum(sizes)].split(sizes))]
        result["StateAOut"] = [sa_out] if sa_out is not None else None
        result["StateBOut"] = [sb_out] if sb_out is not None else None
    else:
        sas = ins.get("StateA") or [None] * len(params)
        sbs = ins.get("StateB") or [None] * len(params)
        outs = [fused_optimizer_update_reference(
                    op_type, attrs, p, g.to(p.dtype), lr, sa, sb, b1pow,
                    b2pow)
                for p, g, sa, sb in zip(params, grads, sas, sbs)]
        p_outs, sa_outs, sb_outs = (list(t) for t in zip(*outs))
        result["ParamOut"] = p_outs
        result["StateAOut"] = sa_outs if sa_outs[0] is not None else None
        result["StateBOut"] = sb_outs if sb_outs[0] is not None else None

    for slot, beta in (("Beta1Pow", "beta1"), ("Beta2Pow", "beta2")):
        if ins.get(slot):
            b = attrs.get(beta, 0.9 if beta == "beta1" else 0.999)
            result[slot + "Out"] = [(t.reshape(()) * b).reshape(t.shape)
                                    for t in ins[slot]]
    return result
