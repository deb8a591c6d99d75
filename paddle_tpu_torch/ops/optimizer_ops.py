"""Optimizer update ops: ``sgd``, ``momentum``, ``lars_momentum``,
``adam``, ``adamw``, ``adamax``, ``adagrad``, ``decayed_adagrad``,
``adadelta``, ``rmsprop``, ``ftrl``, ``lamb``, ``dpsgd``, the deep
gradient compression ops ``dgc``, ``dgc_momentum`` and
``dgc_clip_by_norm`` (``:528-586``, ``:673-724``) and
``fused_optimizer``; and the parameter-averaging ops ``ema_accumulate``,
``ema_adaptive_decay``, ``lookahead_update`` and
``model_average_accumulate`` (``paddle_tpu/ops/optimizer_ops.py:590-669``)
that ``ExponentialMovingAverage``, ``LookaheadOptimizer`` and
``ModelAverage`` append after the update.

Counterparts of ``paddle_tpu/ops/optimizer_ops.py`` (:45, :62, :100, :109,
:139, :171, :189, :207, :230, :262, :299, :308, :471 and :341-458), with
the same slots and attrs. ``lamb`` and ``lars_momentum`` take two full
reductions a parameter (its norm and its update's or grad's), so they stay
one op a parameter: the fused pass leaves them alone, as the JAX pass
does. ``dpsgd`` clips the grad by its norm and adds no noise, as the JAX
op (which omits the noise) does. Param and moment inputs are
re-bound through the same-named ``*Out`` outputs, so the executor's write
back is the update. None is ever differentiated (``grad=None``).

The per-parameter ops are the update math in plain torch, term for term
as in JAX (they are no Pallas kernel there either). A ``SelectedRows``
grad (an ``is_sparse`` embedding's) updates only its rows under ``sgd``
(``index_add``, :46-55), is made dense (duplicate rows summed) under
``momentum``, ``adam`` (and ``adamw``, which runs it), ``adagrad`` and
``rmsprop`` (``_maybe_densify_grad``,
:33), and raises under the rest, as in the JAX package. ``fused_optimizer``
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
from ..core.tensor import SelectedRows
from .cuda.fused_optimizer import (fused_optimizer_update,
                                   fused_optimizer_update_reference)


def _op(name, inputs, outputs, attrs, fn, sparse=None):
    """Register an update op. A ``SelectedRows`` grad (the embedding's
    ``is_sparse`` grad) reaches ``fn`` as it is where ``sparse`` is
    ``"rows"``, is made dense first where it is ``"densify"``, and raises
    otherwise: the same ops take one as in the JAX package."""

    def body(ins, attrs):
        g = ins.get("Grad")
        if isinstance(g, SelectedRows):
            if sparse is None:
                raise TypeError(
                    "%s takes no SelectedRows grad (an is_sparse "
                    "embedding's), as in the JAX package" % name)
            if sparse == "densify":
                ins = dict(ins, Grad=g.to_dense())
        return fn(ins, attrs)

    register_op(name, inputs=[In(i) for i in inputs],
                outputs=[Out(o) for o in outputs], attrs=attrs,
                grad=None)(body)


def _lr(ins):
    return ins["LearningRate"].reshape(())


def _sgd(ins, attrs):
    g = ins["Grad"]
    if isinstance(g, SelectedRows):
        # only the touched rows move; duplicate rows add up
        vals = g.get_tensor().array
        return {"ParamOut": ins["Param"].index_add(
            0, g.rows_on(vals.device), -_lr(ins) * vals)}
    return {"ParamOut": ins["Param"] - _lr(ins) * g}


_op("sgd", ["Param", "Grad", "LearningRate"], ["ParamOut"], {}, _sgd,
    sparse="rows")


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
     "regularization_coeff": 0.0}, _momentum,
    sparse="densify")


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
     "min_row_size_to_use_multithread": 1000}, _adam,
    sparse="densify")


def _adamw(ins, attrs):
    out = _adam(ins, attrs)
    wd = attrs.get("weight_decay", 0.01)
    out["ParamOut"] = out["ParamOut"] - _lr(ins) * wd * ins["Param"]
    return out


_op("adamw", _ADAM_IN, _ADAM_OUT,
    {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8, "weight_decay": 0.01},
    _adamw, sparse="densify")


def _lars_momentum(ins, attrs):
    mu = attrs.get("mu", 0.9)
    lars_coeff = attrs.get("lars_coeff", 0.001)
    wd = attrs.get("lars_weight_decay", 0.0005)
    eps = attrs.get("epsilon", 0.0)
    p, g, v = ins["Param"], ins["Grad"], ins["Velocity"]
    p_norm = torch.sqrt(torch.sum(torch.square(p)))
    g_norm = torch.sqrt(torch.sum(torch.square(g)))
    local_lr = torch.where((p_norm > 0) & (g_norm > 0),
                           lars_coeff * p_norm / (g_norm + wd * p_norm + eps),
                           torch.ones_like(p_norm))
    v_out = mu * v + _lr(ins) * local_lr * (g + wd * p)
    return {"ParamOut": p - v_out, "VelocityOut": v_out}


_op("lars_momentum", ["Param", "Grad", "Velocity", "LearningRate"],
    ["ParamOut", "VelocityOut"],
    {"mu": 0.9, "lars_coeff": 0.001, "lars_weight_decay": 0.0005,
     "epsilon": 0.0}, _lars_momentum)


def _adamax(ins, attrs):
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    g = ins["Grad"]
    m = b1 * ins["Moment"] + (1 - b1) * g
    inf_norm = torch.maximum(b2 * ins["InfNorm"], torch.abs(g))
    b1pow = ins["Beta1Pow"].reshape(())
    lr = _lr(ins) / (1 - b1pow)
    p_out = ins["Param"] - lr * m / (inf_norm + eps)
    return {"ParamOut": p_out, "MomentOut": m, "InfNormOut": inf_norm}


_op("adamax", ["Param", "Grad", "LearningRate", "Moment", "InfNorm",
               "Beta1Pow"],
    ["ParamOut", "MomentOut", "InfNormOut"],
    {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}, _adamax)


def _adagrad(ins, attrs):
    eps = attrs.get("epsilon", 1e-6)
    g = ins["Grad"]
    moment = ins["Moment"] + torch.square(g)
    p_out = ins["Param"] - _lr(ins) * g / (torch.sqrt(moment) + eps)
    return {"ParamOut": p_out, "MomentOut": moment}


_op("adagrad", ["Param", "Grad", "Moment", "LearningRate"],
    ["ParamOut", "MomentOut"], {"epsilon": 1e-6}, _adagrad,
    sparse="densify")


def _decayed_adagrad(ins, attrs):
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    g = ins["Grad"]
    moment = decay * ins["Moment"] + (1 - decay) * torch.square(g)
    p_out = ins["Param"] - _lr(ins) * g / (torch.sqrt(moment) + eps)
    return {"ParamOut": p_out, "MomentOut": moment}


_op("decayed_adagrad", ["Param", "Grad", "Moment", "LearningRate"],
    ["ParamOut", "MomentOut"], {"decay": 0.95, "epsilon": 1e-6},
    _decayed_adagrad)


def _adadelta(ins, attrs):
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    g = ins["Grad"]
    avg_sq = rho * ins["AvgSquaredGrad"] + (1 - rho) * torch.square(g)
    update = -torch.sqrt((ins["AvgSquaredUpdate"] + eps)
                         / (avg_sq + eps)) * g
    avg_upd = rho * ins["AvgSquaredUpdate"] + (1 - rho) * torch.square(update)
    return {"ParamOut": ins["Param"] + update, "AvgSquaredGradOut": avg_sq,
            "AvgSquaredUpdateOut": avg_upd}


_op("adadelta", ["Param", "Grad", "AvgSquaredGrad", "AvgSquaredUpdate"],
    ["ParamOut", "AvgSquaredGradOut", "AvgSquaredUpdateOut"],
    {"rho": 0.95, "epsilon": 1e-6}, _adadelta)


def _rmsprop(ins, attrs):
    eps = attrs.get("epsilon", 1e-10)
    decay = attrs.get("decay", 0.9)
    momentum = attrs.get("momentum", 0.0)
    g = ins["Grad"]
    ms = decay * ins["MeanSquare"] + (1 - decay) * torch.square(g)
    if attrs.get("centered", False):
        mg = decay * ins["MeanGrad"] + (1 - decay) * g
        denom = ms - torch.square(mg) + eps
    else:
        mg = ins["MeanGrad"]
        denom = ms + eps
    mom = momentum * ins["Moment"] + _lr(ins) * g * torch.rsqrt(denom)
    return {"ParamOut": ins["Param"] - mom, "MomentOut": mom,
            "MeanSquareOut": ms, "MeanGradOut": mg}


_op("rmsprop", ["Param", "Grad", "LearningRate", "Moment", "MeanSquare",
                "MeanGrad"],
    ["ParamOut", "MomentOut", "MeanSquareOut", "MeanGradOut"],
    {"epsilon": 1e-10, "decay": 0.9, "momentum": 0.0, "centered": False},
    _rmsprop,
    sparse="densify")


def _ftrl(ins, attrs):
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    lr_power = attrs.get("lr_power", -0.5)
    g = ins["Grad"]
    lr = _lr(ins)
    sq_accum = ins["SquaredAccumulator"]
    new_accum = sq_accum + torch.square(g)
    if lr_power == -0.5:
        sigma = (torch.sqrt(new_accum) - torch.sqrt(sq_accum)) / lr
    else:
        sigma = (torch.pow(new_accum, -lr_power)
                 - torch.pow(sq_accum, -lr_power)) / lr
    lin_out = ins["LinearAccumulator"] + g - sigma * ins["Param"]
    # the shrink's denominator takes 2 * l2, as the JAX op's
    if lr_power == -0.5:
        x = 2.0 * l2 + torch.sqrt(new_accum) / lr
    else:
        x = 2.0 * l2 + torch.pow(new_accum, -lr_power) / lr
    pre = torch.clamp(lin_out, -l1, l1) - lin_out
    p_out = torch.where(torch.abs(lin_out) > l1, pre / x,
                        torch.zeros_like(pre))
    return {"ParamOut": p_out, "SquaredAccumOut": new_accum,
            "LinearAccumOut": lin_out}


_op("ftrl", ["Param", "SquaredAccumulator", "LinearAccumulator", "Grad",
             "LearningRate"],
    ["ParamOut", "SquaredAccumOut", "LinearAccumOut"],
    {"l1": 0.0, "l2": 0.0, "lr_power": -0.5}, _ftrl)


def _lamb(ins, attrs):
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-6)
    wd = attrs.get("weight_decay", 0.01)
    p, g = ins["Param"], ins["Grad"]
    m1 = b1 * ins["Moment1"] + (1 - b1) * g
    m2 = b2 * ins["Moment2"] + (1 - b2) * torch.square(g)
    b1pow = ins["Beta1Pow"].reshape(())
    b2pow = ins["Beta2Pow"].reshape(())
    m1_hat = m1 / (1 - b1pow)
    m2_hat = m2 / (1 - b2pow)
    r = m1_hat / (torch.sqrt(m2_hat) + eps) + wd * p
    p_norm = torch.sqrt(torch.sum(torch.square(p)))
    r_norm = torch.sqrt(torch.sum(torch.square(r)))
    ratio = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm, 1.0)
    return {"ParamOut": p - _lr(ins) * ratio * r, "Moment1Out": m1,
            "Moment2Out": m2,
            "Beta1PowOut": (b1pow * b1).reshape(ins["Beta1Pow"].shape),
            "Beta2PowOut": (b2pow * b2).reshape(ins["Beta2Pow"].shape)}


_op("lamb", _ADAM_IN, _ADAM_OUT,
    {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6, "weight_decay": 0.01},
    _lamb)


def _dpsgd(ins, attrs):
    clip = attrs.get("clip", 10.0)
    g = ins["Grad"]
    norm = torch.sqrt(torch.sum(torch.square(g)))
    scale = torch.clamp(clip / torch.clamp_min(norm, 1e-12), max=1.0)
    return {"ParamOut": ins["Param"] - _lr(ins) * g * scale}


_op("dpsgd", ["Param", "Grad", "LearningRate"], ["ParamOut"],
    {"clip": 10.0, "batch_size": 16.0, "sigma": 1.0, "seed": 0}, _dpsgd)


def _step_of(t):
    return t.reshape(()).to(torch.float32)


def _dgc_momentum(ins, attrs):
    """Momentum before the DGC rampup step, plain SGD after, the grad
    divided by ``nranks`` (the reference's ``dgc_momentum_op.h``). A
    negative rampup step disables the update (its early return)."""
    rampup = float(attrs.get("rampup_begin_step", 0.0))
    if rampup < 0:
        return {"ParamOut": ins["Param"], "VelocityOut": ins["Velocity"],
                "Grad_out": ins["Grad"]}
    mu = attrs.get("mu", 0.9)
    g = ins["Grad"] / ins["nranks"].reshape(()).to(torch.float32)
    before_rampup = _step_of(ins["current_step"]) < rampup
    v = mu * ins["Velocity"] + g
    if attrs.get("use_nesterov", False):
        p_momentum = ins["Param"] - (g + mu * v) * _lr(ins)
    else:
        p_momentum = ins["Param"] - _lr(ins) * v
    p_sgd = ins["Param"] - _lr(ins) * g
    return {"ParamOut": torch.where(before_rampup, p_momentum, p_sgd),
            "VelocityOut": torch.where(before_rampup, v, ins["Velocity"]),
            "Grad_out": g}


_op("dgc_momentum",
    ["Param", "Grad", "Velocity", "LearningRate", "current_step", "nranks"],
    ["ParamOut", "VelocityOut", "Grad_out"],
    {"mu": 0.9, "use_nesterov": False, "rampup_begin_step": 0.0},
    _dgc_momentum)


@register_op(
    "dgc_clip_by_norm",
    inputs=[In("X"), In("current_step", no_grad=True)],
    outputs=[Out("Out")],
    attrs={"max_norm": 1.0, "rampup_begin_step": 0.0},
    grad=None,
)
def _dgc_clip_by_norm(ins, attrs):
    """``clip_by_norm`` from the DGC rampup step on, X as it is before
    (``dgc_clip_by_norm_op.h``); a negative rampup step disables it."""
    x = ins["X"]
    rampup = float(attrs.get("rampup_begin_step", 0.0))
    if rampup < 0:
        return {"Out": x}
    max_norm = attrs.get("max_norm", 1.0)
    norm = torch.sqrt(torch.sum(torch.square(x)))
    clipped = torch.where(norm > max_norm, x * (max_norm / norm), x)
    return {"Out": torch.where(_step_of(ins["current_step"]) >= rampup,
                               clipped, x)}


def dgc_threshold(flat_abs, s_now):
    """The ``s_now`` quantile of ``flat_abs`` with linear interpolation,
    in float32 as ``jnp.quantile`` takes it: position ``s * (n - 1)``,
    the two order statistics around it from one sort, weighted by the
    fraction. ``torch.quantile`` refuses more than 2^24 elements (BERT's
    word embedding has 23.4 M) and needs ``s`` on the host; a sort and a
    gather need neither, so the op captures."""
    n = flat_abs.numel()
    srt = torch.sort(flat_abs).values
    # n - 1 in float32, as JAX takes it (n rounded first: above 2^24 the
    # position and the clamp move with it); the gather clamps its index
    last = torch.full((), float(n), dtype=torch.float32,
                      device=flat_abs.device) - 1.0
    q = s_now * last
    low, high = torch.floor(q), torch.ceil(q)
    high_w = q - low
    low_w = 1.0 - high_w

    def at(pos):
        i = torch.minimum(torch.maximum(pos, torch.zeros_like(pos)), last)
        return srt.index_select(
            0, i.to(torch.int64).clamp(0, n - 1).reshape(1))

    return (at(low) * low_w + at(high) * high_w).reshape(())


@register_op(
    "dgc",
    inputs=[In("U", no_grad=True), In("V", no_grad=True),
            In("Grad", no_grad=True), In("CurrentStep", no_grad=True)],
    outputs=[Out("UOut"), Out("VOut"), Out("EncodeGrad"),
             Out("GradOut")],
    attrs={"m": 0.9, "use_nesterov": False, "sparsity": [0.999],
           "rampup_begin_step": 0.0, "rampup_step": 1.0},
    grad=None,
)
def _dgc(ins, attrs):
    """Deep gradient compression (the reference's ``dgc_op.h``): momentum
    correction (u = m u + g), velocity accumulation (v = v + u), and the
    entries whose |v| reaches the threshold (the sparsity's quantile of
    |v|) selected: they leave as ``EncodeGrad`` (dense, zeros elsewhere)
    and are zeroed in u and v; the others wait there. Before
    ``rampup_begin_step`` every entry is selected. The sparsity walks its
    list over ``rampup_step`` steps, then holds the last. An entry tied
    with the threshold is selected (``>=``)."""
    m = attrs.get("m", 0.9)
    g = ins["Grad"]
    if attrs.get("use_nesterov", False):
        u = m * (ins["U"] + g)
        v = ins["V"] + u + g
    else:
        u = m * ins["U"] + g
        v = ins["V"] + u
    dev = v.device
    step = _step_of(ins["CurrentStep"])
    sparsity = [float(x) for x in attrs.get("sparsity", [0.999])] or \
        [0.999]
    # float32 scalars made on the device (a fill, no host copy: the op
    # runs inside a captured step)
    f32 = lambda x: torch.full((), x, dtype=torch.float32,  # noqa: E731
                               device=dev)
    begin = f32(float(attrs.get("rampup_begin_step", 0.0)))
    period = f32(max(float(attrs.get("rampup_step", 1.0)), 1.0))
    prog = torch.clamp((step - begin) / period, f32(0.0), f32(1.0 - 1e-6))
    idx = (prog * f32(float(len(sparsity)))).to(torch.int32)
    s_now = f32(sparsity[0])
    for k, s in enumerate(sparsity[1:], start=1):
        s_now = torch.where(idx == k, f32(s), s_now)
    thresh = dgc_threshold(v.abs().reshape(-1), s_now)
    mask = (v.abs() >= thresh) | (step < begin)
    zero = torch.zeros((), dtype=v.dtype, device=dev)
    encoded = torch.where(mask, v, zero)
    return {"UOut": torch.where(mask, zero, u),
            "VOut": torch.where(mask, zero, v),
            "EncodeGrad": encoded, "GradOut": encoded}


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


@register_op(
    "ema_accumulate",
    inputs=[In("Param", no_grad=True), In("Shadow", no_grad=True),
            In("Decay", dispensable=True, no_grad=True)],
    outputs=[Out("ShadowOut")],
    attrs={"decay": 0.999},
)
def _ema_accumulate(ins, attrs):
    """shadow = decay * shadow + (1 - decay) * param; a Decay input (the
    ``thres_steps`` schedule's) overrides the attr."""
    d = ins.get("Decay")
    d = attrs.get("decay", 0.999) if d is None else d.reshape(())
    return {"ShadowOut": d * ins["Shadow"] + (1.0 - d) * ins["Param"]}


@register_op(
    "ema_adaptive_decay",
    inputs=[In("ThresSteps", no_grad=True)],
    outputs=[Out("Decay")],
    attrs={"decay": 0.999},
)
def _ema_adaptive_decay(ins, attrs):
    """min(decay, (1 + t) / (10 + t)), the ``thres_steps`` warm-up."""
    t = ins["ThresSteps"].reshape(()).to(torch.float32)
    d = torch.minimum(torch.tensor(float(attrs.get("decay", 0.999)),
                                   dtype=torch.float32, device=t.device),
                      (1.0 + t) / (10.0 + t))
    return {"Decay": d.reshape(1)}


@register_op(
    "lookahead_update",
    inputs=[In("Param", no_grad=True), In("Slow", no_grad=True),
            In("Step", no_grad=True)],
    outputs=[Out("ParamOut"), Out("SlowOut")],
    attrs={"alpha": 0.5, "k": 5},
)
def _lookahead_update(ins, attrs):
    """Every k steps: slow += alpha * (fast - slow), fast = slow; a
    ``where`` on the step, so it needs no host read."""
    p, slow, step = ins["Param"], ins["Slow"], ins["Step"]
    sync = (step.reshape(()).to(torch.int32) % int(attrs.get("k", 5))) == 0
    slow_new = slow + attrs.get("alpha", 0.5) * (p - slow)
    return {"ParamOut": torch.where(sync, slow_new, p),
            "SlowOut": torch.where(sync, slow_new, slow)}


@register_op(
    "model_average_accumulate",
    inputs=[In("Param", no_grad=True), In("Sum", no_grad=True),
            In("Count", no_grad=True), In("NumUpdates", no_grad=True)],
    outputs=[Out("SumOut"), Out("CountOut")],
    attrs={"average_window": 0.15, "min_average_window": 10000,
           "max_average_window": 10000},
)
def _model_average_accumulate(ins, attrs):
    """The sliding window's parameter sum: once the count passes both
    ``min_average_window`` and min(``max_average_window``, updates *
    ``average_window``), the window restarts at the current parameter."""
    p, s, c = ins["Param"], ins["Sum"], ins["Count"]
    upd = ins["NumUpdates"].reshape(())
    window = torch.clamp(upd * attrs.get("average_window", 0.15),
                         max=float(attrs.get("max_average_window", 10000)))
    c_new = c + 1.0
    cn = c_new.reshape(())
    restart = (cn >= attrs.get("min_average_window", 10000)) & (cn >= window)
    return {"SumOut": torch.where(restart, p, s + p),
            "CountOut": torch.where(restart, torch.ones_like(c), c_new)}
