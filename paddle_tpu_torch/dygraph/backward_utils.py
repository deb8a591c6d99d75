"""The dygraph optimizer step: one registered update op per parameter.

Counterpart of ``paddle_tpu/dygraph/backward_utils.py``: ``minimize``
runs ``sgd``, ``momentum``, ``adam``, ``adamw``, ``lamb`` or ``adagrad``
per parameter on its grad (eagerly, or queued under lazy dygraph), as the
JAX package does (:67-86), and raises for any other optimizer, as it
does:
the flat fused update (K4) is a static-program rewrite and takes no part
here. The learning rate is a ``[1]`` float32 tensor made each step from
the optimizer's rate (a decay object is called once a step), so under a
captured step it is an input, never a constant. Optimizer state lives on
the optimizer (``_dygraph_state``, keys ``<param>_<slot>``) as VarBases.
The step ends with a flush: the step boundary of lazy dygraph.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.registry import BOUND_OUTPUTS_ATTR, DEVICE_ATTR, OpInfoMap
from .lazy import aval_of
from .varbase import VarBase, to_tensor


def _get_state(opt, pname, key, like, fill=0.0, shape=None):
    store: Dict = opt._dygraph_state
    k = "%s_%s" % (pname, key)
    v = store.get(k)
    if v is None:
        shape = tuple(shape) if shape is not None else like.shape
        from .tracer import current_tracer

        arr = torch.full(shape, fill, dtype=like._array.dtype,
                         device=current_tracer().device)
        v = VarBase(arr, name=k, stop_gradient=True, persistable=True)
        store[k] = v
    return v


def _update_spec(opt, p):
    """(op type, attrs, {slot: state key}) of ``opt``'s update of ``p``,
    creating its state on first use."""
    from .. import optimizer as O

    if isinstance(opt, O.SGDOptimizer):
        return "sgd", {}, {}
    if isinstance(opt, O.MomentumOptimizer):
        _get_state(opt, p.name, "velocity", p)
        return "momentum", {"mu": opt._momentum,
                            "use_nesterov": opt._use_nesterov}, \
            {"Velocity": "velocity"}
    if isinstance(opt, O.AdagradOptimizer):
        _get_state(opt, p.name, "moment", p,
                   fill=opt._initial_accumulator_value)
        return "adagrad", {"epsilon": opt._epsilon}, {"Moment": "moment"}
    if isinstance(opt, O.AdamOptimizer):
        _get_state(opt, p.name, "moment1", p)
        _get_state(opt, p.name, "moment2", p)
        _get_state(opt, p.name, "beta1pow", p, fill=opt._beta1, shape=(1,))
        _get_state(opt, p.name, "beta2pow", p, fill=opt._beta2, shape=(1,))
        attrs = {"beta1": opt._beta1, "beta2": opt._beta2,
                 "epsilon": opt._epsilon}
        op_type = "adam"
        if isinstance(opt, (O.AdamW, O.LambOptimizer)):
            op_type = "adamw" if isinstance(opt, O.AdamW) else "lamb"
            attrs["weight_decay"] = opt._weight_decay
        return op_type, attrs, {"Moment1": "moment1", "Moment2": "moment2",
                                "Beta1Pow": "beta1pow",
                                "Beta2Pow": "beta2pow"}
    raise NotImplementedError(
        "dygraph path for %s arrives with a later wave (ROADMAP.md, "
        "queue 1 item 5)" % type(opt).__name__)


def dygraph_minimize(opt, loss, parameter_list=None):
    from .tracer import current_tracer

    tracer = current_tracer()
    if loss is not None and not tracer.tape:
        loss.backward()
    params = parameter_list or tracer.all_parameters()
    lr = opt._learning_rate
    if not isinstance(lr, float):
        lr = float(np.asarray(lr() if callable(lr) else lr).reshape(()))
    lr_arr = to_tensor(np.array([lr], dtype=np.float32), device=tracer.device)
    infos = OpInfoMap.instance()
    for p in params:
        if p._grad is None or not getattr(p, "trainable", True):
            continue
        op_type, attrs, state_slots = _update_spec(opt, p)
        info = infos.get(op_type)
        ins = {"Param": p._array, "Grad": p._grad, "LearningRate": lr_arr}
        for slot, key in state_slots.items():
            ins[slot] = opt._dygraph_state["%s_%s" % (p.name, key)]._array
        full = dict(info.attrs)
        full.update(attrs)
        full[BOUND_OUTPUTS_ATTR] = tuple(s.name for s in info.outputs)
        full[DEVICE_ATTR] = tracer.device
        if tracer.lazy_engine is not None:
            outs = _lazy_opt_op(tracer.lazy_engine, info, op_type, ins,
                                full, attrs)
        else:
            with torch.no_grad():
                outs = info.fn(ins, full)
        p._array = outs["ParamOut"]
        for slot, key in state_slots.items():
            opt._dygraph_state["%s_%s" % (p.name, key)]._array = \
                outs[slot + "Out"]
    # the optimizer step is the step boundary: steady-state training is
    # one flush (one replay on the card) a step
    tracer.flush()
    return None, [(p, p._grad) for p in params]


def _lazy_opt_op(eng, info, op_type, ins, attrs, given):
    """Queue an update op (its inputs may be pending); {slot: handle}.
    The node function and output avals are cached per signature (the
    caller's ``given`` attrs, the slots, the input avals)."""
    from .tracer import attrs_signature

    names = tuple(k for k in ins if ins[k] is not None)
    handles = [ins[k] for k in names]
    slots = [s.name for s in info.outputs]
    sig = ("opt", op_type, attrs_signature(given), names)
    ck = sig + (tuple(aval_of(h) for h in handles),)
    hit = eng._opt_aval_cache.get(ck)
    if hit is None:
        def op_fn(vals, gen):
            outs = info.fn(dict(zip(names, vals)), attrs)
            return tuple(outs[n] for n in slots)

        meta = dict(attrs)
        meta[DEVICE_ATTR] = torch.device("meta")
        outs = info.fn({n: torch.empty(s, dtype=d, device="meta")
                        for n, (s, d) in zip(names, ck[-1])}, meta)
        hit = (op_fn, [aval_of(outs[n]) for n in slots])
        eng._opt_aval_cache[ck] = hit
    node = eng.add_node(hit[0], handles, hit[1], sig)
    return dict(zip(slots, node.outs))
