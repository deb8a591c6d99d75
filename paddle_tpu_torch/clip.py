"""Gradient clipping.

Counterpart of ``paddle_tpu/clip.py`` (:13-139): ``GradientClipByValue``
(a ``clip`` op a grad), ``GradientClipByNorm`` (``clip_by_norm``),
``GradientClipByGlobalNorm`` (one ``squared_l2_norm`` a grad, their
``sum``, ``sqrt``, and every grad times ``clip / max(norm, clip)``),
``set_gradient_clip`` and ``append_gradient_clip_ops``, which
``Optimizer.apply_gradients`` runs before the regularizers and the update
when no ``grad_clip=`` is given. As in the JAX package, a
``ParamAttr(gradient_clip=...)`` is stored and never applied (nothing sets
a parameter's ``gradient_clip_attr``), and ``ErrorClipByValue`` holds its
bounds and appends nothing. The same ops and names as the JAX package.
"""
from __future__ import annotations

from . import framework


class BaseGradientClipAttr:
    def _append_clip_op(self, block, param, grad):
        raise NotImplementedError

    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        return param, grad


class NullGradientClipAttr(BaseGradientClipAttr):
    def _append_clip_op(self, block, param, grad):
        return grad


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _create_operators(self, param, grad):
        block = grad.block
        out = block.create_var(dtype=grad.dtype, shape=grad.shape)
        block.append_op("clip", inputs={"X": [grad]}, outputs={"Out": [out]},
                        attrs={"min": self.min, "max": self.max})
        return param, out


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _create_operators(self, param, grad):
        block = grad.block
        out = block.create_var(dtype=grad.dtype, shape=grad.shape)
        block.append_op("clip_by_norm", inputs={"X": [grad]},
                        outputs={"Out": [out]},
                        attrs={"max_norm": self.clip_norm})
        return param, out


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _process_context(self, context, param, grad):
        ctx = context.setdefault(self.group_name,
                                 {"clip": self.clip_norm, "sq": []})
        block = grad.block
        sq = block.create_var(dtype=grad.dtype, shape=(1,))
        block.append_op("squared_l2_norm", inputs={"X": [grad]},
                        outputs={"Out": [sq]})
        ctx["sq"].append(sq)

    def _create_operators_group(self, context, params_grads):
        ctx = context[self.group_name]
        block = params_grads[0][1].block

        def scalar():
            return block.create_var(dtype="float32", shape=(1,))

        total = scalar()
        block.append_op("sum", inputs={"X": ctx["sq"]},
                        outputs={"Out": [total]})
        gnorm = scalar()
        block.append_op("sqrt", inputs={"X": [total]},
                        outputs={"Out": [gnorm]})
        clip_v = scalar()
        block.append_op("fill_constant", outputs={"Out": [clip_v]},
                        attrs={"shape": [1], "value": self.clip_norm,
                               "dtype": 5}, infer_shape=False)
        denom = scalar()
        block.append_op("elementwise_max",
                        inputs={"X": [gnorm], "Y": [clip_v]},
                        outputs={"Out": [denom]})
        scale = scalar()
        block.append_op("elementwise_div",
                        inputs={"X": [clip_v], "Y": [denom]},
                        outputs={"Out": [scale]})
        outs = []
        for p, g in params_grads:
            ng = g.block.create_var(dtype=g.dtype, shape=g.shape)
            g.block.append_op("elementwise_mul",
                              inputs={"X": [g], "Y": [scale]},
                              outputs={"Out": [ng]}, attrs={"axis": -1})
            outs.append((p, ng))
        return outs


# (program uid, parameter name) -> the clip set_gradient_clip gave it; the
# JAX package keys by id(program), which a later program may reuse
_clip_attr_holder = {}


def set_gradient_clip(clip, param_list=None, program=None):
    program = program or framework.default_main_program()
    if param_list is None:
        param_list = program.all_parameters()
    for p in param_list:
        name = p if isinstance(p, str) else p.name
        _clip_attr_holder[(program._uid, name)] = clip


def append_gradient_clip_ops(params_grads):
    if not params_grads:
        return params_grads
    program = params_grads[0][0].block.program
    context = {}
    global_clips = []
    res = []
    for p, g in params_grads:
        clip = _clip_attr_holder.get((program._uid, p.name)) or \
            getattr(p, "gradient_clip_attr", None)
        if clip is None:
            res.append((p, g))
        elif isinstance(clip, GradientClipByGlobalNorm):
            clip._process_context(context, p, g)
            global_clips.append((clip, p, g))
        else:
            res.append(clip._create_operators(p, g))
    if global_clips:
        clip = global_clips[0][0]
        res.extend(clip._create_operators_group(
            context, [(p, g) for _, p, g in global_clips]))
    return res


class ErrorClipByValue:
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max
