"""In-graph learning-rate schedules.

Counterpart of ``paddle_tpu/layers/learning_rate_scheduler.py``, whole:
``autoincreased_step_counter`` (:31), ``noam_decay`` (:51),
``exponential_decay`` (:68), ``natural_exp_decay`` (:86),
``inverse_time_decay`` (:99), ``polynomial_decay`` (:114),
``piecewise_decay`` (:145), ``cosine_decay`` (:178) and
``linear_lr_warmup`` (:187). Each builds the same small op subgraph over a
persistable step counter that an ``increment`` op advances once a run, so
the rate is computed inside the step: under a captured step the counter is
a state buffer at a fixed address that every replay advances, and the
optimizer (the K4 kernel too) reads the rate from device memory. Each
schedule makes its own counter (``linear_lr_warmup(polynomial_decay(...))``
makes two, both advanced once a step). ``piecewise_decay`` is a chain of
``where`` selects, as in the JAX package. The counter is int64 here; the
JAX package (x64 off) keeps it int32: the values agree.
"""
from __future__ import annotations

import math

from .. import framework
from ..layer_helper import LayerHelper
from . import tensor as layers_tensor
from .control_flow import less_than
from .nn import elementwise_div, elementwise_min
from .ops import ceil, cos, exp, floor
from .ops import pow as pow_layer
from .ops import scale

__all__ = ["autoincreased_step_counter", "noam_decay", "exponential_decay",
           "natural_exp_decay", "inverse_time_decay", "polynomial_decay",
           "piecewise_decay", "cosine_decay", "linear_lr_warmup"]


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """Persistable int64 counter incremented once per executed step."""
    helper = LayerHelper("global_step_counter")
    counter = layers_tensor.create_global_var(
        name=counter_name or framework.unique_name.generate(
            "@LR_DECAY_COUNTER@"),
        shape=[1], value=float(begin - step), dtype="int64",
        persistable=True)
    helper.append_op("increment", inputs={"X": [counter]},
                     outputs={"Out": [counter]},
                     attrs={"step": float(step)}, infer_shape=False)
    counter.stop_gradient = True
    return counter


def _step_f32():
    return layers_tensor.cast(autoincreased_step_counter(), "float32")


def _scale(x, s, bias=0.0):
    return scale(x, scale=float(s), bias=float(bias))


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    step = _step_f32()
    a = pow_layer(step, factor=-0.5)
    b = _scale(step, float(warmup_steps) ** -1.5)
    return _scale(elementwise_min(a, b),
                  float(learning_rate) * float(d_model) ** -0.5)


def _pow_const(base, exponent):
    """base ** exponent with a scalar Python base."""
    return exp(scale(exponent, scale=math.log(base)))


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    exponent = _scale(_step_f32(), 1.0 / decay_steps)
    if staircase:
        exponent = floor(exponent)
    return _scale(_pow_const(decay_rate, exponent), learning_rate)


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    exponent = _scale(_step_f32(), 1.0 / decay_steps)
    if staircase:
        exponent = floor(exponent)
    return _scale(exp(_scale(exponent, -decay_rate)), learning_rate)


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    ratio = _scale(_step_f32(), 1.0 / decay_steps)
    if staircase:
        ratio = floor(ratio)
    denom = _scale(ratio, decay_rate, bias=1.0)
    one = layers_tensor.fill_constant([1], "float32", float(learning_rate))
    return elementwise_div(one, denom)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    step = _step_f32()
    if cycle:
        div = ceil(_scale(step, 1.0 / decay_steps))
        decay_steps_var = _scale(div, float(decay_steps))
        capped = step
    else:
        decay_steps_var = layers_tensor.fill_constant(
            [1], "float32", float(decay_steps))
        capped = elementwise_min(
            step, layers_tensor.fill_constant([1], "float32",
                                              float(decay_steps)))
    frac = elementwise_div(capped, decay_steps_var)
    one_minus = _scale(frac, -1.0, bias=1.0)
    poly = pow_layer(one_minus, factor=float(power))
    return _scale(poly, learning_rate - end_learning_rate,
                  bias=end_learning_rate)


def piecewise_decay(boundaries, values):
    """Stepwise rate by nested ``where`` selects, built from the last
    boundary backwards: ``step < b`` takes ``values[i]``."""
    if len(values) - len(boundaries) != 1:
        raise ValueError("len(values) must be len(boundaries)+1")
    step = _step_f32()
    lr = layers_tensor.fill_constant([1], "float32", float(values[-1]))
    for b, v in zip(reversed(boundaries), reversed(values[:-1])):
        cond = _less_than_scalar(step, float(b))
        vconst = layers_tensor.fill_constant([1], "float32", float(v))
        lr = _select(cond, vconst, lr)
    return lr


def _less_than_scalar(x, v):
    return less_than(x, layers_tensor.fill_constant([1], x.dtype, float(v)))


def _select(cond, a, b):
    helper = LayerHelper("where", input=a)
    out = helper.create_variable_for_type_inference(a.dtype)
    helper.append_op("where", inputs={"Condition": [cond], "X": [a],
                                      "Y": [b]},
                     outputs={"Out": [out]}, infer_shape=False)
    return out


def cosine_decay(learning_rate, step_each_epoch, epochs):
    epoch = floor(_scale(_step_f32(), 1.0 / step_each_epoch))
    cosv = cos(_scale(epoch, math.pi / epochs))
    return _scale(_scale(cosv, 0.5, bias=0.5), learning_rate)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    step = _step_f32()
    warm = _scale(step, (end_lr - start_lr) / float(warmup_steps),
                  bias=start_lr)
    cond = _less_than_scalar(step, float(warmup_steps))
    if isinstance(learning_rate, (float, int)):
        learning_rate = layers_tensor.fill_constant([1], "float32",
                                                    float(learning_rate))
    return _select(cond, warm, learning_rate)
