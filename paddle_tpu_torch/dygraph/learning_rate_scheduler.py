"""Dygraph learning-rate decays.

Counterpart of ``paddle_tpu/dygraph/learning_rate_scheduler.py``, formula
for formula: each is a callable that returns the step's learning rate, a
host float, and advances. The dygraph ``minimize`` calls it once a step
and hands the value to the update ops as a ``[1]`` tensor, an input of a
captured step, never a constant in it.
"""
from __future__ import annotations

import math

__all__ = ["LearningRateDecay", "PiecewiseDecay", "NaturalExpDecay",
           "ExponentialDecay", "InverseTimeDecay", "PolynomialDecay",
           "CosineDecay", "NoamDecay"]


class LearningRateDecay:
    def __init__(self, begin=0, step=1, dtype="float32"):
        self.step_num = begin
        self.step_size = step

    def __call__(self):
        lr = self.step_impl()
        self.step_num += self.step_size
        return lr

    def current(self):
        return self.step_impl()

    def step_impl(self):
        raise NotImplementedError


class PiecewiseDecay(LearningRateDecay):
    def __init__(self, boundaries, values, begin=0, step=1):
        super().__init__(begin, step)
        self.boundaries = boundaries
        self.values = values

    def step_impl(self):
        for i, b in enumerate(self.boundaries):
            if self.step_num < b:
                return self.values[i]
        return self.values[len(self.boundaries)]


class NaturalExpDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, decay_rate,
                 staircase=False, begin=0, step=1):
        super().__init__(begin, step)
        self.lr, self.decay_steps = learning_rate, decay_steps
        self.decay_rate, self.staircase = decay_rate, staircase

    def step_impl(self):
        d = self.step_num / self.decay_steps
        if self.staircase:
            d = math.floor(d)
        return self.lr * math.exp(-self.decay_rate * d)


class ExponentialDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, decay_rate,
                 staircase=False, begin=0, step=1):
        super().__init__(begin, step)
        self.lr, self.decay_steps = learning_rate, decay_steps
        self.decay_rate, self.staircase = decay_rate, staircase

    def step_impl(self):
        d = self.step_num / self.decay_steps
        if self.staircase:
            d = math.floor(d)
        return self.lr * (self.decay_rate ** d)


class InverseTimeDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, decay_rate,
                 staircase=False, begin=0, step=1):
        super().__init__(begin, step)
        self.lr, self.decay_steps = learning_rate, decay_steps
        self.decay_rate, self.staircase = decay_rate, staircase

    def step_impl(self):
        d = self.step_num / self.decay_steps
        if self.staircase:
            d = math.floor(d)
        return self.lr / (1 + self.decay_rate * d)


class PolynomialDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, end_learning_rate=0.0001,
                 power=1.0, cycle=False, begin=0, step=1):
        super().__init__(begin, step)
        self.lr, self.decay_steps = learning_rate, decay_steps
        self.end_lr, self.power, self.cycle = end_learning_rate, power, cycle

    def step_impl(self):
        step = self.step_num
        decay_steps = self.decay_steps
        if self.cycle:
            div = math.ceil(step / decay_steps) if step > 0 else 1
            decay_steps = decay_steps * div
        else:
            step = min(step, decay_steps)
        return (self.lr - self.end_lr) * \
            (1 - step / decay_steps) ** self.power + self.end_lr


class CosineDecay(LearningRateDecay):
    def __init__(self, learning_rate, step_each_epoch, epochs, begin=0,
                 step=1):
        super().__init__(begin, step)
        self.lr = learning_rate
        self.step_each_epoch = step_each_epoch
        self.epochs = epochs

    def step_impl(self):
        cur_epoch = math.floor(self.step_num / self.step_each_epoch)
        return self.lr * 0.5 * (math.cos(cur_epoch * math.pi / self.epochs) + 1)


class NoamDecay(LearningRateDecay):
    def __init__(self, d_model, warmup_steps, begin=1, step=1,
                 learning_rate=1.0):
        super().__init__(begin, step)
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        self.base_lr = learning_rate

    def step_impl(self):
        step = max(self.step_num, 1)
        a = step ** -0.5
        b = self.warmup_steps ** -1.5 * step
        return self.base_lr * (self.d_model ** -0.5) * min(a, b)
