"""The mixed-precision optimizer decorator.

Counterpart of ``paddle_tpu/contrib/mixed_precision/decorator.py``:
``decorate`` returns an ``OptimizerWithMixedPrecision`` whose ``backward``
rewrites the forward program (``fp16_utils.rewrite_program``) and
differentiates the loss, times the loss scale where one is in use, and
whose ``apply_gradients`` unscales the grads (``check_finite_and_unscale``,
which zeroes every grad of a step with an inf or nan), updates the scale
(``update_loss_scaling``) when scaling is dynamic, and appends the wrapped
optimizer's float32 master updates. bfloat16, the default, shares
float32's exponent range, so its defaults turn loss scaling off (scale
1.0, no dynamic scaling); float16 takes the reference's 2**15 and dynamic
scaling.
"""
from __future__ import annotations

from ... import framework, layers
from ...layers import tensor as layers_tensor
from .fp16_lists import AutoMixedPrecisionLists
from .fp16_utils import rewrite_program


class OptimizerWithMixedPrecision:
    """Wraps an optimizer: forward rewritten to low precision, backward
    on the (optionally scaled) loss, f32 master-weight updates."""

    def __init__(self, optimizer, amp_lists, init_loss_scaling,
                 use_dynamic_loss_scaling, incr_every_n_steps,
                 decr_every_n_nan_or_inf, incr_ratio, decr_ratio,
                 dest_dtype="bfloat16"):
        self._optimizer = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        self._dest_dtype = dest_dtype
        self._loss_scaling_value = float(init_loss_scaling)
        self._use_dynamic_loss_scaling = use_dynamic_loss_scaling
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._loss_scaling = None
        self._scaled_loss = None

    def get_loss_scaling(self):
        return self._loss_scaling

    def get_scaled_loss(self):
        return self._scaled_loss

    def _needs_scaling(self):
        return (self._use_dynamic_loss_scaling
                or self._loss_scaling_value != 1.0)

    def _ensure_loss_scaling(self):
        """Create the loss-scaling var on first use (backward() normally;
        apply_gradients() directly when the user ran their own backward)."""
        if self._loss_scaling is None:
            self._loss_scaling = layers_tensor.create_global_var(
                name=framework.unique_name.generate("loss_scaling"),
                shape=[1], value=self._loss_scaling_value, dtype="float32",
                persistable=True)
        return self._loss_scaling

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        rewrite_program(loss.block.program, self._amp_lists,
                        self._dest_dtype)
        if self._needs_scaling():
            self._scaled_loss = layers.elementwise_mul(
                loss, self._ensure_loss_scaling())
        else:
            self._scaled_loss = loss
        params_grads = self._optimizer.backward(
            self._scaled_loss, startup_program, parameter_list, no_grad_set,
            callbacks)
        return params_grads

    def apply_gradients(self, params_grads):
        main = framework.default_main_program()
        block = main.global_block()
        if self._needs_scaling():
            self._ensure_loss_scaling()
            grads = [g for _, g in params_grads if g is not None]
            found_inf = block.create_var(
                name=framework.unique_name.generate("find_infinite_scale"),
                shape=[1], dtype="bool", stop_gradient=True)
            with main._optimized_guard():
                block.append_op(
                    "check_finite_and_unscale",
                    inputs={"X": [g.name for g in grads],
                            "Scale": self._loss_scaling.name},
                    outputs={"Out": [g.name for g in grads],
                             "FoundInfinite": found_inf.name},
                    infer_shape=False)
                if self._use_dynamic_loss_scaling:
                    good = layers_tensor.create_global_var(
                        name=framework.unique_name.generate("good_steps"),
                        shape=[1], value=0, dtype="int32", persistable=True)
                    bad = layers_tensor.create_global_var(
                        name=framework.unique_name.generate("bad_steps"),
                        shape=[1], value=0, dtype="int32", persistable=True)
                    block.append_op(
                        "update_loss_scaling",
                        inputs={"FoundInfinite": found_inf.name,
                                "PrevLossScaling": self._loss_scaling.name,
                                "InGoodSteps": good.name,
                                "InBadSteps": bad.name},
                        outputs={"LossScaling": self._loss_scaling.name,
                                 "OutGoodSteps": good.name,
                                 "OutBadSteps": bad.name},
                        attrs={
                            "incr_every_n_steps": self._incr_every_n_steps,
                            "decr_every_n_nan_or_inf":
                                self._decr_every_n_nan_or_inf,
                            "incr_ratio": self._incr_ratio,
                            "decr_ratio": self._decr_ratio,
                        },
                        infer_shape=False)
        return self._optimizer.apply_gradients(params_grads)

    def apply_optimize(self, loss, startup_program, params_grads):
        return self.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads


def decorate(optimizer, amp_lists=None, init_loss_scaling=None,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.8,
             use_dynamic_loss_scaling=None, dest_dtype="bfloat16"):
    """Wrap `optimizer` for mixed-precision training.

    Scaling defaults key off the dtype: bfloat16 (the default) needs no
    loss scaling (scale 1.0, dynamic off — bf16 shares f32's exponent
    range); float16 gets the reference's defaults (2**15, dynamic on).
    Explicit arguments always win."""
    if init_loss_scaling is None:
        init_loss_scaling = 1.0 if dest_dtype == "bfloat16" else 2 ** 15
    if use_dynamic_loss_scaling is None:
        use_dynamic_loss_scaling = dest_dtype != "bfloat16"
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists, init_loss_scaling, use_dynamic_loss_scaling,
        incr_every_n_steps, decr_every_n_nan_or_inf, incr_ratio, decr_ratio,
        dest_dtype=dest_dtype)
