"""Optimizers: ``SGD``, ``Momentum``, ``Adam`` and ``AdamW``.

Counterpart of ``paddle_tpu/optimizer.py`` (``Optimizer:60-211``,
``SGDOptimizer:227``, ``MomentumOptimizer:239``, ``AdamOptimizer:313``,
``AdamW:356``): ``minimize(loss)`` runs ``append_backward`` and then, under
the program's optimize role, appends one update op per (param, grad) with
its learning-rate var and accumulators declared in both programs and
initialised in the startup program. The same ops, slots, attrs and var
names as the JAX package.

In dygraph mode ``minimize`` is ``dygraph/backward_utils.dygraph_minimize``
(one update op per parameter, state in ``_dygraph_state``), and
``state_dict`` / ``set_dict`` read and write that state. The learning rate
may be a dygraph decay (``dygraph.NoamDecay`` and the rest), called once a
step. Clip and regularizer classes and the other optimizers come with
later slices (ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict, Optional

from . import framework
from .backward import append_backward
from .clip import append_gradient_clip_ops
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops
from .utils import unique_name

__all__ = ["Optimizer", "SGD", "SGDOptimizer", "Momentum",
           "MomentumOptimizer", "Adam", "AdamOptimizer", "AdamW"]


class Optimizer:
    def __init__(self, learning_rate, parameter_list=None, regularization=None,
                 grad_clip=None, name=None):
        if grad_clip is not None:
            raise NotImplementedError(
                "grad_clip is not yet ported (ROADMAP.md, queue 1)")
        self._learning_rate = learning_rate
        self._parameter_list = parameter_list
        self.regularization = regularization
        self._name = name
        self._accumulators: Dict[str, Dict[str, framework.Variable]] = {}
        self._learning_rate_map: Dict[int, framework.Variable] = {}
        self._dygraph_state: Dict[str, object] = {}
        self.helper = None

    # -- learning rate ----------------------------------------------------
    def _create_global_learning_rate(self):
        program = framework.default_main_program()
        if id(program) in self._learning_rate_map:
            return
        if isinstance(self._learning_rate, framework.Variable):
            self._learning_rate_map[id(program)] = self._learning_rate
            return
        var = program.global_block().create_var(
            name=unique_name.generate("learning_rate"), shape=(1,),
            dtype="float32", persistable=True)
        var.stop_gradient = True
        LayerHelper("learning_rate").set_variable_initializer(
            var, ConstantInitializer(float(self._learning_rate)))
        self._learning_rate_map[id(program)] = var

    def _global_learning_rate(self, program=None):
        program = program or framework.default_main_program()
        return self._learning_rate_map.get(id(program))

    def _create_param_lr(self, param_and_grad):
        param_lr = getattr(param_and_grad[0], "optimize_attr",
                           {}).get("learning_rate", 1.0)
        if param_lr != 1.0:
            raise NotImplementedError(
                "a per-parameter learning rate needs the `scale` op, not "
                "yet ported (ROADMAP.md, queue 1)")
        return self._global_learning_rate()

    # -- accumulators -----------------------------------------------------
    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        acc = self._accumulators.setdefault(name, {})
        if param.name in acc:
            return acc[param.name]
        var = framework.default_main_program().global_block().create_var(
            name=unique_name.generate("%s_%s" % (param.name, name)),
            shape=shape if shape is not None else param.shape,
            dtype=dtype or param.dtype, persistable=True)
        var.stop_gradient = True
        LayerHelper(name).set_variable_initializer(
            var, ConstantInitializer(float(fill_value)))
        acc[param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    # -- per-optimizer hooks ----------------------------------------------
    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    # -- main entry points ------------------------------------------------
    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return append_backward(loss, parameter_list or self._parameter_list,
                               no_grad_set, callbacks)

    def apply_gradients(self, params_grads):
        # the update ops append into the default main program, so that is
        # the program whose role flips to Optimize
        with framework.default_main_program()._optimized_guard():
            params_grads = sorted(params_grads, key=lambda x: x[0].name)
            params_grads = append_gradient_clip_ops(params_grads)
            params_grads = append_regularization_ops(params_grads,
                                                     self.regularization)
            return self._create_optimization_pass(params_grads)

    def _create_optimization_pass(self, params_grads):
        block = framework.default_main_program().current_block()
        self.helper = LayerHelper(self.__class__.__name__)
        self._create_global_learning_rate()
        self._create_accumulators(
            block, [p for p, g in params_grads if g is not None])
        return [self._append_optimize_op(block, pg) for pg in params_grads
                if pg[1] is not None and getattr(pg[0], "trainable", True)]

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        if framework.in_dygraph_mode():
            from .dygraph import backward_utils

            return backward_utils.dygraph_minimize(
                self, loss, parameter_list or self._parameter_list)
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        return self.apply_gradients(params_grads), params_grads

    # -- dygraph state ----------------------------------------------------
    def state_dict(self):
        """The dygraph state: ``<param>_<slot>`` -> VarBase."""
        return dict(self._dygraph_state)

    def set_dict(self, state):
        """Take dygraph state from VarBases or numpy arrays (a
        ``load_dygraph`` result)."""
        from .dygraph.varbase import VarBase

        for k, v in state.items():
            if not isinstance(v, VarBase):
                v = VarBase(v, name=k, stop_gradient=True, persistable=True)
            self._dygraph_state[k] = v

    set_state_dict = set_dict


class SGDOptimizer(Optimizer):
    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "sgd",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p]},
            infer_shape=False)


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum, use_nesterov=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        velocity = self._get_accumulator("velocity", p)
        return block.append_op(
            "momentum",
            inputs={"Param": [p], "Grad": [g], "Velocity": [velocity],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p], "VelocityOut": [velocity]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov},
            infer_shape=False)


class AdamOptimizer(Optimizer):
    _type = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lazy_mode = lazy_mode

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=(1,))
            self._add_accumulator("beta2_pow_acc", p, fill_value=self._beta2,
                                  shape=(1,))

    def _extra_attrs(self) -> Optional[Dict]:
        return {}

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow_acc", p)
        b2p = self._get_accumulator("beta2_pow_acc", p)
        attrs = {"beta1": self._beta1, "beta2": self._beta2,
                 "epsilon": self._epsilon}
        attrs.update(self._extra_attrs())
        return block.append_op(
            self._type,
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._create_param_lr(param_and_grad)],
                    "Moment1": [m1], "Moment2": [m2],
                    "Beta1Pow": [b1p], "Beta2Pow": [b2p]},
            outputs={"ParamOut": [p], "Moment1Out": [m1], "Moment2Out": [m2],
                     "Beta1PowOut": [b1p], "Beta2PowOut": [b2p]},
            attrs=attrs,
            infer_shape=False)


class AdamW(AdamOptimizer):
    _type = "adamw"

    def __init__(self, learning_rate=0.001, weight_decay=0.01, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._weight_decay = weight_decay

    def _extra_attrs(self):
        return {"weight_decay": self._weight_decay}


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
