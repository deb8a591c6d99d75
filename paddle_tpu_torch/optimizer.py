"""Optimizers.

Counterpart of ``paddle_tpu/optimizer.py``: the ``Optimizer`` base
(``:60-224``) and ``SGD`` (:227), ``Momentum`` (:239), ``LarsMomentum``
(:262), ``Adagrad`` (:288), ``Adam`` (:313), ``AdamW`` (:356), ``Adamax``
(:367), ``Dpsgd`` (:407), ``DecayedAdagrad`` (:426), ``Adadelta`` (:448),
``RMSProp`` (:473), ``Ftrl`` (:505), ``Lamb`` (:531) and ``Recompute``
(:612), with the aliases of :1065-1072. ``minimize(loss)`` runs
``append_backward`` and then, under the program's optimize role, clips the
grads (``grad_clip=``, else the clips ``set_gradient_clip`` gave), adds
the regularizers' decay and appends one update op per (param, grad) with
its learning-rate var and accumulators declared in both programs and
initialised in the startup program. A parameter whose ``learning_rate``
attr is not 1.0 gets its own rate, a ``scale`` op of the global one. The
learning rate may be a Variable (``layers.polynomial_decay`` and the
other schedules). The same ops, slots, attrs and var names as the JAX
package.

In dygraph mode ``minimize`` is ``dygraph/backward_utils.dygraph_minimize``
(one update op per parameter, state in ``_dygraph_state``), and
``state_dict`` / ``set_dict`` read and write that state. The learning rate
may be a dygraph decay (``dygraph.NoamDecay`` and the rest), called once a
step. ``ExponentialMovingAverage`` (:864), ``ModelAverage`` (:947) and
``LookaheadOptimizer`` (:1011) append their averaging ops after the
update; the first two swap the parameters for their averages under
``apply()`` and back under ``restore()``, in place (the tensors keep their
addresses, so a captured step reads the swapped values).
``PipelineOptimizer`` (:658) accumulates the grads of ``num_microbatches``
runs and updates in a ``conditional_block`` every k-th run, and records
the stage split that ``parallel/pipeline.py`` runs over a ``pp`` axis.
``DGCMomentum`` comes with a later slice (ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict, Optional

from . import framework
from .backward import append_backward
from .clip import GradientClipByGlobalNorm, append_gradient_clip_ops
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops
from .utils import unique_name

__all__ = ["Optimizer", "SGD", "SGDOptimizer", "Momentum",
           "MomentumOptimizer", "LarsMomentumOptimizer", "Adagrad",
           "AdagradOptimizer", "Adam", "AdamOptimizer", "AdamW", "Adamax",
           "AdamaxOptimizer", "DpsgdOptimizer", "DecayedAdagradOptimizer",
           "Adadelta", "AdadeltaOptimizer", "RMSProp", "RMSPropOptimizer",
           "Ftrl", "FtrlOptimizer", "LambOptimizer", "DGCMomentumOptimizer",
           "RecomputeOptimizer",
           "ExponentialMovingAverage", "ModelAverage",
           "LookaheadOptimizer", "PipelineOptimizer"]


class Optimizer:
    def __init__(self, learning_rate, parameter_list=None, regularization=None,
                 grad_clip=None, name=None):
        self._learning_rate = learning_rate
        self._parameter_list = parameter_list
        self.regularization = regularization
        self._grad_clip = grad_clip
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
        """The rate of one parameter: the global rate, or a ``scale`` op of
        it by the parameter's ``learning_rate`` attr when that is not
        1.0 (a var of its own)."""
        base = self._global_learning_rate()
        param_lr = getattr(param_and_grad[0], "optimize_attr",
                           {}).get("learning_rate", 1.0)
        if param_lr == 1.0:
            return base
        block = framework.default_main_program().global_block()
        out = block.create_var(dtype=base.dtype, shape=base.shape)
        block.append_op("scale", inputs={"X": [base]}, outputs={"Out": [out]},
                        attrs={"scale": float(param_lr)})
        return out

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

    def _finish_update(self, block, params_grads):
        pass

    # -- main entry points ------------------------------------------------
    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return append_backward(loss, parameter_list or self._parameter_list,
                               no_grad_set, callbacks)

    def apply_gradients(self, params_grads):
        # the clip, regularization and update ops append into the default
        # main program, so that is the program whose role flips to Optimize
        with framework.default_main_program()._optimized_guard():
            return self._apply_gradients_impl(params_grads)

    def _apply_gradients_impl(self, params_grads):
        """Clip, then regularize, then update, as the JAX package does."""
        params_grads = sorted(params_grads, key=lambda x: x[0].name)
        clip = self._grad_clip
        if clip is None:
            params_grads = append_gradient_clip_ops(params_grads)
        elif isinstance(clip, GradientClipByGlobalNorm):
            ctx = {}
            for p, g in params_grads:
                clip._process_context(ctx, p, g)
            params_grads = clip._create_operators_group(ctx, params_grads)
        else:
            params_grads = [clip._create_operators(p, g)
                            for p, g in params_grads]
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        return self._create_optimization_pass(params_grads)

    def _create_optimization_pass(self, params_grads):
        block = framework.default_main_program().current_block()
        self.helper = LayerHelper(self.__class__.__name__)
        self._create_global_learning_rate()
        self._create_accumulators(
            block, [p for p, g in params_grads if g is not None])
        ops = [self._append_optimize_op(block, pg) for pg in params_grads
               if pg[1] is not None and getattr(pg[0], "trainable", True)]
        self._finish_update(block, params_grads)
        return ops

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


class LarsMomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum, lars_coeff=0.001,
                 lars_weight_decay=0.0005, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        velocity = self._get_accumulator("velocity", p)
        return block.append_op(
            "lars_momentum",
            inputs={"Param": [p], "Grad": [g], "Velocity": [velocity],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p], "VelocityOut": [velocity]},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay},
            infer_shape=False)


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6,
                 initial_accumulator_value=0.0, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._epsilon = epsilon
        self._initial_accumulator_value = initial_accumulator_value

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p,
                                  fill_value=self._initial_accumulator_value)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        moment = self._get_accumulator("moment", p)
        return block.append_op(
            "adagrad",
            inputs={"Param": [p], "Grad": [g], "Moment": [moment],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p], "MomentOut": [moment]},
            attrs={"epsilon": self._epsilon},
            infer_shape=False)


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=(1,))

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        moment = self._get_accumulator("moment", p)
        inf_norm = self._get_accumulator("inf_norm", p)
        return block.append_op(
            "adamax",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._create_param_lr(param_and_grad)],
                    "Moment": [moment], "InfNorm": [inf_norm],
                    "Beta1Pow": [self._get_accumulator("beta1_pow_acc", p)]},
            outputs={"ParamOut": [p], "MomentOut": [moment],
                     "InfNormOut": [inf_norm]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon},
            infer_shape=False)

    def _finish_update(self, block, params_grads):
        """beta1 ** t advances after the updates, one ``scale`` op a
        parameter."""
        for p, g in params_grads:
            if g is None:
                continue
            b1p = self._get_accumulator("beta1_pow_acc", p)
            block.append_op("scale", inputs={"X": [b1p]},
                            outputs={"Out": [b1p]},
                            attrs={"scale": self._beta1}, infer_shape=False)


class DpsgdOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, clip=10.0, batch_size=16.0,
                 sigma=1.0, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._clip, self._batch_size, self._sigma = clip, batch_size, sigma

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "dpsgd",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p]},
            attrs={"clip": self._clip, "batch_size": self._batch_size,
                   "sigma": self._sigma},
            infer_shape=False)


class DecayedAdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        moment = self._get_accumulator("moment", p)
        return block.append_op(
            "decayed_adagrad",
            inputs={"Param": [p], "Grad": [g], "Moment": [moment],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p], "MomentOut": [moment]},
            attrs={"decay": self._decay, "epsilon": self._epsilon},
            infer_shape=False)


class AdadeltaOptimizer(Optimizer):
    """Adadelta takes no learning rate in its update op (the JAX op's
    slots); its rate var is still declared, as in the JAX package."""

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("__avg_squared_grad", p)
            self._add_accumulator("__avg_squared_update", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        asg = self._get_accumulator("__avg_squared_grad", p)
        asu = self._get_accumulator("__avg_squared_update", p)
        return block.append_op(
            "adadelta",
            inputs={"Param": [p], "Grad": [g], "AvgSquaredGrad": [asg],
                    "AvgSquaredUpdate": [asu]},
            outputs={"ParamOut": [p], "AvgSquaredGradOut": [asg],
                     "AvgSquaredUpdateOut": [asu]},
            attrs={"epsilon": self._epsilon, "rho": self._rho},
            infer_shape=False)


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("momentum", p)
            self._add_accumulator("mean_square", p)
            self._add_accumulator("mean_grad", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        mom = self._get_accumulator("momentum", p)
        ms = self._get_accumulator("mean_square", p)
        mg = self._get_accumulator("mean_grad", p)
        return block.append_op(
            "rmsprop",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._create_param_lr(param_and_grad)],
                    "Moment": [mom], "MeanSquare": [ms], "MeanGrad": [mg]},
            outputs={"ParamOut": [p], "MomentOut": [mom],
                     "MeanSquareOut": [ms], "MeanGradOut": [mg]},
            attrs={"epsilon": self._epsilon, "decay": self._rho,
                   "momentum": self._momentum, "centered": self._centered},
            infer_shape=False)


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        sq = self._get_accumulator("squared", p)
        lin = self._get_accumulator("linear", p)
        return block.append_op(
            "ftrl",
            inputs={"Param": [p], "Grad": [g],
                    "SquaredAccumulator": [sq], "LinearAccumulator": [lin],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p], "SquaredAccumOut": [sq],
                     "LinearAccumOut": [lin]},
            attrs={"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power},
            infer_shape=False)


class LambOptimizer(AdamOptimizer):
    """LAMB: Adam's moments, the update scaled by ||param|| / ||update||.
    ``exclude_from_weight_decay_fn`` is stored and not applied, as in the
    JAX package: every parameter takes ``lamb_weight_decay``."""

    _type = "lamb"

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6,
                 exclude_from_weight_decay_fn=None, **kwargs):
        super().__init__(learning_rate, beta1=beta1, beta2=beta2,
                         epsilon=epsilon, **kwargs)
        self._weight_decay = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _extra_attrs(self):
        return {"weight_decay": self._weight_decay}


class DGCMomentumOptimizer(Optimizer):
    """Momentum with deep gradient compression (Lin et al. 2018; the
    reference's ``DGCMomentumOptimizer`` and ``dgc_op``): each parameter's
    ``dgc`` op keeps the small entries of its velocity back until they
    reach the sparsity's threshold, and a plain ``sgd`` applies the
    selected ones (the momentum lives in the ``dgc_u`` accumulator). A
    persistable ``dgc_step`` counts the steps. ``GradOut`` is bound to the
    grad var (the reference's in-place ``Grad_out``): the JAX package binds
    it to the encoded var beside ``EncodeGrad``, an op writing one var
    through two outputs, which its own IR verifier refuses under data
    parallelism. Under data parallelism the
    engine's allreduce lands on the encoded grad, before the ``sgd``, as
    in the JAX package and the reference: each replica keeps its own u and
    v. The card's collectives are dense, so this keeps the algorithm, not
    the sparse wire format."""

    _type = "momentum"

    def __init__(self, learning_rate, momentum, rampup_begin_step,
                 rampup_step=1, sparsity=(0.999,), use_nesterov=False,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._use_nesterov = use_nesterov
        self._rampup_begin_step = rampup_begin_step
        self._rampup_step = rampup_step
        self._sparsity = list(sparsity)
        self._global_step_var = None

    def _create_accumulators(self, block, parameters):
        from .layers import tensor as layers_tensor

        for p in parameters:
            self._add_accumulator("dgc_u", p)
            self._add_accumulator("dgc_v", p)
        if self._global_step_var is None:
            self._global_step_var = layers_tensor.create_global_var(
                name=unique_name.generate("dgc_step"),
                shape=[1], value=0, dtype="float32", persistable=True)
            block.append_op("increment",
                            inputs={"X": [self._global_step_var]},
                            outputs={"Out": [self._global_step_var]},
                            attrs={"step": 1.0}, infer_shape=False)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        u = self._get_accumulator("dgc_u", p)
        v = self._get_accumulator("dgc_v", p)
        encoded = block.create_var(
            name=unique_name.generate(p.name + "_dgc_enc"),
            shape=p.shape, dtype=p.dtype)
        block.append_op(
            "dgc",
            inputs={"U": [u], "V": [v], "Grad": [g],
                    "CurrentStep": [self._global_step_var]},
            outputs={"UOut": [u], "VOut": [v], "EncodeGrad": [encoded],
                     "GradOut": [g]},
            attrs={"m": self._momentum,
                   "use_nesterov": self._use_nesterov,
                   "sparsity": self._sparsity,
                   "rampup_begin_step": float(self._rampup_begin_step),
                   "rampup_step": float(self._rampup_step)},
            infer_shape=False)
        self._pending_sgd.append(
            (p, encoded, self._create_param_lr(param_and_grad)))
        return block.ops[-1]

    def _create_optimization_pass(self, params_grads):
        self._pending_sgd = []
        return super()._create_optimization_pass(params_grads)

    def _finish_update(self, block, params_grads):
        # every dgc op first, then the sgd ops in a row, so that the fused
        # optimizer pass can fold them into one group (K4's sgd form); the
        # JAX package interleaves them, and its pass spares the group
        for p, encoded, lr in self._pending_sgd:
            block.append_op("sgd",
                            inputs={"Param": [p], "Grad": [encoded],
                                    "LearningRate": [lr]},
                            outputs={"ParamOut": [p]}, infer_shape=False)


class RecomputeOptimizer(Optimizer):
    """Activation recomputation around another optimizer: only the
    checkpoint activations (``_set_checkpoints``) are kept for the
    backward; ``append_backward(checkpoints=...)`` re-emits each forward
    op between them at the start of the backward, and the grad ops read
    the recomputed values. The update is the wrapped optimizer's."""

    def __init__(self, optimizer):
        self._optimizer = optimizer
        self._checkpoints = None
        # the shared-state surface the base class reads
        self._parameter_list = getattr(optimizer, "_parameter_list", None)
        self._grad_clip = getattr(optimizer, "_grad_clip", None)
        self.regularization = getattr(optimizer, "regularization", None)

    def _set_checkpoints(self, checkpoints):
        if not isinstance(checkpoints, (list, tuple)):
            raise ValueError("checkpoints must be a list of Variables")
        self._checkpoints = list(checkpoints)

    def load(self, state):
        raise NotImplementedError(
            "load function is not supported by Recompute Optimizer")

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        if self._checkpoints is None:
            raise ValueError("_set_checkpoints must be called first")
        return append_backward(
            loss, parameter_list or self._parameter_list, no_grad_set,
            callbacks, checkpoints=self._checkpoints)

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def apply_optimize(self, loss, startup_program, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        return self.apply_gradients(params_grads), params_grads


class PipelineOptimizer:
    """Synchronous (GPipe) pipeline training around another optimizer.

    On one device it is gradient accumulation over ``num_microbatches``:
    each run feeds one microbatch, the grads of the loss scaled by 1/k add
    into ``<param>.pipe_acc`` and the wrapped optimizer's update (with the
    accumulators zeroed after it) runs in a ``conditional_block`` every
    k-th run. ``minimize`` records ``program._pipeline_meta`` (the cut
    list, the forward op count, k, the loss, the params, their
    accumulators and the update ops), which
    ``parallel.pipeline.run_pipeline_parallel`` runs as stages over a
    ``pp`` mesh axis. ``place_list`` and ``concurrency_list`` are taken
    for the API: the mesh places the stages."""

    def __init__(self, optimizer, cut_list=None, place_list=None,
                 concurrency_list=None, queue_size=30, sync_steps=1,
                 start_cpu_core_id=0, num_microbatches=None):
        self._optimizer = optimizer
        self._cut_list = cut_list
        self._place_list = place_list
        self._num_microbatches = num_microbatches or max(
            len(cut_list) + 1 if cut_list else 1, 1)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        program = loss.block.program
        # the update ops go to the current block of the default program:
        # make it this one
        with framework.program_guard(program):
            return self._minimize(loss, startup_program, parameter_list,
                                  no_grad_set, int(self._num_microbatches),
                                  program, program.global_block())

    def _minimize(self, loss, startup_program, parameter_list, no_grad_set,
                  k, program, block):
        from .core.dtypes import dtype_to_enum
        from .layers import tensor as layers_tensor

        n_fwd_ops = len(block.ops)
        scaled = loss
        if k > 1:
            scaled = block.create_var(
                name=unique_name.generate(loss.name + ".pipe"),
                shape=loss.shape, dtype=loss.dtype)
            block.append_op("scale", inputs={"X": [loss]},
                            outputs={"Out": [scaled]},
                            attrs={"scale": 1.0 / k}, infer_shape=False)
        params_grads = self._optimizer.backward(
            scaled, startup_program, parameter_list, no_grad_set)
        if k <= 1:
            n_before = len(block.ops)
            optimize_ops = self._optimizer.apply_gradients(params_grads)
            self._record_pipeline_meta(
                program, loss, n_fwd_ops, k,
                {p.name: g.name for p, g in params_grads if g is not None},
                list(block.ops[n_before:]))
            return optimize_ops, params_grads

        with program._optimized_guard():
            step = layers_tensor.create_global_var(
                name=unique_name.generate("pipe_step"), shape=[1],
                dtype="int32", value=0, persistable=True)
            block.append_op("increment", inputs={"X": [step]},
                            outputs={"Out": [step]}, attrs={"step": 1.0},
                            infer_shape=False)
            accum_pg = []
            for p, g in params_grads:
                if g is None:
                    accum_pg.append((p, g))
                    continue
                acc = layers_tensor.create_global_var(
                    name=p.name + ".pipe_acc", shape=p.shape, dtype=p.dtype,
                    value=0.0, persistable=True)
                block.append_op("elementwise_add",
                                inputs={"X": [acc], "Y": [g]},
                                outputs={"Out": [acc]}, attrs={"axis": -1},
                                infer_shape=False)
                accum_pg.append((p, acc))
            kconst = layers_tensor.fill_constant([1], "int32", k)
            zero = layers_tensor.fill_constant([1], "int32", 0)
            mod = block.create_var(name=unique_name.generate("pipe_mod"),
                                   shape=(1,), dtype="int32")
            block.append_op("elementwise_mod",
                            inputs={"X": [step], "Y": [kconst]},
                            outputs={"Out": [mod]}, attrs={"axis": -1},
                            infer_shape=False)
            cond = block.create_var(name=unique_name.generate("pipe_cond"),
                                    shape=(1,), dtype="bool")
            block.append_op("equal", inputs={"X": [mod], "Y": [zero]},
                            outputs={"Out": [cond]}, infer_shape=False)
            sub = program._create_block()
            try:
                optimize_ops = self._optimizer.apply_gradients(accum_pg)
                for p, acc in accum_pg:
                    if acc is None:
                        continue
                    sub.append_op(
                        "fill_constant", inputs={},
                        outputs={"Out": [acc.name]},
                        attrs={"shape": list(acc.shape), "value": 0.0,
                               "dtype": dtype_to_enum(acc.dtype)},
                        infer_shape=False)
            finally:
                program._rollback()
            block.append_op(
                "conditional_block", inputs={"Cond": [cond]}, outputs={},
                attrs={"sub_block": sub, "is_scalar_condition": True},
                infer_shape=False)
        self._record_pipeline_meta(
            program, loss, n_fwd_ops, k,
            {p.name: acc.name for p, acc in accum_pg if acc is not None},
            list(sub.ops))
        return optimize_ops, params_grads

    def _record_pipeline_meta(self, program, loss, n_fwd_ops, k, acc_map,
                              update_ops):
        program._pipeline_meta = {
            "cut_list": self._cut_list or [],
            "num_microbatches": k,
            "n_fwd_ops": n_fwd_ops,
            "loss": loss.name,
            "params": list(acc_map),
            "acc_map": dict(acc_map),
            "update_ops": update_ops,
        }


class _ParamSwapper:
    """``apply()`` / ``restore()``: each parameter's tensor in the global
    scope overwritten with its replacement, in place, and back."""

    def __init__(self):
        self._backups = {}

    def _param_names(self):
        raise NotImplementedError

    def _replacement(self, scope, pname):
        """The replacement tensor for ``pname``, or None to skip it."""
        raise NotImplementedError

    def apply(self, executor=None, need_restore=True):
        import contextlib

        @contextlib.contextmanager
        def _ctx():
            from .core.scope import global_scope

            scope = global_scope()
            for pname in self._param_names():
                pv = scope.find_var(pname)
                if pv is None:
                    continue
                repl = self._replacement(scope, pname)
                if repl is None:
                    continue
                arr = pv.get_tensor().array
                self._backups[pname] = arr.clone()
                arr.copy_(repl)
            try:
                yield
            finally:
                if need_restore:
                    self.restore(executor)

        return _ctx()

    def restore(self, executor=None):
        from .core.scope import global_scope

        scope = global_scope()
        for pname, saved in self._backups.items():
            pv = scope.find_var(pname)
            if pv is not None:
                pv.get_tensor().array.copy_(saved)
        self._backups = {}


def _trainable(params):
    return [p for p in params if getattr(p, "trainable", True)]


def _host_scalar(scope, var):
    v = scope.find_var(var.name)
    if v is None or not v.is_initialized():
        return None
    return float(v.get_tensor().array.reshape(-1)[0].item())


class ExponentialMovingAverage(_ParamSwapper):
    """Shadows updated each step by ``update()``'s ``ema_accumulate`` ops;
    ``apply()`` swaps in the bias-corrected shadows, ema / (1 -
    decay^t)."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        super().__init__()
        self._decay = decay
        self._thres_steps = thres_steps
        self._name = name or ""
        self._shadows = {}  # param name -> shadow var
        self._decay_pow = None

    def _param_names(self):
        return list(self._shadows)

    def update(self):
        from .layers.tensor import create_global_var

        program = framework.default_main_program()
        block = program.global_block()
        params = _trainable(block.all_parameters)
        # the optimize role: clone(for_test=True) prunes these
        with program._optimized_guard():
            self._decay_pow = create_global_var(
                name=unique_name.generate(self._name + "ema_decay_pow"),
                shape=[1], value=1.0, dtype="float32", persistable=True)
            decay_inputs = {}
            if self._thres_steps is not None:
                decay_var = block.create_var(
                    name=unique_name.generate("ema_decay"), shape=(1,),
                    dtype="float32")
                block.append_op(
                    "ema_adaptive_decay",
                    inputs={"ThresSteps": [self._thres_steps]},
                    outputs={"Decay": [decay_var]},
                    attrs={"decay": float(self._decay)}, infer_shape=False)
                decay_inputs = {"Decay": [decay_var]}
                block.append_op(
                    "elementwise_mul",
                    inputs={"X": [self._decay_pow], "Y": [decay_var]},
                    outputs={"Out": [self._decay_pow]},
                    attrs={"axis": -1}, infer_shape=False)
            else:
                block.append_op(
                    "scale", inputs={"X": [self._decay_pow]},
                    outputs={"Out": [self._decay_pow]},
                    attrs={"scale": float(self._decay)}, infer_shape=False)
            for p in params:
                shadow = create_global_var(
                    name=self._name + p.name + ".ema", shape=p.shape,
                    dtype=p.dtype, value=0.0, persistable=True)
                self._shadows[p.name] = shadow
                block.append_op(
                    "ema_accumulate",
                    inputs=dict({"Param": [p], "Shadow": [shadow]},
                                **decay_inputs),
                    outputs={"ShadowOut": [shadow]},
                    attrs={"decay": self._decay}, infer_shape=False)

    def _replacement(self, scope, pname):
        sv = scope.find_var(self._shadows[pname].name)
        if sv is None or not sv.is_initialized():
            return None
        correction = 1.0
        if self._decay_pow is not None:
            dp = _host_scalar(scope, self._decay_pow)
            if dp is not None and 1.0 - dp > 1e-12:
                correction = 1.0 - dp
        return sv.get_tensor().array / correction


class ModelAverage(Optimizer, _ParamSwapper):
    """The average of each parameter over a sliding window of steps: the
    sum restarts once its count passes min(``max_average_window``,
    updates * ``average_window_rate``) and ``min_average_window``;
    ``apply()`` swaps in sum / count."""

    def __init__(self, average_window_rate=0.15, min_average_window=10000,
                 max_average_window=10000, regularization=None, name=None):
        from .layers.tensor import create_global_var

        Optimizer.__init__(self, learning_rate=0.0,
                           regularization=regularization, name=name)
        _ParamSwapper.__init__(self)
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        self._sums = {}
        self._counts = {}
        program = framework.default_main_program()
        block = program.global_block()
        with program._optimized_guard():
            upd = create_global_var(
                name=unique_name.generate("avg_num_updates"), shape=[1],
                dtype="float32", value=0.0, persistable=True)
            block.append_op("increment", inputs={"X": [upd]},
                            outputs={"Out": [upd]}, attrs={"step": 1.0},
                            infer_shape=False)
            for p in _trainable(block.all_parameters):
                s = create_global_var(
                    name=p.name + ".avg_sum", shape=p.shape, dtype=p.dtype,
                    value=0.0, persistable=True)
                c = create_global_var(
                    name=p.name + ".avg_cnt", shape=[1], dtype="float32",
                    value=0.0, persistable=True)
                self._sums[p.name] = s
                self._counts[p.name] = c
                block.append_op(
                    "model_average_accumulate",
                    inputs={"Param": [p], "Sum": [s], "Count": [c],
                            "NumUpdates": [upd]},
                    outputs={"SumOut": [s], "CountOut": [c]},
                    attrs={"average_window": self.average_window,
                           "min_average_window": self.min_average_window,
                           "max_average_window": self.max_average_window},
                    infer_shape=False)

    def _param_names(self):
        return list(self._sums)

    def _replacement(self, scope, pname):
        sv = scope.find_var(self._sums[pname].name)
        if sv is None or not sv.is_initialized():
            return None
        cnt = _host_scalar(scope, self._counts[pname])
        if not cnt or cnt <= 0:
            return None
        return sv.get_tensor().array / cnt


class LookaheadOptimizer:
    """The inner optimizer steps the fast weights every step; every k
    steps the slow weights move ``alpha`` of the way to the fast ones and
    the fast weights take their value (one ``lookahead_update`` op a
    parameter, after the update)."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        if inner_optimizer is None:
            raise ValueError("inner optimizer can not be None")
        if not 0.0 <= alpha <= 1.0:
            raise ValueError("alpha should be in [0, 1]")
        if not (isinstance(k, int) and k > 0):
            raise ValueError("k should be a positive integer")
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = k

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from .layers.tensor import create_global_var

        result = self.inner_optimizer.minimize(
            loss, startup_program=startup_program,
            parameter_list=parameter_list, no_grad_set=no_grad_set)
        block = loss.block
        params = _trainable(block.program.global_block().all_parameters)
        startup = framework.default_startup_program().global_block()
        with block.program._optimized_guard():
            step = create_global_var(
                name=unique_name.generate("lookahead_step"), shape=[1],
                dtype="int32", value=0, persistable=True)
            block.append_op("increment", inputs={"X": [step]},
                            outputs={"Out": [step]}, attrs={"step": 1.0},
                            infer_shape=False)
            for p in params:
                slow = create_global_var(
                    name=p.name + ".slow", shape=p.shape, dtype=p.dtype,
                    value=0.0, persistable=True)
                # the slow weights start at the parameters
                startup.append_op("assign", inputs={"X": [p.name]},
                                  outputs={"Out": [slow.name]},
                                  infer_shape=False)
                block.append_op(
                    "lookahead_update",
                    inputs={"Param": [p], "Slow": [slow], "Step": [step]},
                    outputs={"ParamOut": [p], "SlowOut": [slow]},
                    attrs={"alpha": self.alpha, "k": self.k},
                    infer_shape=False)
        return result


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
