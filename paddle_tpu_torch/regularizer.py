"""Weight-decay regularizers.

Counterpart of ``paddle_tpu/regularizer.py`` (:9-66):
``append_regularization_ops`` adds each parameter's decay term to its grad
inside ``apply_gradients``, after the clip and before the update. A
parameter's own ``regularizer`` wins over the optimizer's. L2 adds
``coeff * param`` (a ``scale`` op), L1 ``coeff * sign(param)``; the grad
becomes a ``sum`` op's output. The same ops and names as the JAX package.
"""
from __future__ import annotations


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        decay = block.create_var(dtype=param.dtype, shape=param.shape)
        block.append_op("scale", inputs={"X": [param]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self._coeff})
        return decay


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        sign = block.create_var(dtype=param.dtype, shape=param.shape)
        block.append_op("sign", inputs={"X": [param]}, outputs={"Out": [sign]})
        decay = block.create_var(dtype=param.dtype, shape=param.shape)
        block.append_op("scale", inputs={"X": [sign]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self._coeff})
        return decay


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer


def append_regularization_ops(parameters_and_grads, regularization=None):
    params_and_grads = []
    for param, grad in parameters_and_grads:
        regularizer = getattr(param, "regularizer", None) or regularization
        if grad is None or regularizer is None:
            params_and_grads.append((param, grad))
            continue
        block = grad.block
        decay = regularizer(param, grad, block)
        new_grad = block.create_var(dtype=grad.dtype, shape=grad.shape)
        block.append_op("sum", inputs={"X": [grad, decay]},
                        outputs={"Out": [new_grad]})
        params_and_grads.append((param, new_grad))
    return params_and_grads
