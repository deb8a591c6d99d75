"""Weight decay: ``append_regularization_ops`` (counterpart of
``paddle_tpu/regularizer.py:50``) for programs that set no regularizer.
The L1/L2 decay classes come with a later slice (ROADMAP.md); asking for
one raises here rather than train without it."""
from __future__ import annotations


def append_regularization_ops(parameters_and_grads, regularization=None):
    for param, grad in parameters_and_grads:
        regularizer = getattr(param, "regularizer", None) or regularization
        if grad is not None and regularizer is not None:
            raise NotImplementedError(
                "regularization (%r on %s) is not yet ported (ROADMAP.md, "
                "queue 1)" % (regularizer, param.name))
    return list(parameters_and_grads)
