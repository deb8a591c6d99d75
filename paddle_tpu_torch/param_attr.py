"""ParamAttr and WeightNormParamAttr (counterpart of
``paddle_tpu/param_attr.py``)."""
from __future__ import annotations

from .initializer import Initializer


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=None,
                 gradient_clip=None):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.gradient_clip = gradient_clip

    @staticmethod
    def _to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, (list, tuple)):
            return [ParamAttr._to_attr(a) for a in arg]
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, bool):
            return ParamAttr() if arg else False
        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        raise TypeError("cannot make ParamAttr from %r" % (arg,))

    def _with_initializer(self, default):
        if self.initializer is None:
            self.initializer = default
        return self

    def _to_kwargs(self):
        return {"name": self.name,
                "optimize_attr": {"learning_rate": self.learning_rate},
                "regularizer": self.regularizer,
                "trainable": self.trainable,
                "do_model_average": self.do_model_average}


class WeightNormParamAttr(ParamAttr):
    """A ParamAttr that names the weight-norm dim (``paddle_tpu/param_attr.py
    :65``). The layer helper makes the same one parameter from it as from
    a ParamAttr, as the JAX package's helper does, so a program builds the
    same ops and parameters in both packages."""

    def __init__(self, dim=None, **kwargs):
        super().__init__(**kwargs)
        self.dim = dim
