"""``dygraph.Layer``, the eager module base class.

Counterpart of ``paddle_tpu/dygraph/layers.py``: sublayers and parameters
(registered by attribute), buffers, ``state_dict`` (the ParamBases and
buffers themselves, by structured name) and ``set_dict`` (numpy arrays or
VarBases), train/eval, forward hooks, ``clear_gradients``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import List

import numpy as np

from .. import framework
from ..utils import unique_name
from .varbase import ParamBase, VarBase

__all__ = ["Layer"]


class Layer:
    def __init__(self, name_scope=None, dtype="float32"):
        self._full_name = unique_name.generate(
            name_scope or self.__class__.__name__.lower())
        self._dtype = dtype
        self._parameters: "OrderedDict[str, ParamBase]" = OrderedDict()
        self._sub_layers: "OrderedDict[str, Layer]" = OrderedDict()
        self._buffers: "OrderedDict[str, VarBase]" = OrderedDict()
        self.training = True
        self._forward_pre_hooks = OrderedDict()
        self._forward_post_hooks = OrderedDict()

    def full_name(self):
        return self._full_name

    # -- mode -------------------------------------------------------------
    def train(self):
        self.training = True
        tracer = framework._dygraph_tracer()
        if tracer:
            tracer.train_mode = True
        for l in self.sublayers():
            l.training = True
        return self

    def eval(self):
        self.training = False
        tracer = framework._dygraph_tracer()
        if tracer:
            tracer.train_mode = False
        for l in self.sublayers():
            l.training = False
        return self

    # -- registration -----------------------------------------------------
    def add_parameter(self, name, parameter):
        if parameter is not None and not isinstance(parameter, ParamBase):
            raise TypeError("parameter must be ParamBase")
        self._parameters[name] = parameter
        return parameter

    def add_sublayer(self, name, sublayer):
        self._sub_layers[name] = sublayer
        return sublayer

    def register_buffer(self, name, tensor, persistable=True):
        if tensor is not None and not isinstance(tensor, VarBase):
            tensor = VarBase(np.asarray(tensor), stop_gradient=True)
        self._buffers[name] = tensor
        return tensor

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        from ..layer_helper import LayerHelper

        helper = LayerHelper(self.full_name(), param_attr=attr)
        from ..param_attr import ParamAttr

        return helper.create_parameter(ParamAttr._to_attr(attr), list(shape),
                                       dtype or self._dtype, is_bias,
                                       default_initializer)

    # -- traversal --------------------------------------------------------
    def parameters(self, include_sublayers=True) -> List[ParamBase]:
        out = [p for p in self._parameters.values() if p is not None]
        if include_sublayers:
            for l in self._sub_layers.values():
                out.extend(l.parameters())
        return out

    def named_parameters(self, prefix="", include_sublayers=True):
        for name, p in self._parameters.items():
            if p is not None:
                yield (prefix + name if not prefix else prefix + "." + name), p
        if include_sublayers:
            for lname, l in self._sub_layers.items():
                sub_prefix = lname if not prefix else prefix + "." + lname
                yield from l.named_parameters(sub_prefix)

    def sublayers(self, include_sublayers=True) -> List["Layer"]:
        out = []
        for l in self._sub_layers.values():
            out.append(l)
            if include_sublayers:
                out.extend(l.sublayers())
        return out

    def named_sublayers(self, prefix="", include_self=False):
        if include_self:
            yield prefix, self
        for name, l in self._sub_layers.items():
            sub = name if not prefix else prefix + "." + name
            yield from l.named_sublayers(sub, include_self=True)

    # -- state dict -------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix=""):
        dest = destination if destination is not None else OrderedDict()
        for name, p in self._parameters.items():
            if p is not None:
                dest[structured_name_prefix + name] = p
        for name, b in self._buffers.items():
            if b is not None:
                dest[structured_name_prefix + name] = b
        if include_sublayers:
            for lname, l in self._sub_layers.items():
                l.state_dict(dest, True, structured_name_prefix + lname + ".")
        return dest

    def set_dict(self, state_dict, include_sublayers=True,
                 use_structured_name=True):
        own = self.state_dict()
        for key, value in state_dict.items():
            if key in own:
                arr = (value.numpy() if isinstance(value, VarBase)
                       else np.asarray(value))
                own[key].set_value(arr)

    set_state_dict = set_dict
    load_dict = set_dict

    # -- call -------------------------------------------------------------
    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def __call__(self, *inputs, **kwargs):
        for hook in self._forward_pre_hooks.values():
            hook_result = hook(self, inputs)
            if hook_result is not None:
                inputs = hook_result
        outputs = self.forward(*inputs, **kwargs)
        for hook in self._forward_post_hooks.values():
            hook_result = hook(self, inputs, outputs)
            if hook_result is not None:
                outputs = hook_result
        return outputs

    # -- attribute magic --------------------------------------------------
    def __setattr__(self, name, value):
        if isinstance(value, ParamBase):
            object.__getattribute__(self, "_parameters")[name] = value
        elif isinstance(value, Layer):
            object.__getattribute__(self, "_sub_layers")[name] = value
        object.__setattr__(self, name, value)

    def __getattr__(self, name):
        # only called when normal lookup fails
        for store in ("_parameters", "_sub_layers", "_buffers"):
            d = self.__dict__.get(store)
            if d and name in d:
                return d[name]
        raise AttributeError("%s has no attribute %r"
                             % (type(self).__name__, name))

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_gradient()
