"""LayerHelper: the bridge from ``layers.*`` calls to Block ops.

Counterpart of ``paddle_tpu/layer_helper.py``. Parameters are declared in
the startup program with their init op and mirrored into the main program,
under the same names the JAX package gives them (``fc.w_0``,
``embedding.w_0``, ...). In dygraph mode (``dygraph.guard``) the same
calls run eagerly, as in the JAX package (:85-166): a parameter is made at
once by its initializer's op (``ParamBase.create``) and kept in the
tracer's registry by name, an output is an empty ``VarBase``, and
``append_op`` is ``Tracer.trace_op``, which fills the outputs it is given.
"""
from __future__ import annotations

from . import framework
from .core import dtypes as _dt
from .initializer import ConstantInitializer, XavierInitializer
from .param_attr import ParamAttr
from .utils import unique_name


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self._name_prefix = name if name is not None else layer_type

    @property
    def main_program(self):
        return framework.default_main_program()

    @property
    def startup_program(self):
        return framework.default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    def unique_var_name(self, key="tmp"):
        return unique_name.generate("%s_%s.%s" % (
            self._name_prefix, "", key)).replace("_.", ".")

    def input(self, input_param_name="input"):
        inputs = self.kwargs.get(input_param_name, [])
        if inputs is None:
            return []
        if isinstance(inputs, (list, tuple)):
            return list(inputs)
        return [inputs]

    @property
    def param_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("bias_attr"))

    def multiple_param_attr(self, length):
        """One ParamAttr per input: the given list, or copies of one."""
        attr = self.param_attr
        if isinstance(attr, ParamAttr):
            attr = [attr] + [ParamAttr(**attr.__dict__.copy())
                             for _ in range(length - 1)]
        return attr

    def input_dtype(self, input_param_name="input"):
        dtype = None
        for v in self.input(input_param_name):
            if dtype is None:
                dtype = v.dtype
            elif dtype != v.dtype:
                raise ValueError("mismatched input dtypes %s vs %s"
                                 % (dtype, v.dtype))
        return dtype

    def create_parameter(self, attr, shape, dtype=None, is_bias=False,
                         default_initializer=None):
        if attr is False:
            return None
        attr = ParamAttr._to_attr(attr)
        if default_initializer is None:
            default_initializer = (ConstantInitializer(0.0) if is_bias
                                   else XavierInitializer())
        attr._with_initializer(default_initializer)
        name = attr.name or unique_name.generate("%s.w" % self._name_prefix)
        if framework.in_dygraph_mode():
            from .dygraph.varbase import ParamBase

            tracer = framework._dygraph_tracer()
            existing = tracer.get_parameter(name)
            if existing is not None:
                return existing
            p = ParamBase.create(name, shape, dtype or "float32",
                                 attr.initializer, trainable=attr.trainable)
            tracer.register_parameter(p)
            return p
        main_block = self.main_program.global_block()
        if main_block.has_var_local(name):
            return main_block.vars[name]
        kwargs = {k: v for k, v in attr._to_kwargs().items() if k != "name"}
        dtype = _dt.convert_dtype(dtype or "float32")
        sp = self.startup_program.global_block().create_parameter(
            name=name, shape=shape, dtype=dtype, **kwargs)
        attr.initializer(sp, self.startup_program.global_block())
        return main_block.create_parameter(name=name, shape=shape,
                                           dtype=dtype, **kwargs)

    def set_variable_initializer(self, var, initializer):
        """Declare ``var`` in the startup program and append its init op
        there; in dygraph mode, make it at once."""
        if framework.in_dygraph_mode():
            from .dygraph.varbase import ParamBase

            return ParamBase.create(var.name, var.shape, var.dtype,
                                    initializer)
        sb = self.startup_program.global_block()
        sv = sb.create_var(name=var.name, shape=var.shape, dtype=var.dtype,
                           persistable=True)
        return initializer(sv, sb)

    def create_variable_for_type_inference(self, dtype, stop_gradient=False):
        if framework.in_dygraph_mode():
            from .dygraph.varbase import VarBase

            return VarBase(None, stop_gradient=stop_gradient)
        return self.block.create_var(
            name=unique_name.generate(".".join([self._name_prefix, "tmp"])),
            dtype=_dt.convert_dtype(dtype or "float32"), shape=None,
            persistable=False, stop_gradient=stop_gradient)

    def append_op(self, type, inputs=None, outputs=None, attrs=None,
                  infer_shape=True):
        if framework.in_dygraph_mode():
            return framework._dygraph_tracer().trace_op(
                type, inputs or {}, outputs or {}, attrs or {})
        return self.block.append_op(type, inputs, outputs, attrs,
                                    infer_shape=infer_shape)

    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        bias_attr = self.bias_attr
        if not bias_attr:
            return input_var
        size = list(input_var.shape[dim_start:dim_end])
        b = self.create_parameter(attr=bias_attr, shape=size,
                                  dtype=input_var.dtype, is_bias=True)
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op("elementwise_add",
                       inputs={"X": [input_var], "Y": [b]},
                       outputs={"Out": [tmp]}, attrs={"axis": dim_start})
        return tmp

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act = dict(act)
        act_type = act.pop("type")
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(act_type, inputs={"X": [input_var]},
                       outputs={"Out": [tmp]}, attrs=act)
        return tmp
