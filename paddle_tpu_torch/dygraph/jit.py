"""``TracedLayer``: a dygraph ``Layer`` recorded into a static Program.

Counterpart of ``paddle_tpu/dygraph/jit.py`` (the reference's
dygraph/jit.py:156 over imperative/jit/program_desc_tracer.cc). One
recording run of the layer under no-grad gives its outputs and a Program
(the tracer appends every op it runs: ``Tracer.start_program_recording``).
Calling the traced layer runs that Program through an ``Executor`` on the
whole-program route, on the place of the dygraph guard it was traced under
(on the card, one CUDA graph captured for the shapes and replayed): the
port's form of the JAX package's ``jax.jit`` over the layer.
``save_inference_model`` writes the Program and the current parameter
values in ``io.save_inference_model``'s format, for the predictor.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..core.tensor import LoDTensor
from .layers import Layer
from .tracer import current_tracer
from .varbase import VarBase

__all__ = ["TracedLayer"]


class TracedLayer:
    def __init__(self, params, program, feed_names, fetch_names, place):
        self._params = params
        self._program = program
        self._feed_names = list(feed_names)
        self._fetch_names = list(fetch_names)
        self._place = place
        self._exe = None
        self._scope = None

    @staticmethod
    def trace(layer: Layer, inputs: List[VarBase]):
        """One recording run of ``layer(*inputs)`` under no-grad: returns
        (its outputs, the traced layer)."""
        from .. import framework

        tracer = current_tracer()
        if tracer is None:
            raise RuntimeError("TracedLayer.trace runs in dygraph mode "
                               "(inside fluid.dygraph.guard())")
        program = framework.Program()
        blk = program.global_block()
        in_vars = [VarBase(x._force(), stop_gradient=True) for x in inputs]
        for v in in_vars:
            var = blk.create_var(name=v.name, shape=v.shape, dtype=v.dtype)
            var.is_data = True
        # one run gives both the outputs and the program: a second would
        # update BN statistics twice and draw other RNG streams
        tracer.start_program_recording(program)
        try:
            with tracer.no_grad_guard():
                outs = layer(*in_vars)
        finally:
            tracer.stop_program_recording()
        if not isinstance(outs, (list, tuple)):
            outs = [outs]
        traced = TracedLayer(layer.parameters(), program,
                             [v.name for v in in_vars],
                             [o.name for o in outs],
                             framework._dygraph_place_)
        return [VarBase(o._force(), stop_gradient=True) for o in outs], \
            traced

    @property
    def program(self):
        return self._program

    def _stage(self):
        """The executor and scope the recorded program runs in, each
        parameter's current tensor in the scope."""
        from .. import executor as _executor
        from ..core.scope import Scope

        if self._exe is None:
            self._exe = _executor.Executor(self._place)
            self._scope = Scope()
        for p in self._params:
            var = self._scope.var(p.name)
            h = var.raw() if var.is_initialized() else None
            if not (isinstance(h, LoDTensor) and h.array is p._force()):
                var.set(LoDTensor(p._force()))
        return self._exe, self._scope

    def __call__(self, inputs):
        exe, scope = self._stage()
        feed = {}
        for name, x in zip(self._feed_names, inputs):
            feed[name] = x._force() if isinstance(x, VarBase) \
                else np.asarray(x)
        outs = exe.run(self._program, feed=feed,
                       fetch_list=self._fetch_names, scope=scope,
                       return_numpy=False)
        return [VarBase(o.array, stop_gradient=True) for o in outs]

    def save_inference_model(self, dirname, feed=None, fetch=None,
                             model_filename=None, params_filename=None):
        """Write the recorded program and the parameters' current values
        as ``io.save_inference_model`` does; ``feed`` / ``fetch`` pick
        inputs and outputs by position, and a ``model_filename`` not
        ending in ``.json`` asks for the protobuf format."""
        from .. import io
        from ..core.place import CPUPlace
        from ..core.scope import Scope, scope_guard
        from ..executor import Executor

        feed_names = ([self._feed_names[i] for i in feed] if feed
                      else list(self._feed_names))
        fetch_names = ([self._fetch_names[i] for i in fetch] if fetch
                       else list(self._fetch_names))
        blk = self._program.global_block()
        scope = Scope()
        for p in self._params:
            scope.var(p.name).set(LoDTensor(p._force()))
        with scope_guard(scope):
            io.save_inference_model(dirname, feed_names,
                                    [blk.var(n) for n in fetch_names],
                                    Executor(CPUPlace()),
                                    main_program=self._program,
                                    model_filename=model_filename,
                                    params_filename=params_filename)
