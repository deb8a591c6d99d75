"""``Executor`` — the user-facing program runner.

Counterpart of ``paddle_tpu/executor.py``. ``run`` applies the single-chip
fusion rewrite a program asks for (``core.fusion``; the fused optimizer
update under ``PADDLE_TPU_FUSED_OPTIMIZER``), stages numpy feeds onto the
executor's device, runs the program op by op through ``core.CoreExecutor``
and copies fetches back as numpy arrays.

The place decides the device. With no place the executor runs on the card
(``CUDAPlace(0)``); ``CPUPlace()`` asks for the CPU. On the card the
constructor builds the port's CUDA kernels and launches the probe kernel
once (``ops/cuda/support.ensure_kernels``), so a card that cannot run them
fails here, before the first program. On a host without a card, asking for
it raises.
"""
from __future__ import annotations

from . import framework
from .core import CoreExecutor, CUDAPlace, global_scope
from .core.fusion import maybe_rewrite_single_chip


class Executor:
    def __init__(self, place=None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = self.place.device()
        if self.device.type == "cuda":
            from .ops.cuda.support import ensure_kernels

            ensure_kernels(self.device)
        self._core = CoreExecutor(self.device)

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name="feed", fetch_var_name="fetch", scope=None,
            return_numpy=True, use_program_cache=False):
        scope = scope if scope is not None else global_scope()
        if program is None:
            program = framework.default_main_program()
        maybe_rewrite_single_chip(program, scope, self.device)
        return self._core.run_program(program, scope, feed or {},
                                      list(fetch_list or []), return_numpy)
