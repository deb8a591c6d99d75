"""``Executor`` — the user-facing program runner.

Counterpart of ``paddle_tpu/executor.py``. ``run`` applies the single-chip
fusion rewrites a program asks for (``core.fusion``: the fused epilogues
under ``PADDLE_TPU_FUSED_EPILOGUE``, then the fused optimizer update under
``PADDLE_TPU_FUSED_OPTIMIZER``), then dispatches to either

- the whole-program route (the default: ``core/compiler_engine``; on the
  card one CUDA graph captured per program and shapes, then replayed; on
  the CPU the same step function run eagerly), or
- the op-by-op ``core.CoreExecutor``, under ``FLAGS_check_nan_inf`` (which
  it checks after every op), for a
  program that ``untraceable_reasons`` names a blocking op in (a host op
  that does not fold, an op that is not registered), and for LoD feeds.
  A program of 64 or more ops that falls to it warns, naming the blocking
  ops; every fallback counts ``executor.compile_fallbacks``.

The place decides the device. With no place the executor runs on the card
(``CUDAPlace(0)``); ``CPUPlace()`` asks for the CPU. On the card the
constructor builds the port's CUDA kernels and launches the probe kernel
once (``ops/cuda/support.ensure_kernels``), so a card that cannot run them
fails here, before the first program. On a host without a card, asking for
it raises. ``close()`` frees the executor's captured graphs.
"""
from __future__ import annotations

import threading
import warnings
from typing import Dict

from . import framework
from .core import CoreExecutor, CUDAPlace, global_scope
from .core import compiler_engine as _ce
from .core.flags import flag
from .core.fusion import maybe_rewrite_single_chip


class Executor:
    def __init__(self, place=None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = self.place.device()
        if self.device.type == "cuda":
            from .ops.cuda.support import ensure_kernels

            ensure_kernels(self.device)
        self._core = CoreExecutor(self.device)
        self._traceable_cache: Dict = {}
        self._compile_fallbacks: Dict = {}
        # one step at a time: a captured graph's static buffers are shared
        self._lock = threading.RLock()
        self._closed = False

    @property
    def runs_to_capture(self) -> int:
        """Runs of one program and shapes before it replays a graph: the
        eager first run, then the capture (the CPU captures nothing)."""
        return 2 if self.device.type == "cuda" else 1

    def close(self):
        """Free the captured graphs and step functions; the memory returns
        to the device at the caller's ``torch.cuda.empty_cache()``."""
        with self._lock:
            self._core.close()
            self._closed = True

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name="feed", fetch_var_name="fetch", scope=None,
            return_numpy=True, use_program_cache=False):
        scope = scope if scope is not None else global_scope()
        if program is None:
            program = framework.default_main_program()
        feed = feed or {}
        fetch_list = list(fetch_list or [])
        with self._lock:
            maybe_rewrite_single_chip(program, scope, self.device)
            # FLAGS_check_nan_inf needs the per-op interpreter
            if not flag("check_nan_inf"):
                ver = _ce._program_version(program)
                if ver not in self._compile_fallbacks and \
                        self._can_whole_compile(program):
                    try:
                        return _ce.run_compiled_program(
                            self._core, program, scope, feed, fetch_list,
                            return_numpy)
                    except _ce.LoDFeed as e:
                        warnings.warn(
                            "program %s falls back to op-by-op "
                            "interpretation (%s)" % (program._uid, e))
                        self._compile_fallbacks[ver] = repr(e)
                        _ce.inc("executor.compile_fallbacks")
            return self._core.run_program(program, scope, feed, fetch_list,
                                          return_numpy)

    def _can_whole_compile(self, program) -> bool:
        """Cached per program version; a declined program counts one
        fallback, and warns when it has 64 or more ops (op-by-op
        interpretation of a big program is a large cliff: one host
        dispatch per op per step)."""
        ver = _ce._program_version(program)
        hit = self._traceable_cache.get(ver)
        if hit is None:
            block = program.global_block()
            reasons = _ce.untraceable_reasons(block)
            hit = not reasons
            self._traceable_cache[ver] = hit
            if not hit:
                _ce.inc("executor.compile_fallbacks")
                if len(block.ops) >= 64:
                    warnings.warn(
                        "program %s (%d ops) is NOT whole-program "
                        "compilable and will run op-by-op on the "
                        "interpreter; blocking ops: %s"
                        % (program._uid, len(block.ops), ", ".join(reasons)))
        return hit
