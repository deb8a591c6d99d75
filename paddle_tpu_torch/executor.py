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
  that does not fold, an op that is not registered, a LoD op), for a
  LoD feed into a program without LoD ops, and for a program the route
  declines once it has looked at its control flow (``Untraceable``: a
  non-scalar ``conditional_block``, a loop carry that changes shape or
  type, an RNG op in a ``while`` on the card), named in ``declines()``,
  before anything is written to the scope, as the JAX executor takes
  what fails its trace. A program of 64 or more ops that falls to it
  warns, naming the blocking ops, as does every declined one; every
  fallback counts ``executor.compile_fallbacks``, once a program
  version.

A program with LoD feeds and LoD ops first tries the LoD lowering
(``core/lod_lowering``, the JAX executor's ``_lod_lowered``): a lowered
clone, cached per program version and LoD feeds, takes the whole-program
route with each LoD feed padded to its power-of-two bucket and its
lengths fed beside it. Each decline (LoD of more than one level, an op
the lowering cannot take, a fetch of a ragged var, which would read padded
values) warns once, counts ``lod_lowering.declines`` under its name, and
takes the interpreter.

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
from .core import lod_lowering as _ll
from .core.flags import flag
from .core.fusion import maybe_rewrite_single_chip
from .core.tensor import LoDTensor


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
        # (program version, LoD feeds) -> (clone, feeds, ragged vars) or a
        # Decline; and the declines already counted
        self._lod_lowered_cache: Dict = {}
        self._lod_declined: set = set()
        self._interpreted_versions: set = set()
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
                if ver not in self._compile_fallbacks:
                    if self._can_whole_compile(program):
                        try:
                            return _ce.run_compiled_program(
                                self._core, program, scope, feed,
                                fetch_list, return_numpy)
                        except _ce.LoDFeed as e:
                            warnings.warn(
                                "program %s falls back to op-by-op "
                                "interpretation (%s)" % (program._uid, e))
                            self._compile_fallbacks[ver] = repr(e)
                            _ce.inc("executor.compile_fallbacks")
                        except _ce.Untraceable as e:
                            warnings.warn(
                                "program %s falls back to op-by-op "
                                "interpretation (whole-program compile "
                                "failed: %r)" % (program._uid, e))
                            self._compile_fallbacks[ver] = repr(e)
                            _ce.inc("executor.compile_fallbacks")
                            _ce.count_decline(e.name, counter=None)
                    else:
                        lowered = self._lod_lowered(program, feed,
                                                    fetch_list)
                        if lowered is not None:
                            return _ce.run_compiled_program(
                                self._core, lowered[0], scope, lowered[1],
                                fetch_list, return_numpy)
                        self._interpreted(program, ver)
            return self._core.run_program(program, scope, feed, fetch_list,
                                          return_numpy)

    def _can_whole_compile(self, program) -> bool:
        """Whether ``untraceable_reasons`` finds nothing, cached per
        program version."""
        ver = _ce._program_version(program)
        hit = self._traceable_cache.get(ver)
        if hit is None:
            hit = not _ce.untraceable_reasons(program.global_block())
            self._traceable_cache[ver] = hit
        return hit

    def _interpreted(self, program, ver) -> None:
        """A declined program takes the interpreter: one fallback counted
        a version, and a warning where it has 64 or more ops (op-by-op
        interpretation of a big program is a large cliff: one host
        dispatch per op per step)."""
        if ver in self._interpreted_versions:
            return
        self._interpreted_versions.add(ver)
        block = program.global_block()
        reasons = _ce.untraceable_reasons(block)
        _ce.inc("executor.compile_fallbacks")
        if len(block.ops) >= 64:
            warnings.warn(
                "program %s (%d ops) is NOT whole-program compilable and "
                "will run op-by-op on the interpreter; blocking ops: %s"
                % (program._uid, len(block.ops), ", ".join(reasons)))

    def _decline(self, program, key, why: str) -> None:
        """Count and name a LoD-lowering decline, once a key."""
        if key in self._lod_declined:
            return
        self._lod_declined.add(key)
        _ce.count_decline(why)
        warnings.warn("LoD lowering declined for program %s (%s): ragged "
                      "steps take the op-by-op interpreter"
                      % (program._uid, why))

    def _lod_lowered(self, program, feed, fetch_list):
        """(lowered program, padded feed) when every LoD feed pads onto
        the whole-program route, else None (the decline counted)."""
        lod_feeds = {n: len(v.lod()) for n, v in feed.items()
                     if isinstance(v, LoDTensor) and v.lod()}
        if not lod_feeds:
            return None
        key = (_ce._program_version(program), tuple(sorted(lod_feeds)))
        hit = self._lod_lowered_cache.get(key)
        if hit is None:
            if any(levels != 1 for levels in lod_feeds.values()):
                hit = _ll.Decline(-1, "feed", "multi-level LoD")
            else:
                hit = _ll.build_lowered(program, sorted(lod_feeds))
            if not isinstance(hit, _ll.Decline):
                left = _ce.untraceable_reasons(hit[0].global_block())
                if left:
                    hit = _ll.Decline(-1, "program", "after the lowering: "
                                      + ", ".join(left))
                else:
                    _ce.inc("lod_lowering.lowered")
            self._lod_lowered_cache[key] = hit
        if isinstance(hit, _ll.Decline):
            self._decline(program, key, "%s: %s" % (hit.op_type, hit.reason))
            return None
        lowered, ragged_feeds, ragged_vars = hit
        names = {f if isinstance(f, str) else f.name for f in fetch_list}
        if names & ragged_vars:
            self._decline(program, key + (tuple(sorted(names)),),
                          "fetch: ragged var %s"
                          % ", ".join(sorted(names & ragged_vars)))
            return None
        padded = dict(feed)
        for n in ragged_feeds:
            padded[n], padded[_ll._len_name(n)] = _ll.pad_lod_feed(feed[n])
        return lowered, padded
