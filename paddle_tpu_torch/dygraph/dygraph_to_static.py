"""dygraph_to_static: ``ProgramTranslator`` and ``@declarative``.

Counterpart of ``paddle_tpu/dygraph/dygraph_to_static.py`` (the
reference's dygraph_to_static/program_translator.py:229). As there,
``@declarative`` is AST-first: the function's AST is rewritten
(``ast_transform``) so that tensor-dependent ``if`` / ``while`` / ``for
range`` build graph control flow (a select, a ``while`` op), then the
converted function runs once per input signature on static placeholder
Variables to build a Program, cached per signature (LRU). The Program
runs through ``Executor.run``'s whole-program route, so a tensor loop is
one captured CUDA graph with a ``while`` node: a new tensor value never
rebuilds the Program nor captures it again.

Fallback: a function that cannot be built statically (a dygraph ``Layer``
with eager parameters, source not available) is traced instead: run once
under the dygraph tracer with its ops recorded into a Program
(``Tracer.start_program_recording``), which specializes data-dependent
Python control flow per input signature, as a trace does.

The Program runs on the place of the dygraph guard the call is made
under, else on the card (``CUDAPlace(0)``), through one shared
``Executor`` a place.
"""
from __future__ import annotations

import functools
import warnings
from collections import OrderedDict
from typing import Dict

import numpy as np

from ..core.dtypes import convert_dtype
from .varbase import VarBase

__all__ = ["ProgramTranslator", "declarative", "to_static"]


def _as_array(a):
    """Tensor-like args become feeds; anything else passes through.
    Numpy scalars and numeric lists/tuples are tensor-like (they fed
    as arrays before the AST path landed and must keep doing so — one
    program per shape/dtype, not one per value); plain Python scalars
    stay static args (usable as shapes/flags), jit-style."""
    if isinstance(a, VarBase):
        return a._force()
    if isinstance(a, (np.ndarray, np.generic)):
        return np.asarray(a)
    if isinstance(a, (list, tuple)) and a and not isinstance(
            a[0], (str, bytes, type(None))):
        try:
            arr = np.asarray(a)
        except (ValueError, TypeError):
            return None
        if arr.dtype != object:
            return arr
    return None


class _TracedFunction:
    def __init__(self, fn):
        from .ast_transform import ast_to_static_func

        self._fn = fn
        self._static_fn, self._ast_ok = ast_to_static_func(fn)
        # LRU: signature -> entry dict. Bounded so a long-lived process
        # feeding fresh object-keyed args doesn't grow programs (and
        # their pinned args) without limit.
        self._cache: "OrderedDict" = OrderedDict()
        self._cache_cap = 64
        self._staged: Dict = {}  # param name -> id(array) staged in scope

    def __get__(self, obj, objtype=None):
        """Descriptor protocol: @declarative on a method binds self."""
        if obj is None:
            return self

        bound = functools.partial(self.__call__, obj)
        bound.get_program = lambda *a: self.get_program(obj, *a)
        return bound

    def _signature(self, args):
        """Returns (signature, pinned) — ``pinned`` holds the
        identity-keyed objects whose id() appears in the signature;
        they are stored on the cache entry so the ids stay valid for
        exactly as long as the entry lives (LRU-bounded, no process-
        lifetime leak)."""
        sig = []
        pinned = []
        for a in args:
            arr = _as_array(a)
            if arr is None:
                if isinstance(a, (int, float, str, bool, type(None))):
                    sig.append(("py", type(a).__name__, a))
                else:
                    # identity-keyed: pin the object on the entry so
                    # its address is never recycled into a false cache
                    # hit (mutating the object still reuses the stale
                    # program — the reference's InputSpec caveat)
                    pinned.append(a)
                    sig.append(("py", type(a).__name__, id(a)))
            else:
                sig.append((tuple(arr.shape), convert_dtype(arr.dtype)))
        return tuple(sig), pinned

    def _cache_lookup(self, args):
        """LRU get-or-build for the (signature -> entry) program cache."""
        sig, pinned = self._signature(args)
        entry = self._cache.get(sig)
        if entry is not None:
            self._cache.move_to_end(sig)
            return entry
        entry = self._build_entry(args)
        entry["pins"] = pinned
        self._cache[sig] = entry
        if len(self._cache) > self._cache_cap:
            # evict least-recent entries WITHOUT parameters only:
            # a static entry that ran its startup (or a trace entry
            # holding params) must not be silently re-initialized with
            # fresh weights on a later rebuild
            for k in list(self._cache):
                if len(self._cache) <= self._cache_cap:
                    break
                e = self._cache[k]
                holds_params = (e.get("params") or
                                (e.get("kind") == "static" and
                                 e["startup"].global_block().ops))
                if e is not entry and not holds_params:
                    del self._cache[k]
        return entry

    # -- AST/static path ---------------------------------------------------

    def _build_static(self, args):
        """Build a Program by running the AST-converted function on
        placeholder Variables (reference StaticFunction concrete
        program, program_translator.py:480)."""
        from .. import framework
        from ..layers import io as lio

        program = framework.Program()
        startup = framework.Program()
        prev_tracer = framework._dygraph_tracer_
        framework._dygraph_tracer_ = None  # build statically
        try:
            with framework.program_guard(program, startup):
                call_args = []
                feed_names = []
                for idx, a in enumerate(args):
                    arr = _as_array(a)
                    if arr is None:
                        call_args.append(a)
                        continue
                    name = "_jst_feed_%d" % idx
                    v = lio.data(name=name, shape=list(arr.shape),
                                 dtype=convert_dtype(arr.dtype),
                                 append_batch_size=False)
                    feed_names.append(name)
                    call_args.append(v)
                outs = self._static_fn(*call_args)
        finally:
            framework._dygraph_tracer_ = prev_tracer
        single = not isinstance(outs, (list, tuple))
        outs_l = [outs] if single else list(outs)
        for o in outs_l:
            if not isinstance(o, framework.Variable):
                raise ValueError(
                    "declarative function returned a non-Variable %r"
                    % (o,))
        return {"kind": "static", "program": program, "startup": startup,
                "feeds": feed_names, "fetches": [o.name for o in outs_l],
                "single": single, "initialized": False}

    # -- trace fallback ----------------------------------------------------

    def _trace(self, args):
        from .. import framework
        from .base import enabled, guard
        from .tracer import current_tracer

        import contextlib

        ctx = contextlib.nullcontext() if enabled() else guard()
        with ctx:
            tracer = current_tracer()
            program = framework.Program()
            blk = program.global_block()
            in_vars = []
            call_args = []
            for a in args:
                arr = _as_array(a)
                if arr is None:
                    call_args.append(a)
                    continue
                v = VarBase(arr, stop_gradient=True)
                var = blk.create_var(name=v.name, shape=tuple(arr.shape),
                                     dtype=convert_dtype(arr.dtype))
                var.is_data = True
                in_vars.append(v)
                call_args.append(v)
            tracer.start_program_recording(program)
            try:
                outs = self._fn(*call_args)
            finally:
                tracer.stop_program_recording()
            single = not isinstance(outs, (list, tuple))
            outs_l = [outs] if single else list(outs)
            params = {p.name: p for p in tracer.all_parameters()
                      if blk.has_var_local(p.name)}
            return {"kind": "trace", "program": program,
                    "feeds": [v.name for v in in_vars],
                    "fetches": [o.name for o in outs_l],
                    "params": params, "single": single}

    def _build_entry(self, args):
        if self._ast_ok:
            from .ast_transform import Dy2StaticError

            try:
                return self._build_static(args)
            except Dy2StaticError:
                # a conversion DIAGNOSTIC (tensor control flow the
                # graph cannot express) — surface it; the trace path
                # would silently change semantics
                raise
            except Exception as e:  # dygraph Layers etc. -> trace path
                warnings.warn(
                    "dygraph_to_static: static AST build failed (%s: %s); "
                    "falling back to trace-based conversion — "
                    "data-dependent Python control flow will be "
                    "specialized per input signature"
                    % (type(e).__name__, e))
        return self._trace(args)

    # -- execution ---------------------------------------------------------

    def __call__(self, *args):
        if not ProgramTranslator().enabled:
            return self._fn(*args)
        entry = self._cache_lookup(args)

        from ..core.scope import global_scope
        from ..core.tensor import LoDTensor

        exe = _shared_executor()
        scope = global_scope()
        if entry["kind"] == "static":
            if not entry["initialized"]:
                if entry["startup"].global_block().ops:
                    exe.run(entry["startup"], scope=scope)
                entry["initialized"] = True
        else:
            for name, p in entry["params"].items():
                # stage the live parameter when it changed since the last
                # call (a captured step then copies it into its buffer)
                if self._staged.get(name) != id(p._array):
                    scope.var(name).set(LoDTensor(p._force()))
                    self._staged[name] = id(p._array)
        feed = {}
        arrs = [a for a in (_as_array(x) for x in args) if a is not None]
        for n, a in zip(entry["feeds"], arrs):
            feed[n] = a
        outs = exe.run(entry["program"], feed=feed,
                       fetch_list=entry["fetches"], return_numpy=False,
                       scope=scope)
        result = [VarBase(o.array if hasattr(o, "array") else o,
                          stop_gradient=True) for o in outs]
        return result[0] if entry["single"] else result

    def get_program(self, *args):
        return self._cache_lookup(args)["program"]


_executors: Dict = {}


def _shared_executor():
    """The executor of the current dygraph guard's place (the card
    outside a guard), one a place."""
    from .. import framework
    from ..core.place import CUDAPlace
    from ..executor import Executor

    place = framework._dygraph_place_ if framework.in_dygraph_mode() \
        else None
    place = place if place is not None else CUDAPlace(0)
    key = str(place.device())
    exe = _executors.get(key)
    if exe is None:
        exe = _executors[key] = Executor(place)
    return exe


class ProgramTranslator:
    """Singleton switch + cache (reference program_translator.py:229)."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance.enabled = True
        return cls._instance

    def enable(self, enable_to_static=True):
        self.enabled = bool(enable_to_static)

    def get_program(self, dygraph_func, *args):
        if not isinstance(dygraph_func, _TracedFunction):
            dygraph_func = _TracedFunction(dygraph_func)
        return dygraph_func.get_program(*args)


def declarative(fn):
    """@declarative / @to_static decorator."""
    traced = _TracedFunction(fn)
    functools.update_wrapper(traced, fn)
    return traced


to_static = declarative
