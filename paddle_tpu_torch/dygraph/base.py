"""``dygraph.guard`` / ``enable_dygraph`` / ``to_variable`` / ``no_grad``.

Counterpart of ``paddle_tpu/dygraph/base.py``. The place decides the
device, as for ``Executor``: with no place a guard runs on the card
(``CUDAPlace(0)``); ``CPUPlace()`` asks for the CPU. On the card, entering
builds the port's CUDA kernels and launches the probe kernel once per
device (``ops/cuda/support.ensure_kernels``), raising if either fails; on
a host without a card, asking for it raises. ``lazy=True`` (default:
``FLAGS_dygraph_lazy``) queues ops and flushes them once a step
(``lazy.py``): a CUDA graph a step on the card. Leaving a guard flushes
its queue and frees its captured graphs; every VarBase keeps its value.
"""
from __future__ import annotations

import contextlib
import functools

from .. import framework
from .tracer import Tracer, _set_tracer
from .varbase import VarBase

__all__ = ["guard", "enabled", "to_variable", "no_grad", "enable_dygraph",
           "disable_dygraph"]


def enabled():
    return framework.in_dygraph_mode()


def _lazy_default():
    from ..core.flags import flag

    return str(flag("dygraph_lazy")).lower() in ("1", "true", "yes", "on")


def _make_tracer(place, lazy):
    from ..core.place import CUDAPlace

    place = place if place is not None else CUDAPlace(0)
    device = place.device()
    if device.type == "cuda":
        from ..ops.cuda.support import ensure_kernels

        ensure_kernels(device)
    tracer = Tracer(lazy=_lazy_default() if lazy is None else lazy,
                    device=device)
    return tracer, place


def _install(tracer, place):
    framework._dygraph_tracer_ = tracer
    framework._dygraph_place_ = place
    _set_tracer(tracer)


@contextlib.contextmanager
def guard(place=None, lazy=None):
    tracer, place = _make_tracer(place, lazy)
    old = (framework._dygraph_tracer_, framework._dygraph_place_)
    _install(tracer, place)
    try:
        yield
    finally:
        tracer.flush()
        _install(*old)
        if tracer.lazy_engine is not None:
            tracer.lazy_engine.close()


def enable_dygraph(place=None, lazy=None):
    _install(*_make_tracer(place, lazy))


def disable_dygraph():
    tracer = framework._dygraph_tracer_
    if tracer is not None:
        tracer.flush()
    _install(None, None)


def to_variable(value, name=None, zero_copy=None):
    if isinstance(value, VarBase):
        return value
    return VarBase(value, name=name, stop_gradient=True)


def no_grad(fn=None):
    if fn is None:
        tracer = framework._dygraph_tracer()
        if tracer is None:
            return contextlib.nullcontext()
        return tracer.no_grad_guard()

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        tracer = framework._dygraph_tracer()
        if tracer is None:
            return fn(*args, **kwargs)
        with tracer.no_grad_guard():
            return fn(*args, **kwargs)

    return wrapper
