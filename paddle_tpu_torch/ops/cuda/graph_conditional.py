"""Conditional nodes in a captured CUDA graph: the port's own kernel P1.

Not the port of a TPU kernel: where the JAX package lowers ``while`` and
``conditional_block`` to ``lax.while_loop`` / ``lax.cond`` inside one XLA
program, a captured step of the port holds them as CUDA graph conditional
nodes (``paddle_tpu_torch/csrc/graph_conditional.cu``). The source's set
kernel reads a scalar condition tensor on the card and sets the node's
handle; its host functions begin a ``while`` or an ``if`` node in the graph
that a stream is capturing and capture a side stream into the node's body.
``core/cuda_graph.CapturedGraph.conditional`` drives them.

``begin`` launches the set kernel once before the node, ``set_condition``
once at the end of each trip of a ``while`` body (and once at the end of an
``if`` body, counting only); each launch counts in ``LAUNCHES``. ``begin``
raises unless its stream is capturing; every call takes a condition on
the card and raises on anything else: a condition on the card reaches
the kernel or an exception.

The plain version, for CPU tensors, is the host loop (``host_while``):
read the condition, run the body, repeat.
"""
from __future__ import annotations

import ctypes
from typing import Callable

import torch

from . import support

LAUNCHES = support.launch_counter("graph_conditional")
_fns = None

# condition dtype -> the source's CondKind
_KINDS = {torch.bool: 0, torch.uint8: 0, torch.int8: 0,
          torch.float16: 1, torch.bfloat16: 1, torch.int16: 1,
          torch.int32: 2, torch.int64: 3, torch.float32: 4,
          torch.float64: 5}


def _lib():
    global _fns
    if _fns is None:
        lib = support.load_library("graph_conditional")
        v, i = ctypes.c_void_p, ctypes.c_int
        lib.paddle_graph_begin_conditional.argtypes = [
            v, v, i, v, i, ctypes.POINTER(ctypes.c_ulonglong)]
        lib.paddle_graph_set_conditional.argtypes = [
            ctypes.c_ulonglong, v, i, i, v, v]
        lib.paddle_graph_end_conditional.argtypes = [v]
        lib.paddle_graph_stream_create.argtypes = [ctypes.POINTER(v)]
        lib.paddle_graph_stream_destroy.argtypes = [v]
        for fn in (lib.paddle_graph_begin_conditional,
                   lib.paddle_graph_set_conditional,
                   lib.paddle_graph_end_conditional,
                   lib.paddle_graph_stream_create,
                   lib.paddle_graph_stream_destroy):
            fn.restype = i
        _fns = lib
    return _fns


def _check(code: int) -> None:
    support.check_launch(_lib(), "paddle_graph", code)


def _kind(cond: torch.Tensor) -> int:
    if cond.device.type != "cuda":
        raise ValueError("graph_conditional: condition on %s; the plain "
                         "version is the host loop" % cond.device)
    if cond.numel() != 1:
        raise ValueError("graph_conditional: the condition must hold one "
                         "value, got shape %s" % (tuple(cond.shape),))
    kind = _KINDS.get(cond.dtype)
    if kind is None:
        raise ValueError("graph_conditional: no condition of type %s"
                         % cond.dtype)
    return kind


def condition_value(cond: torch.Tensor) -> bool:
    """The plain version of the set kernel's read: the condition on the
    host (one copy off the device)."""
    return bool(cond.reshape(-1)[0].item())


def host_while(cond: Callable[[], torch.Tensor],
               body: Callable[[], None]) -> int:
    """Plain version of a ``while`` node: run ``body`` while ``cond()``
    reads true on the host; returns the trips."""
    trips = 0
    while condition_value(cond()):
        body()
        trips += 1
    return trips


def create_stream() -> int:
    """A non-blocking stream for bodies to be captured on (its handle)."""
    out = ctypes.c_void_p()
    _check(_lib().paddle_graph_stream_create(ctypes.byref(out)))
    return out.value


def destroy_stream(handle: int) -> None:
    _check(_lib().paddle_graph_stream_destroy(handle))


def begin(stream: int, side: int, is_while: bool,
          cond: torch.Tensor) -> int:
    """Set a new handle from ``cond`` and add a ``while`` (else ``if``)
    node on it to the graph ``stream`` captures; ``side`` then captures
    into the node's body. Returns the handle."""
    kind = _kind(cond)
    handle = ctypes.c_ulonglong()
    _check(_lib().paddle_graph_begin_conditional(
        stream, side, int(bool(is_while)), cond.data_ptr(), kind,
        ctypes.byref(handle)))
    LAUNCHES.inc()
    return handle.value


def set_condition(handle: int, cond: torch.Tensor, trips: torch.Tensor,
                  stream: int, set_handle: bool = True) -> None:
    """At the end of a body: add one to ``trips`` (a one-element int64 on
    the card) and, for a ``while``, set the handle from ``cond``."""
    kind = _kind(cond)
    if trips.dtype != torch.int64 or trips.device != cond.device:
        raise ValueError("graph_conditional: the trip counter must be an "
                         "int64 on the condition's device")
    _check(_lib().paddle_graph_set_conditional(
        handle, cond.data_ptr(), kind, int(set_handle), trips.data_ptr(),
        stream))
    LAUNCHES.inc()


def end(side: int) -> None:
    """End the capture of the body begun on ``side``."""
    _check(_lib().paddle_graph_end_conditional(side))
