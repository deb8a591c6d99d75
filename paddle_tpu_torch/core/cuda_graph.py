"""Steps captured into CUDA graphs: the part the whole-program route
(``core/compiler_engine``) and the lazy dygraph queue (``dygraph/lazy``)
share.

A ``GraphCache`` is one owner's (an executor core's, a lazy engine's)
captured graphs by key, its capture stream and its memory pool. A
``CapturedGraph`` is one captured step: ``capture`` records a callable
into a CUDA graph (``capture_error_mode="thread_local"``, on the owner's
capture stream, in its pool), with the generators it draws from
registered and the kernel launches it makes recorded, not counted
(``ops/cuda/support.recording_launches``); ``launch`` counts those
launches and replays the graph.

Memory, one policy for both owners: an owner's graphs share one memory
pool, and it keeps at most ``GRAPH_CAP`` of them (LRU; an evicted key is
captured again at its next run). Sharing is safe because an owner
replays one graph at a time and copies out what a replay hands out
(fetches, outputs) before it replays another; inputs and state live in
static buffers made outside the pool. The pool then holds the largest
step's working set plus what the graphs keep (their outputs), not the
sum of their working sets. The cap bounds what each graph keeps beside
the pool: a lazy step's graph holds a copy of its inputs (parameters and
moments: about 1.6 GB at dygraph_bert's width), and a serving ladder
captures one graph a bucket (four for a max batch size of 8, seven for
64).

Control flow: inside ``capture``, ``conditional(cond, is_while, trips)``
captures what its block launches into the body of a new ``while`` or
``if`` node of the graph (``ops/cuda/graph_conditional``, P1): the node is
added on the capture stream, and the block runs with a side stream of the
owner current (one a nesting depth, so that cuBLAS's per-stream workspace
and every launch land in the body) while that stream captures into the
body. Torch routes a capture's allocations by its capture id, and a body's
capture has an id of its own, so the bodies' allocations are routed by
thread into one more pool of the owner's, kept beside the first under the
same policy: bodies replay one at a time, after the node's inputs and
before what reads its outputs.
"""
from __future__ import annotations

from collections import OrderedDict
from contextlib import contextmanager
from typing import Callable, Iterable, List, Optional

import torch

__all__ = ["GRAPH_CAP", "CapturedGraph", "GraphCache", "same_memory"]

GRAPH_CAP = 8


def same_memory(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride() and a.dtype == b.dtype)


class CapturedGraph:
    """One captured step. Subclasses hold its buffers and outputs."""

    def capture(self, cache: "GraphCache", body: Callable,
                generators: Iterable[torch.Generator] = ()):
        """Capture ``body()`` into this graph; returns what it returned
        (tensors in the pool, rewritten by every replay)."""
        from ..ops.cuda import support

        self.graph = torch.cuda.CUDAGraph()
        for g in generators:
            self.graph.register_generator_state(g)
        stream, pool = cache.stream_and_pool()
        self._cache, self._depth = cache, 0
        with support.recording_launches(stream) as launches:
            with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                out = body()
        self.launches = dict(launches)
        return out

    @contextmanager
    def conditional(self, cond: torch.Tensor, is_while: bool, trips):
        """Inside ``capture``'s body: capture the block into the body of a
        new ``while`` (else ``if``) node, its handle set from ``cond`` (a
        one-element tensor on the card) before the node. Yields a list; a
        ``while`` block appends its new condition, from which the end of
        the body sets the handle for the next trip. ``trips`` is the node's
        ``support.TripCounter``: the end of the body adds one to it, and it
        keeps the launches one run of the body makes."""
        from ..ops.cuda import graph_conditional as p1
        from ..ops.cuda import support

        cache, depth = self._cache, self._depth
        side = cache.side_stream(depth)
        handle = p1.begin(torch.cuda.current_stream().cuda_stream,
                          side.cuda_stream, is_while, cond)
        new_cond: List[torch.Tensor] = []
        self._depth = depth + 1
        ok = False
        try:
            if depth == 0:
                cache.begin_body_allocations()
            try:
                with torch.cuda.stream(side), \
                        support.recording_launches(side) as launches:
                    yield new_cond
                    p1.set_condition(handle, new_cond[-1] if is_while
                                     else cond, trips.count,
                                     side.cuda_stream, set_handle=is_while)
                trips.launches = dict(launches)
            finally:
                if depth == 0:
                    cache.end_body_allocations()
            ok = True
        finally:
            self._depth = depth
            try:
                p1.end(side.cuda_stream)
            except RuntimeError:
                if ok:
                    raise

    def launch(self) -> None:
        from ..ops.cuda import support

        support.count_replay(self.launches)
        self.graph.replay()

    def release(self) -> None:
        """Called when the cache drops the graph."""


class GraphCache:
    """An owner's captured graphs by key (LRU, at most ``GRAPH_CAP``), the
    stream they are captured on and the pool they share, both made at the
    first capture."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._graphs: "OrderedDict" = OrderedDict()
        self._stream = None
        self._pool = None
        self._sides: List = []  # (handle, torch stream) a nesting depth
        self._body_pool = None
        self._body_pool_held = False

    def __len__(self) -> int:
        return len(self._graphs)

    def stream_and_pool(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        return self._stream, self._pool

    def side_stream(self, depth: int):
        """The stream bodies at nesting ``depth`` are captured on."""
        from ..ops.cuda import graph_conditional as p1

        while len(self._sides) <= depth:
            handle = p1.create_stream()
            self._sides.append((handle, torch.cuda.ExternalStream(
                handle, device=self.device)))
        return self._sides[depth][1]

    def begin_body_allocations(self) -> None:
        """Route this thread's allocations into the bodies' pool."""
        if self._body_pool is None:
            self._body_pool = torch.cuda.graph_pool_handle()
        torch._C._cuda_beginAllocateCurrentThreadToPool(
            self.device.index or 0, self._body_pool)

    def end_body_allocations(self) -> None:
        """End the routing; the first begin's hold on the pool is kept
        until ``clear``, each later one is let go."""
        index = self.device.index or 0
        torch._C._cuda_endAllocateToPool(index, self._body_pool)
        if self._body_pool_held:
            torch._C._cuda_releasePool(index, self._body_pool)
        self._body_pool_held = True

    def get(self, key) -> Optional[CapturedGraph]:
        graph = self._graphs.get(key)
        if graph is not None:
            self._graphs.move_to_end(key)
        return graph

    def put(self, key, graph: CapturedGraph) -> None:
        self._graphs[key] = graph
        while len(self._graphs) > GRAPH_CAP:
            _, old = self._graphs.popitem(last=False)
            old.release()

    def drop(self, key) -> None:
        graph = self._graphs.pop(key, None)
        if graph is not None:
            graph.release()

    def clear(self) -> None:
        """Drop every graph; the pool returns to the device at the
        caller's ``torch.cuda.empty_cache()``."""
        from ..ops.cuda import graph_conditional as p1

        for graph in self._graphs.values():
            graph.release()
        self._graphs.clear()
        self._stream = self._pool = None
        if self._body_pool_held:
            torch._C._cuda_releasePool(self.device.index or 0,
                                       self._body_pool)
        self._body_pool, self._body_pool_held = None, False
        for handle, _ in self._sides:
            p1.destroy_stream(handle)
        self._sides = []
