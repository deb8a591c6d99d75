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
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Iterable, Optional

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
        with support.recording_launches(stream) as launches:
            with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                out = body()
        self.launches = dict(launches)
        return out

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

    def __len__(self) -> int:
        return len(self._graphs)

    def stream_and_pool(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        return self._stream, self._pool

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
        for graph in self._graphs.values():
            graph.release()
        self._graphs.clear()
        self._stream = self._pool = None
