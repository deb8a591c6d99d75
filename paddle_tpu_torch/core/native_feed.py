"""Asynchronous host-to-device feed staging.

Counterpart of the ``AsyncDeviceFeeder`` half of
``paddle_tpu/core/native_feed.py`` (``async_feed_enabled`` and the
``PADDLE_TPU_ASYNC_FEED`` knob included): a bounded queue that a background
thread keeps filled with the next batches already staged on the device, so
that a step's feed costs its critical path only the queue pop. The whole-
program route takes the staged tensors as they are (a device-to-device
``copy_`` into its static feed buffer), with no round trip through the host.

On the card each batch is copied from pinned host memory with
``non_blocking`` copies on a side stream, and an event recorded after the
copies; the consumer's stream waits on that event before the feed is read.
On the CPU (``device`` a CPU place or device) a batch is staged as CPU
tensors. Each value is staged by ``core.tensor.stage_feed``, the rule
``Executor.run`` applies: float64 becomes float32.

The C++ multi-slot reader (``NativeMultiSlotFeed``) waits for the dataset
port (ROADMAP.md).
"""
from __future__ import annotations

import os
import queue
import threading

import torch

from .tensor import stage_feed

__all__ = ["AsyncDeviceFeeder", "async_feed_enabled"]


def async_feed_enabled() -> bool:
    """``PADDLE_TPU_ASYNC_FEED``: opt-in double-buffered host feed."""
    raw = os.environ.get("PADDLE_TPU_ASYNC_FEED")
    return bool(raw) and raw.strip().lower() in ("1", "true", "yes", "on")


def _as_device(device) -> torch.device:
    if device is None:
        return torch.device("cuda", torch.cuda.current_device())
    if hasattr(device, "device") and callable(device.device):  # a Place
        return device.device()
    return torch.device(device)


class AsyncDeviceFeeder:
    """Double-buffered host-to-device feed staging.

    Wraps an iterator of ``{name: np.ndarray}`` batches; a background
    thread keeps up to ``depth`` batches staged on ``device`` (the card by
    default). Iterating yields dicts of tensors ready to feed
    ``Executor.run``. A producer's exception re-raises in the consumer.
    ``close()`` (or exhaustion) joins the thread; the feeder is also a
    context manager.
    """

    _DONE = object()

    def __init__(self, batches, depth: int = 2, device=None):
        if depth < 1:
            raise ValueError("AsyncDeviceFeeder depth must be >= 1")
        self._device = _as_device(device)
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err = None
        self._closed = False
        self._thread = threading.Thread(
            target=self._pump, args=(iter(batches),), daemon=True)
        self._thread.start()

    def _stage(self, batch):
        host = {k: stage_feed(v) for k, v in batch.items()}
        if self._stream is None:
            return {k: t.clone() for k, t in host.items()}, None
        with torch.cuda.stream(self._stream):
            staged = {k: t.pin_memory().to(self._device, non_blocking=True)
                      for k, t in host.items()}
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return staged, ready

    def _put(self, item) -> bool:
        """Bounded put that re-checks the close flag, so a close() racing a
        full queue never strands this thread on a blocking put."""
        while not self._closed:
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _pump(self, it):
        try:
            for batch in it:
                if self._closed or not self._put(self._stage(batch)):
                    return
        except Exception as e:  # surfaced to the consumer on next()
            self._err = e
        finally:
            self._put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            raise StopIteration
        staged, ready = item
        if ready is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(ready)
            for t in staged.values():  # made on the side stream
                t.record_stream(consumer)
        return staged

    def close(self):
        self._closed = True
        # drain so the pump thread's bounded put unblocks promptly
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
