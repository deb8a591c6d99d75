"""Async gradient communicator for parameter-server mode.

The port of ``paddle_tpu/communicator.py`` (the reference's
``communicator.py`` over ``operators/distributed/communicator.h``'s
AsyncCommunicator: send ops enqueue; a background thread merges queued
gradients per variable and pushes them to the pservers, decoupling the
trainer loop from RPC latency). HalfAsync/Geo variants map onto the
same flusher with different merge windows; geo-SGD delta shipping has
its own `geo_send` op (transpiler/geo_sgd_transpiler.py).

Behavior: while a Communicator is running, `send` ops with
sync_mode=False enqueue instead of blocking on RPC
(ops/distributed_ops.py `_send`). The flusher thread wakes every
``send_wait_ms`` (or when ``merge_num`` grads of one var are queued),
SUMS queued grads per (endpoint, var) (the reference's merge-add)
and delivers them through the path the sync op uses. Queued grads are
host arrays: the send op copied each one down from the card. ``stop()``
drains the queue before returning, so no gradient is lost at shutdown.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Optional

import numpy as np

__all__ = ["Communicator"]

_global: Optional["Communicator"] = None


def global_communicator() -> Optional["Communicator"]:
    return _global


class Communicator:
    def __init__(self, program=None, mode="ASYNC", send_wait_ms=10,
                 merge_num=20, max_retries=3):
        self.mode = mode
        self.send_wait_ms = int(send_wait_ms)
        self.merge_num = int(merge_num)
        # delivery failures requeue the merged grad and retry on later
        # flush ticks (bounded): a transient pserver blip must not cost
        # the batch. Within ONE delivery the RPC layer's retries are
        # exactly-once (dedup token); a cross-tick REDELIVERY is a
        # fresh rpc, i.e. at-least-once — fine for the async/Geo modes
        # this path serves, not for sync rounds
        self.max_retries = int(max_retries)
        self._pending = defaultdict(list)  # (ep, name) -> [arrays]
        self._attempts = defaultdict(int)  # (ep, name) -> failed tries
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._running = False
        self._thread = None
        self.pushes = 0  # flush batches delivered (observability)
        self._error = None  # first delivery failure (surfaced on use)

    # -- trainer-side enqueue (called by the send op) ----------------------

    def enqueue(self, name, ep, value):
        if self._error is not None:
            err, self._error = self._error, None
            try:
                self.stop()
            except Exception:
                pass  # the ORIGINAL failure is the one to surface
            raise RuntimeError(
                "Communicator background flush failed; async sends "
                "would be lost") from err
        if not self._running:
            raise RuntimeError("Communicator not running")
        with self._lock:
            self._pending[(ep, name)].append(np.asarray(value))
            hot = len(self._pending[(ep, name)]) >= self.merge_num
        if hot:
            self._wake.set()

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        global _global
        if self._running:
            return self
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        _global = self
        return self

    def stop(self):
        global _global
        if not self._running:
            return
        self._running = False
        self._wake.set()
        self._thread.join(timeout=30)
        if _global is self:
            _global = None
        # drain anything enqueued during shutdown. A transient failure
        # requeues within the retry budget — but after stop() there is
        # no later tick, so keep flushing until the queue is empty or a
        # key's budget is spent (then _flush raises): stop() must never
        # return cleanly with undelivered gradients sitting in _pending
        self._flush()
        while any(self._pending.values()):
            time.sleep(self.send_wait_ms / 1000.0)
            self._flush()
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                "Communicator background flush failed") from err

    def is_running(self):
        return self._running

    # -- flusher -----------------------------------------------------------

    def _loop(self):
        while self._running:
            self._wake.wait(self.send_wait_ms / 1000.0)
            self._wake.clear()
            try:
                self._flush()
            except Exception as e:
                # NEVER die silently: record the first failure; the
                # next enqueue()/stop() raises it to the trainer
                if self._error is None:
                    self._error = e
        try:
            self._flush()  # final drain is guarded too — a budget
            # exhaustion here must reach stop(), not the excepthook
        except Exception as e:
            if self._error is None:
                self._error = e

    def _flush(self):
        from .ops.distributed_ops import deliver_grad

        with self._lock:
            batch = {k: v for k, v in self._pending.items() if v}
            self._pending.clear()
        failed = None
        for (ep, name), grads in batch.items():
            merged = grads[0] if len(grads) == 1 else np.sum(
                np.stack(grads), axis=0)
            try:
                deliver_grad(name, ep, merged)
            except Exception as e:  # noqa: BLE001 — transport failure
                with self._lock:
                    self._attempts[(ep, name)] += 1
                    if self._attempts[(ep, name)] <= self.max_retries:
                        # requeue the MERGED grad at the front: a later
                        # flush re-merges it with newer grads and
                        # retries. The redelivery is a FRESH rpc (new
                        # dedup token), so this is at-least-once — the
                        # async/Geo modes this path serves tolerate a
                        # re-applied grad, and it beats silently losing
                        # the batch. (Within ONE deliver_grad the RPC
                        # layer's own retries ARE exactly-once.)
                        self._pending[(ep, name)].insert(0, merged)
                        continue
                    # budget spent: surface the failure, but let a
                    # LATER delivery for this key start a fresh budget
                    self._attempts.pop((ep, name), None)
                if failed is None:
                    failed = e
                continue
            self.pushes += 1
            with self._lock:
                self._attempts.pop((ep, name), None)
        if failed is not None:
            raise failed
