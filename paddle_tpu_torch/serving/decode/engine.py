"""DecodeEngine: the continuous-batching serving loop.

Counterpart of ``paddle_tpu/serving/decode/engine.py``. The engine runs on
the card (``cuda:0``) unless ``DecodeConfig(place=CPUPlace())`` asks for the
CPU; built on the card it builds the port's CUDA kernels and runs the probe
(``ops/cuda/support.ensure_kernels``) and raises if that fails. The cache
arenas and the model live on that device; the step thread reads the new
tokens back once a step. Its metrics record into the process registry (what
``GET /metrics`` serves) and into the engine's own view, which ``stats()``
reads (``serving/metrics.EngineMetrics``).

One step thread owns the cache, the model, and the scheduler; clients
talk to it through ``submit()`` which returns a ``DecodeStream`` —
an iterator of token events fed from the step thread through a queue.
Every token step the thread: (1) takes the scheduler's prefill chunks
(token-budgeted, so long prompts interleave with running decodes) and
reserves their positions, (2) evicts lowest-priority sequences if the KV
arena can't cover the step (``serving.preemptions``, flight event,
re-prefill on re-admission), (3) runs the chunks and one batched decode
step at a ladder bucket in ONE pass of the model (``TinyDecodeLM.step``;
a row's bits do not depend on the rows beside it, so this is what
separate calls would compute) and fans the new tokens out to their
streams.

SLO axis: ``serving.ttft_ms`` (submit -> first token) and
``serving.itl_ms`` (gap between tokens), the decode-tier replacements
for the one-shot tier's ``serving.queue_ms``, in ``stats()``.

Exactly-once streaming: tokens are indexed from 0 and the engine keeps
a bounded LRU of FINISHED streams' tokens, so a duplicate submit
(hedge, retry) replays instantly from any ``resume_from`` index, and a
submit that arrives while the original is still in flight attaches as
a second subscriber to the SAME sequence — both see every event, each
filtered to its own resume index. A resumed stream on a FRESH replica
(fleet failover) has no LRU entry; it regenerates from the prompt —
deterministic greedy decode makes the regenerated tokens bit-identical
(``model.py``) — and suppresses emission below ``resume_from``. Either
way the client never sees a token index twice: that is what lets the
fleet hedge and fail over decode streams with the same exactly-once
latch it uses for one-shot requests.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from ...core import CUDAPlace
from ...observability import flight
from .. import metrics as M
from ..batcher import default_ladder, pick_bucket
from ..engine import (DeadlineExpired, EngineStopped, RequestTooLarge,
                      ServerOverloaded, ServingError)
from .kvcache import KVCacheConfig, PagedKVCache
from .model import TinyDecodeLM
from .scheduler import DecodeScheduler, SeqState

__all__ = ["DecodeConfig", "DecodeEngine", "DecodeStream"]

# decode cost classes mirror the fleet's admission lanes (highest
# priority first); rank here = shed/evict order there
_CLASS_RANK = {"high": 0, "normal": 1, "low": 2}


class DecodeConfig:
    """Engine knobs. ``kv_*`` shape the cache arena; ``ladder`` is the
    decode batch buckets (None -> powers of two up to
    ``max_batch_size``); ``prefill_chunk_tokens`` is the per-step
    prompt budget; ``max_tokens_cap`` bounds any single stream;
    ``default_deadline_s`` applies when a submit names none
    (None -> no deadline); ``place`` is the device (None -> the card,
    ``CUDAPlace(0)``; ``CPUPlace()`` asks for the CPU)."""

    def __init__(self, *,
                 kv_blocks: int = 128,
                 kv_block_tokens: int = 16,
                 kv_dtype: str = "f32",
                 num_layers: int = 2,
                 num_heads: int = 2,
                 head_dim: int = 8,
                 vocab_size: int = 97,
                 model_seed: int = 0xD0DE,
                 max_batch_size: int = 8,
                 ladder: Optional[Tuple[int, ...]] = None,
                 prefill_chunk_tokens: int = 32,
                 max_waiting: int = 64,
                 default_max_tokens: int = 16,
                 max_tokens_cap: int = 512,
                 max_prompt_tokens: int = 1024,
                 default_deadline_s: Optional[float] = None,
                 dedup_capacity: int = 256,
                 attn_backend: Optional[str] = None,
                 eos_token: Optional[int] = 0,
                 step_idle_s: float = 0.05,
                 place=None):
        self.cache = KVCacheConfig(
            num_blocks=kv_blocks, block_tokens=kv_block_tokens,
            num_layers=num_layers, num_heads=num_heads,
            head_dim=head_dim, dtype=kv_dtype)
        self.vocab_size = int(vocab_size)
        self.model_seed = int(model_seed)
        self.max_batch_size = int(max_batch_size)
        self.ladder = tuple(ladder) if ladder else default_ladder(
            self.max_batch_size)
        self.prefill_chunk_tokens = int(prefill_chunk_tokens)
        self.max_waiting = int(max_waiting)
        self.default_max_tokens = int(default_max_tokens)
        self.max_tokens_cap = int(max_tokens_cap)
        self.max_prompt_tokens = int(max_prompt_tokens)
        self.default_deadline_s = default_deadline_s
        self.dedup_capacity = int(dedup_capacity)
        self.attn_backend = attn_backend
        self.eos_token = eos_token
        self.step_idle_s = float(step_idle_s)
        self.place = place

    @property
    def pass_rows(self) -> int:
        """The row count of every product of the engine's model: a full
        decode batch plus one step's prompt budget, the most rows a pass
        carries, so that a pass issues each product once. A token's bits
        depend on it: engines that regenerate each other's streams share
        it, as they share their config."""
        return (max(max(self.ladder), self.max_batch_size)
                + self.prefill_chunk_tokens)


class DecodeStream:
    """Client handle: iterate token events, or drain with
    ``result()``. Events are dicts:

    ``{"type": "token", "index": i, "token": t}`` then one terminal
    ``{"type": "finish", "reason": r, "tokens": n}`` where reason is
    ``eos | max_tokens | deadline_expired | cancelled |
    engine_stopped``. Error reasons also carry ``"error": message``.
    Iteration ends after the finish event."""

    def __init__(self, request_id: str, resume_from: int = 0):
        self.request_id = request_id
        self.resume_from = int(resume_from)
        self._q: "queue.SimpleQueue[dict]" = queue.SimpleQueue()
        self._cancel = threading.Event()
        self._on_cancel = None            # set by the engine
        self.finish: Optional[dict] = None
        self.finished_at: Optional[float] = None  # monotonic, at finish

    # engine side -----------------------------------------------------------

    def _push(self, event: dict) -> None:
        if event.get("type") == "finish":
            self.finished_at = time.monotonic()
            self.finish = event
        self._q.put(event)

    def cancelled(self) -> bool:
        return self._cancel.is_set()

    # client side -----------------------------------------------------------

    def cancel(self) -> None:
        """Ask the engine to stop this stream; a terminal finish event
        (reason ``cancelled``) still arrives."""
        self._cancel.set()
        if self._on_cancel is not None:
            self._on_cancel()

    def __iter__(self) -> Iterator[dict]:
        while True:
            ev = self._q.get()
            yield ev
            if ev.get("type") == "finish":
                return

    def result(self, timeout_s: Optional[float] = None
               ) -> Tuple[List[int], dict]:
        """Drain: ``(tokens in index order, finish event)``. Raises
        the stream's terminal error as a typed ServingError."""
        deadline = (time.monotonic() + timeout_s) if timeout_s else None
        toks: Dict[int, int] = {}
        while True:
            left = None if deadline is None else max(
                0.0, deadline - time.monotonic())
            try:
                ev = self._q.get(timeout=left)
            except queue.Empty:
                raise TimeoutError("stream %r: no event within %.1fs"
                                   % (self.request_id, timeout_s))
            if ev["type"] == "token":
                toks[ev["index"]] = ev["token"]
            elif ev["type"] == "finish":
                if ev["reason"] == "deadline_expired":
                    raise DeadlineExpired(ev.get("error", ev["reason"]))
                if ev["reason"] == "engine_stopped":
                    raise EngineStopped(ev.get("error", ev["reason"]))
                return ([toks[i] for i in sorted(toks)], ev)


class _Entry:
    """One live sequence: scheduler state + stream fan-out."""

    __slots__ = ("seq", "request_id", "max_tokens", "deadline",
                 "submit_t", "first_token_t", "last_token_t", "subs")

    def __init__(self, seq: SeqState, request_id: str, max_tokens: int,
                 deadline: Optional[float]):
        self.seq = seq
        self.request_id = request_id
        self.max_tokens = max_tokens
        self.deadline = deadline
        self.submit_t = time.monotonic()
        self.first_token_t: Optional[float] = None
        self.last_token_t: Optional[float] = None
        self.subs: List[DecodeStream] = []


class DecodeEngine:
    """See module docstring. Lifecycle mirrors ``ServingEngine``:
    ``start() -> serving``, ``stop(drain=True)`` finishes resident
    streams first; ``health()`` reports the same phase strings so the
    fleet prober needs no special casing."""

    def __init__(self, config: Optional[DecodeConfig] = None):
        self.config = config or DecodeConfig()
        place = self.config.place or CUDAPlace(0)
        self.device = place.device()
        if self.device.type == "cuda":
            from ...ops.cuda.support import ensure_kernels

            ensure_kernels(self.device)
        self.metrics = M.EngineMetrics()
        self.cache = PagedKVCache(self.config.cache, place)
        # every product runs at one row count, the most a pass carries,
        # and the logits at the largest bucket's, so a row's bits do not
        # depend on the batch it rides in
        self.model = TinyDecodeLM(
            self.cache, vocab_size=self.config.vocab_size,
            seed=self.config.model_seed,
            attn_backend=self.config.attn_backend,
            eos_token=self.config.eos_token,
            rows=self.config.pass_rows, logit_rows=max(self.config.ladder))
        self.scheduler = DecodeScheduler(
            self.cache, self.config.ladder,
            prefill_chunk_tokens=self.config.prefill_chunk_tokens,
            max_running=self.config.max_batch_size)
        self._phase = "starting"
        # ONE reentrant lock over entries + scheduler + cache: the
        # step thread holds it for a whole token step (compute is
        # milliseconds at this scale), so submit/stats/step never
        # interleave mid-mutation. Reentrant because _finish runs both
        # from submit (lock held once) and from inside a step.
        self._lock = threading.RLock()
        self._wake = threading.Condition(self._lock)
        self._entries: Dict[str, _Entry] = {}      # request_id -> live
        self._finished: "OrderedDict[str, dict]" = OrderedDict()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._seq_counter = 0
        # hints for the step thread, counted under their own lock: callers
        # waiting for the engine lock (submit, stop), and cancel() calls
        # ever (against the count the last reap saw)
        self._hint_lock = threading.Lock()
        self._waiters = 0
        self._cancels = self._cancels_seen = 0
        self.steps = 0
        # host seconds in token steps, and in their model passes: what is
        # left of the first is the engine's own work
        self.step_seconds = 0.0
        self.pass_seconds = 0.0

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "DecodeEngine":
        if self._thread is not None:
            raise RuntimeError("engine already started")
        self._phase = "serving"
        self._thread = threading.Thread(
            target=self._step_loop, name="decode-engine", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True,
             timeout_s: float = 30.0) -> None:
        with self._waiting(), self._lock:
            if self._phase == "stopped":
                return
            self._phase = "draining"
            self._wake.notify_all()
        if drain:
            deadline = time.monotonic() + timeout_s
            while time.monotonic() < deadline:
                with self._lock:
                    if not self._entries:
                        break
                time.sleep(0.01)
        self._stop.set()
        with self._lock:
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
        with self._lock:
            for entry in list(self._entries.values()):
                self._finish(entry, "engine_stopped",
                             error="engine stopped before completion")
            self._phase = "stopped"

    def health(self) -> str:
        return self._phase

    def health_doc(self) -> dict:
        """The /healthz body: lifecycle phase plus what a decode
        prober needs — ``engine_kind`` so routers stop schema-sniffing
        and the KV occupancy that decides where new streams fit."""
        kv = self.cache.stats()
        with self._lock:
            live = len(self._entries)
        return {
            "status": self._phase,
            "engine_kind": "decode",
            "kv_occupancy": kv["occupancy"],
            "kv_free_blocks": kv["free_blocks"],
            "kv_blocks": kv["num_blocks"],
            "kv_dtype": kv["dtype"],
            "active_streams": live,
            "steps": self.steps,
        }

    def stats(self) -> dict:
        out = self.metrics.snapshot()
        out["kv"] = self.cache.stats()
        out["steps"] = self.steps
        out["step_seconds"] = self.step_seconds
        out["pass_seconds"] = self.pass_seconds
        return out

    # -- submit -------------------------------------------------------------

    def submit(self, prompt, *, max_tokens: Optional[int] = None,
               request_id: Optional[str] = None,
               cost_class: str = "high",
               deadline_s: Optional[float] = None,
               resume_from: int = 0) -> DecodeStream:
        """Start (or attach to, or replay) a decode stream.

        ``prompt`` is a non-empty list of token ids < vocab_size;
        ``resume_from`` suppresses emission of token indices below it
        (fleet failover/hedge — the tokens are regenerated or
        replayed, never re-delivered). Raises ``ServerOverloaded`` /
        ``RequestTooLarge`` / ``EngineStopped`` synchronously, like
        the one-shot engine."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ServingError("empty prompt")
        if any(t < 0 or t >= self.config.vocab_size for t in prompt):
            raise ServingError("prompt token out of range [0, %d)"
                               % self.config.vocab_size)
        if len(prompt) > self.config.max_prompt_tokens:
            raise RequestTooLarge(
                "prompt of %d tokens exceeds max_prompt_tokens=%d"
                % (len(prompt), self.config.max_prompt_tokens))
        n_max = int(max_tokens or self.config.default_max_tokens)
        if n_max < 1:
            raise ServingError("max_tokens must be >= 1")
        n_max = min(n_max, self.config.max_tokens_cap)
        if cost_class not in _CLASS_RANK:
            raise ServingError("unknown cost class %r (have %s)"
                               % (cost_class, sorted(_CLASS_RANK)))
        resume_from = max(0, int(resume_from))
        if deadline_s is None:
            deadline_s = self.config.default_deadline_s
        rid = request_id or ("stream-%d-%d"
                             % (id(self), time.monotonic_ns()))

        with self._waiting():
            return self._admit(prompt, n_max, rid, cost_class, deadline_s,
                               resume_from)

    @contextlib.contextmanager
    def _waiting(self):
        """Count the caller among those waiting for the engine lock."""
        with self._hint_lock:
            self._waiters += 1
        try:
            yield
        finally:
            with self._hint_lock:
                self._waiters -= 1

    def _admit(self, prompt, n_max, rid, cost_class, deadline_s,
               resume_from) -> DecodeStream:
        with self._lock:
            if self._phase not in ("serving", "warming"):
                raise EngineStopped("engine is %s" % self._phase)
            stream = DecodeStream(rid, resume_from)
            stream._on_cancel = self._note_cancel
            # replay a finished stream from the LRU (hedge/failover
            # landing after completion): exactly-once by construction
            done = self._finished.get(rid)
            if done is not None:
                self._finished.move_to_end(rid)
                self.metrics.inc(M.DEDUP_HITS)
                for i, t in enumerate(done["tokens"]):
                    if i >= resume_from:
                        stream._push({"type": "token", "index": i,
                                      "token": t})
                stream._push(dict(done["finish"]))
                return stream
            live = self._entries.get(rid)
            if live is not None:
                # in-flight duplicate: second subscriber, same sequence
                self.metrics.inc(M.DEDUP_HITS)
                for i, t in enumerate(live.seq.generated):
                    if i >= resume_from:
                        stream._push({"type": "token", "index": i,
                                      "token": t})
                live.subs.append(stream)
                return stream
            if self.scheduler.depth() >= self.config.max_waiting:
                self.metrics.inc(M.REJECTED)
                raise ServerOverloaded(
                    "%d streams resident (max_waiting=%d)"
                    % (self.scheduler.depth(), self.config.max_waiting))
            self._seq_counter += 1
            seq = SeqState("seq-%d" % self._seq_counter, prompt,
                           _CLASS_RANK[cost_class],
                           self.scheduler.next_arrival())
            entry = _Entry(seq, rid, n_max,
                           (time.monotonic() + deadline_s)
                           if deadline_s else None)
            entry.subs.append(stream)
            self._entries[rid] = entry
            self.cache.register(seq.seq_id)
            self.scheduler.add(seq)
            self.metrics.inc(M.STREAMS)
            if resume_from > 0:
                self.metrics.inc(M.STREAM_RESUMES)
            self._wake.notify_all()
            return stream

    def generate(self, prompt, *, max_tokens: Optional[int] = None,
                 request_id: Optional[str] = None,
                 cost_class: str = "high",
                 deadline_s: Optional[float] = None,
                 resume_from: int = 0) -> DecodeStream:
        """The streaming-surface name ``http.py`` and the fleet route
        by (an engine with ``.generate`` streams; one without is
        one-shot). Same contract as ``submit``."""
        return self.submit(prompt, max_tokens=max_tokens,
                           request_id=request_id, cost_class=cost_class,
                           deadline_s=deadline_s,
                           resume_from=resume_from)

    # -- step loop ----------------------------------------------------------

    def _step_loop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not self._stop.is_set():
            with self._lock:
                plan = self.scheduler.plan()
                if plan.empty():
                    self._wake.wait(timeout=self.config.step_idle_s)
                    continue
                entries = {e.seq.seq_id: e
                           for e in self._entries.values()}
                t0 = time.perf_counter()
                try:
                    self._run_step(plan, entries)
                except Exception as exc:  # pragma: no cover
                    # a step-loop crash would silently hang every
                    # stream; fail them loudly instead
                    for entry in list(self._entries.values()):
                        self._finish(entry, "engine_stopped",
                                     error="step loop error: %s" % exc)
                    self._phase = "stopped"
                    raise
                self.step_seconds += time.perf_counter() - t0
                self.steps += 1
                self.metrics.set_gauge(M.KV_OCCUPANCY,
                                       self.cache.occupancy())
            # let a caller waiting on the lock in before the next step: a
            # step on the card takes milliseconds, and without a pause the
            # thread takes the lock straight back and starves a submit, or
            # a stop until every stream has finished
            if self._waiters:
                time.sleep(0)

    def _run_step(self, plan, entries: Dict[str, _Entry]) -> None:
        now = time.monotonic()
        # 0) deadlines + cancels reap before any compute (skipped while
        # no stream has a deadline and none was cancelled)
        cancels = self._cancels
        reap = cancels != self._cancels_seen or any(
            e.deadline is not None for e in entries.values())
        self._cancels_seen = cancels
        for seq in list(self.scheduler.sequences()) if reap else ():
            entry = entries.get(seq.seq_id)
            if entry is None:
                continue
            if len(entry.subs) == 1 and not entry.subs[0].cancelled():
                cancelled = False
            else:
                cancelled = any(s.cancelled() for s in entry.subs)
            if cancelled:
                with self._lock:
                    self._finish(entry, "cancelled")
            elif entry.deadline is not None and now > entry.deadline:
                with self._lock:
                    self._finish(entry, "deadline_expired",
                                 error="deadline passed after %d token(s)"
                                 % len(seq.generated))

        # 1) prefill chunks under the token budget: their positions are
        # reserved now, their rows run in the step's one model pass below
        parts = []
        for seq, take in plan.prefill:
            entry = self._live(seq, entries)
            if entry is None or seq.phase != "waiting":
                continue
            tokens = seq.replay()[seq.prefilled:seq.prefilled + take]
            if not self._ensure_fit(seq, len(tokens), entries):
                continue                      # defer; try next step
            if not self.cache.has(seq.seq_id):
                self.cache.register(seq.seq_id)
            start = self.cache.reserve(seq.seq_id, len(tokens))
            seq.prefilled += len(tokens)
            seq.phase = "prefill"
            parts.append((seq, entry, tokens, start))

        # 2) decode step over the running set at a ladder bucket
        batch = [s for s in plan.decode
                 if s.phase == "running"
                 and self._live(s, entries) is not None]
        # memory pressure: every member needs one token's worth of
        # blocks; evict lowest-priority residents (possibly batch
        # members) until the step fits
        need = self.cache.blocks_needed_each([s.seq_id for s in batch], 1)
        while batch and need > self.cache.free_blocks():
            victim = self._preempt_one(batch[0], entries)
            if victim is None:
                break
            if victim in batch:
                batch.remove(victim)
            need = self.cache.blocks_needed_each(
                [s.seq_id for s in batch], 1)
        if need > self.cache.free_blocks():
            batch = []                         # arena pinned; wait
        # a chunk whose sequence was evicted just now has nothing to run
        parts = [p for p in parts if self.cache.has(p[0].seq_id)]
        if not parts and not batch:
            return
        bucket = pick_bucket(self.config.ladder, len(batch)) if batch \
            else None
        t0 = time.perf_counter()
        nxt, firsts = self.model.step(
            [s.seq_id for s in batch], [s.last_token for s in batch],
            bucket, [(seq.seq_id, tokens, start,
                      seq.prefilled == len(seq.replay()))
                     for seq, _, tokens, start in parts])
        self.pass_seconds += time.perf_counter() - t0
        firsts_out = []
        for (seq, entry, tokens, _), first in zip(parts, firsts):
            self.metrics.inc(M.PREFILL_TOKENS, len(tokens))
            self.metrics.inc(M.PREFILL_CHUNKS)
            if first is not None:
                # prompt (+ any pre-preemption tokens) fully resident:
                # the chunk's last hidden row yields the next token
                self.scheduler.promote(seq)
                firsts_out.append((entry, first))
            else:
                seq.phase = "waiting"
        if firsts_out:
            self._emit(firsts_out)
        if batch:
            self.metrics.observe(M.DECODE_BATCH, len(batch))
            self.metrics.inc(M.DECODE_STEPS)
            self._emit([(entries[s.seq_id], t)
                        for s, t in zip(batch, nxt.tolist())
                        if s.seq_id in entries])

    def _live(self, seq: SeqState, entries: Dict[str, _Entry]
              ) -> Optional[_Entry]:
        """The entry of ``seq`` unless it finished since ``entries`` was
        taken (a deadline or a cancel reaped it this step)."""
        entry = entries.get(seq.seq_id)
        if entry is None or self._entries.get(entry.request_id) is not entry:
            return None
        return entry

    def _ensure_fit(self, seq: SeqState, n_tokens: int,
                    entries: Dict[str, _Entry]) -> bool:
        """Evict strictly-lower-priority residents until ``seq`` can
        take ``n_tokens``; False -> could not make room, defer."""
        while not self.cache.can_fit(
                seq.seq_id if self.cache.has(seq.seq_id) else None,
                n_tokens):
            needed = self.cache.blocks_needed(
                seq.seq_id if self.cache.has(seq.seq_id) else None,
                n_tokens) - self.cache.free_blocks()
            victims = self.scheduler.pick_victims(needed, seq)
            if not victims:
                return False
            for v in victims:
                self._do_preempt(v, entries)
        return True

    def _preempt_one(self, requester: SeqState,
                     entries: Dict[str, _Entry]) -> Optional[SeqState]:
        victims = self.scheduler.pick_victims(1, requester)
        if not victims:
            return None
        self._do_preempt(victims[0], entries)
        return victims[0]

    def _do_preempt(self, victim: SeqState,
                    entries: Dict[str, _Entry]) -> None:
        freed = self.scheduler.preempt(victim)
        self.metrics.inc(M.PREEMPTIONS)
        flight.record("serving.kv_preempt", seq=victim.seq_id,
                      blocks_freed=freed,
                      generated=len(victim.generated),
                      priority=victim.priority,
                      preemptions=victim.preemptions)

    def _emit(self, pairs) -> None:
        """Record one generated token for each ``(entry, token)`` of a
        step, fan them out to the subscribers, close the streams that
        hit a finish condition. The step's tokens share one clock
        reading and one update of each metric."""
        now = time.monotonic()
        ttft, itl = [], []
        eos = self.model.eos_token
        for entry, token in pairs:
            seq = entry.seq
            index = len(seq.generated)
            seq.generated.append(token)
            seq.last_token = token
            if entry.first_token_t is None:
                entry.first_token_t = now
                ttft.append((now - entry.submit_t) * 1e3)
            elif entry.last_token_t is not None:
                itl.append((now - entry.last_token_t) * 1e3)
            entry.last_token_t = now
            for sub in entry.subs:
                if index >= sub.resume_from:
                    sub._push({"type": "token", "index": index,
                               "token": token})
            if eos is not None and token == eos:
                with self._lock:
                    self._finish(entry, "eos")
            elif len(seq.generated) >= entry.max_tokens:
                with self._lock:
                    self._finish(entry, "max_tokens")
        if ttft:
            self.metrics.observe_many(M.TTFT_MS, ttft)
        if itl:
            self.metrics.observe_many(M.ITL_MS, itl)
        self.metrics.inc(M.TOKENS, len(pairs))

    def _note_cancel(self) -> None:
        with self._hint_lock:
            self._cancels += 1

    def _finish(self, entry: _Entry, reason: str,
                error: Optional[str] = None) -> None:
        """Terminal transition (caller holds the lock): release cache,
        drop from scheduler, push the finish event, remember the
        stream in the dedup LRU."""
        if self._entries.get(entry.request_id) is not entry:
            return                               # already finished
        del self._entries[entry.request_id]
        self.scheduler.remove(entry.seq)
        self.cache.release(entry.seq.seq_id)
        ev = {"type": "finish", "reason": reason,
              "tokens": len(entry.seq.generated),
              "preemptions": entry.seq.preemptions}
        if error is not None:
            ev["error"] = error
            self.metrics.inc(M.STREAM_ERRORS)
        for sub in entry.subs:
            sub._push(dict(ev))
        self._finished[entry.request_id] = {
            "tokens": list(entry.seq.generated), "finish": ev}
        while len(self._finished) > self.config.dedup_capacity:
            self._finished.popitem(last=False)
