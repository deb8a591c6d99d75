"""Per-token-step scheduler: who prefills, who decodes, who gets
evicted — decided fresh at EVERY token step.

Counterpart of ``paddle_tpu/serving/decode/scheduler.py``, carried over as
it is: plain Python over the cache's host-side accounting.

This is the inversion that makes the engine "continuous": the one-shot
tier schedules per REQUEST (a batch forms, runs to completion, the
next batch forms), so a finished sequence's batch slot is dead weight
until the whole batch drains. Here the unit of scheduling is one token
step, and between any two steps sequences join, finish, or get evicted
— the decode batch refills immediately, which is where the
tokens-per-second win over wait-for-all batching comes from (the bench
measures exactly this).

Three decisions per step, in priority order:

- **Prefill admission, token-budgeted**: waiting sequences consume
  prompt chunks from a per-step token budget. The budget is the
  head-of-line blocking fix — a 10k-token prompt prefills across many
  steps, and the RUNNING decodes emit a token every step in between
  instead of stalling behind it (chunk boundaries are numerically free,
  see ``model.prefill_chunk``).
- **Decode batch at ladder buckets**: the active batch pads up to the
  smallest ladder bucket that fits (``batcher.pick_bucket`` — same
  discipline, same reason: a bounded set of compiled shapes on
  accelerator hosts).
- **Preemption under memory pressure**: when the KV arena can't cover
  the step, the LOWEST-priority resident sequence is evicted — blocks
  freed, generated-so-far retained — and re-admitted later as a
  re-prefill of (prompt + generated). Victims are chosen strictly
  below the requester's priority; a sequence never evicts its own
  class peers' elders (FIFO within class), and the requester defers if
  nothing outranks it.

Priority is ``(class_rank, arrival)`` — the fleet's cost classes
(interactive < batch < best_effort) then FIFO, matching the admission
ordering in ``serving/fleet.py`` so the two tiers shed the same
sequences under pressure.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

from .kvcache import PagedKVCache

__all__ = ["SeqState", "DecodeScheduler", "StepPlan"]


class SeqState:
    """One resident sequence, as the scheduler sees it. The engine
    owns the stream plumbing; this is the scheduling-relevant core."""

    __slots__ = ("seq_id", "prompt", "generated", "priority", "arrival",
                 "prefilled", "last_token", "phase", "preemptions")

    def __init__(self, seq_id: str, prompt: List[int], priority: int,
                 arrival: int):
        self.seq_id = seq_id
        self.prompt = list(prompt)
        self.generated: List[int] = []
        self.priority = int(priority)
        self.arrival = int(arrival)
        self.prefilled = 0          # tokens of replay() already in cache
        self.last_token: Optional[int] = None
        self.phase = "waiting"      # waiting | prefill | running
        self.preemptions = 0

    def replay(self) -> List[int]:
        """Tokens that must be in the cache before the next decode:
        prompt plus everything generated so far (non-empty generated
        means this is a re-prefill after preemption)."""
        return self.prompt + self.generated

    def rank(self) -> Tuple[int, int]:
        return (self.priority, self.arrival)


class StepPlan:
    """One step's work: ``prefill`` is ``[(seq, n_tokens)]`` chunks to
    run (in order), ``decode`` the sequences taking a token step,
    ``bucket`` the padded batch width for the decode call."""

    __slots__ = ("prefill", "decode", "bucket")

    def __init__(self, prefill, decode, bucket):
        self.prefill = prefill
        self.decode = decode
        self.bucket = bucket

    def empty(self) -> bool:
        return not self.prefill and not self.decode


class DecodeScheduler:
    """Owns the waiting/running sets and the per-step plan. NOT
    thread-safe by itself — the engine calls every method from its
    step thread (or under its own lock before the thread starts)."""

    def __init__(self, cache: PagedKVCache, ladder: Tuple[int, ...],
                 prefill_chunk_tokens: int = 32,
                 max_running: Optional[int] = None):
        if prefill_chunk_tokens < 1:
            raise ValueError("prefill_chunk_tokens must be >= 1")
        self.cache = cache
        self.ladder = tuple(ladder)
        self.prefill_chunk_tokens = int(prefill_chunk_tokens)
        self.max_running = int(max_running or self.ladder[-1])
        self._waiting: List[SeqState] = []   # kept rank-sorted
        self._running: List[SeqState] = []   # decode order = admit order
        self._arrival = itertools.count()

    # -- membership ---------------------------------------------------------

    def next_arrival(self) -> int:
        return next(self._arrival)

    def add(self, seq: SeqState) -> None:
        seq.phase = "waiting" if seq.prefilled < len(seq.replay()) \
            else "running"
        bucket = self._running if seq.phase == "running" else self._waiting
        bucket.append(seq)
        if bucket is self._waiting:
            self._waiting.sort(key=SeqState.rank)

    def remove(self, seq: SeqState) -> None:
        for pool in (self._waiting, self._running):
            if seq in pool:
                pool.remove(seq)

    def sequences(self) -> List[SeqState]:
        return self._waiting + self._running

    def depth(self) -> int:
        return len(self._waiting) + len(self._running)

    # -- the per-step plan --------------------------------------------------

    def plan(self) -> StepPlan:
        budget = self.prefill_chunk_tokens
        prefill: List[Tuple[SeqState, int]] = []
        # a decode slot is consumed by a running sequence OR a prefill
        # already in flight (it holds cache and will promote); new
        # sequences start prefilling only when a slot is open, so the
        # running set never outgrows the ladder
        slots = (self.max_running - len(self._running)
                 - sum(1 for s in self._waiting if s.prefilled > 0))
        for seq in self._waiting:
            if budget <= 0:
                break
            if seq.prefilled == 0:
                if slots <= 0:
                    continue
                slots -= 1
            take = min(len(seq.replay()) - seq.prefilled, budget)
            if take > 0:
                prefill.append((seq, take))
                budget -= take
        decode = self._running[:self.max_running]
        bucket = _pick(self.ladder, len(decode)) if decode else 0
        return StepPlan(prefill, decode, bucket)

    def promote(self, seq: SeqState) -> None:
        """Prefill complete: move to the decode set."""
        if seq in self._waiting:
            self._waiting.remove(seq)
        seq.phase = "running"
        if seq not in self._running:
            self._running.append(seq)

    # -- memory pressure ----------------------------------------------------

    def pick_victims(self, needed_blocks: int,
                     requester: SeqState) -> Optional[List[SeqState]]:
        """Lowest-priority resident sequences whose eviction frees at
        least ``needed_blocks``, all ranked STRICTLY below the
        requester. None if the residents below it can't cover the need
        (the requester then defers instead of evicting peers)."""
        candidates = [s for s in self._waiting + self._running
                      if s is not requester
                      and s.rank() > requester.rank()
                      and self.cache.has(s.seq_id)]
        candidates.sort(key=SeqState.rank, reverse=True)  # worst first
        victims, freed = [], 0
        bt = self.cache.config.block_tokens
        for s in candidates:
            if freed >= needed_blocks:
                break
            victims.append(s)
            freed += -(-self.cache.seq_len(s.seq_id) // bt)
        return victims if freed >= needed_blocks else None

    def preempt(self, seq: SeqState) -> int:
        """Evict: free the blocks, keep the tokens, back to waiting as
        a future re-prefill. Returns blocks freed."""
        freed = self.cache.release(seq.seq_id)
        seq.prefilled = 0
        seq.preemptions += 1
        if seq in self._running:
            self._running.remove(seq)
        if seq not in self._waiting:
            self._waiting.append(seq)
        seq.phase = "waiting"
        self._waiting.sort(key=SeqState.rank)
        return freed


def _pick(ladder, rows):
    for b in ladder:
        if b >= rows:
            return b
    return ladder[-1]
