"""Continuous-batching autoregressive decode: the serving tier's second
engine kind (counterpart of ``paddle_tpu/serving/decode``).

The one-shot tier (``serving.engine``) schedules per REQUEST; an
autoregressive workload emits hundreds of tokens per request, each a model
step over a growing KV history, so this package schedules per TOKEN STEP:

- ``kvcache``   — ``PagedKVCache``: every resident sequence's KV history in
  fixed-size blocks over one arena on the device (f32, bf16 or int8
  shared-scale storage), strict host-side accounting, eviction under
  pressure;
- ``model``     — ``TinyDecodeLM``: the seeded deterministic transformer,
  its attention the paged-attention kernel (K6) on the card;
- ``scheduler`` — ``DecodeScheduler``: per-step plan — token-budgeted
  prefill chunks, ladder-bucketed decode batch, lowest-priority-first
  preemption;
- ``engine``    — ``DecodeEngine``: the step thread + streaming ``submit()``
  front (``DecodeStream`` iterators, TTFT/ITL histograms,
  ``(request_id, token_index)`` resume, drain/stop lifecycle).

``serving.http`` serves a ``DecodeEngine`` over ``POST /generate``, and
``serving.fleet.FleetRouter.generate`` fails a stream over between decode
replicas from the next undelivered token index.
"""
from __future__ import annotations

from . import engine, kvcache, model, scheduler  # noqa: F401
from .engine import DecodeConfig, DecodeEngine, DecodeStream  # noqa: F401
from .kvcache import KVCacheConfig, KVCacheFull, PagedKVCache  # noqa: F401
from .model import TinyDecodeLM, decode_state_from_numpy  # noqa: F401
from .scheduler import DecodeScheduler, SeqState, StepPlan  # noqa: F401

__all__ = [
    "DecodeConfig", "DecodeEngine", "DecodeStream",
    "KVCacheConfig", "KVCacheFull", "PagedKVCache",
    "TinyDecodeLM", "decode_state_from_numpy", "DecodeScheduler",
    "SeqState", "StepPlan",
]
