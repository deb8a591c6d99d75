"""Serving: dynamic batching + admission control over a shared predictor,
and the continuous-batching decode engine (counterpart of
``paddle_tpu/serving``; the HTTP front and the fleet come later)."""
from . import batcher, decode, engine, metrics  # noqa: F401
from .batcher import (BatchPolicy, DynamicBatcher, PendingRequest,  # noqa: F401
                      default_ladder, pick_bucket)
from .decode import (DecodeConfig, DecodeEngine, DecodeStream,  # noqa: F401
                     KVCacheConfig, KVCacheFull, PagedKVCache)
from .engine import (BatchExecutionError, DeadlineExpired,  # noqa: F401
                     EngineStopped, RequestTooLarge, ServerOverloaded,
                     ServingConfig, ServingEngine, ServingError)
