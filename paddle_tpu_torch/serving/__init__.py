"""Serving: dynamic batching over a shared predictor, the continuous-
batching decode engine, the HTTP front and the replica fleet.

Counterpart of ``paddle_tpu/serving``:

- ``batcher``: ``DynamicBatcher`` (futures, micro-batches under a
  max-size/timeout policy, batch sizes bucketed to a fixed ladder) and
  ``plan_ladder``;
- ``engine``: ``ServingEngine``, N workers over one shared predictor,
  typed admission control, deadlines, warm-up of every bucket (on the
  card, up to its captured CUDA graph), drain, lifecycle and health
  document, trace context;
- ``decode``: ``DecodeEngine``, the paged KV cache and per-token-step
  scheduling, streaming with ``(request_id, token_index)`` resume;
- ``http``: ``POST /predict``, ``POST /generate`` (chunked ndjson),
  ``GET /healthz``, ``GET /metrics``;
- ``fleet``: ``FleetRouter``, shared admission, cost-class shedding,
  health-checked routing with ejection and rejoin, exactly-once hedged
  retries and token-level stream failover over N replicas; the HTTP front
  serves a fleet unchanged;
- ``metrics``: the always-on ``serving.*`` families in the process
  registry.

Minimal use::

    from paddle_tpu_torch.inference import (AnalysisConfig,
                                            create_paddle_predictor)
    from paddle_tpu_torch import serving

    predictor = create_paddle_predictor(AnalysisConfig(model_dir))
    engine = serving.ServingEngine(
        predictor, serving.ServingConfig(max_batch_size=16)).start()
    out = engine.predict({"img": x})          # in-process
    serving.serve(engine, port=8080)          # ...or over HTTP
"""
from . import batcher, decode, engine, fleet, http, metrics  # noqa: F401
from .batcher import (BatchPolicy, DynamicBatcher, PendingRequest,  # noqa: F401
                      default_ladder, pick_bucket, plan_ladder)
from .decode import (DecodeConfig, DecodeEngine, DecodeStream,  # noqa: F401
                     KVCacheConfig, KVCacheFull, PagedKVCache)
from .engine import (BatchExecutionError, DeadlineExpired,  # noqa: F401
                     EngineStopped, RequestTooLarge, ServerOverloaded,
                     ServingConfig, ServingEngine, ServingError)
from .fleet import (FleetConfig, FleetRouter, ReplicaUnavailable,  # noqa: F401
                    RequestShed)
from .http import ServingHTTPServer, serve, start_http_server  # noqa: F401

__all__ = [
    "BatchPolicy", "DynamicBatcher", "default_ladder", "pick_bucket",
    "ServingConfig", "ServingEngine", "ServingError", "ServerOverloaded",
    "DeadlineExpired", "EngineStopped", "RequestTooLarge",
    "DecodeConfig", "DecodeEngine", "DecodeStream",
    "KVCacheConfig", "KVCacheFull", "PagedKVCache",
    "FleetConfig", "FleetRouter", "RequestShed", "ReplicaUnavailable",
    "ServingHTTPServer", "serve", "start_http_server",
]
