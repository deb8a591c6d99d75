"""``fluid.profiler``: the reference's session API, re-exported from
``observability/profiler.py`` (counterpart of ``paddle_tpu/profiler.py``).

The objects are the observability ones (``_last_trace`` is the same list,
so a session's snapshot and ``observability.reset()`` agree)::

    with fluid.profiler.profiler("All", "total", "/path/trace.json"):
        for batch in batches:
            exe.run(main, feed=batch, fetch_list=[loss])

prints each event's calls, host and device times, then the kernels by
device time; on a card the ``torch.profiler`` session's chrome trace goes
to the path given.
"""
from __future__ import annotations

from .observability.profiler import (  # noqa: F401
    RecordEvent, _last_trace, cuda_profiler, device_kernels,
    get_trace_events, is_profiler_enabled, profiler, record_event,
    reset_profiler, start_profiler, stop_profiler)

__all__ = ["cuda_profiler", "reset_profiler", "profiler", "start_profiler",
           "stop_profiler"]
