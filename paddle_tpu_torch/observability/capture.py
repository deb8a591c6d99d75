"""Sampled capture in a running job: ``PADDLE_TPU_SAMPLE_EVERY=N``.

Counterpart of ``paddle_tpu/observability/capture.py``. Every Nth
successful step of an engine (``Executor.run``'s compiled route, the
data-parallel engine) runs the step profiler (``profiler.profile_step``)
on the program, scope and feeds it just ran, and rolls the report into
``$PADDLE_TPU_METRICS_DIR``: one ``<role>-<rank>.profile.json`` a process
(replaced atomically, the newest sample wins) with a bounded history of
compact summaries.

- Off by default: ``PADDLE_TPU_SAMPLE_EVERY`` unset or 0 makes the hook
  one memoized int load and a branch.
- A capture never breaks a step: a failure is counted in
  ``capture.errors{engine=}`` and recorded in the flight ring (the JAX
  package's library contract; a caller that must not miss one reads the
  counter).
- ``PADDLE_TPU_DEVICE_TRACE=1`` adds the sample's device profile
  (``device_trace.device_profile_step``, one traced eager walk) to its
  report: device phase ms and their agreement with the host's.
- The report does not carry the process-dump schema:
  ``distributed.load_dumps`` skips it, ``load_sampled_profiles`` reads it.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional

__all__ = ["sample_every", "sampling_enabled", "maybe_sample_step",
           "SAMPLED_PROFILE_SCHEMA", "HISTORY_CAP", "rearm", "history"]

SAMPLED_PROFILE_SCHEMA = "sampled_profile_v1"
HISTORY_CAP = 32
# the step profiler's budget for one sampled capture (``profile_step``'s
# ``budget_s``), and the traced eager walks of its device profile
SAMPLE_BUDGET_S = 20.0
SAMPLE_TRACE_STEPS = 1

# memoized knob: None = env not read yet, 0 = off, N>0 = every Nth step.
# A single module-global load keeps the disabled hook sub-µs.
_SAMPLE_EVERY: Optional[int] = None

_lock = threading.Lock()
_counts: Dict[str, int] = {}       # engine kind -> steps seen
_history: Dict[str, list] = {}     # engine kind -> compact summaries


def sample_every() -> int:
    """``PADDLE_TPU_SAMPLE_EVERY`` as a non-negative int (0 = off),
    read once and memoized."""
    global _SAMPLE_EVERY
    n = _SAMPLE_EVERY
    if n is None:
        raw = os.environ.get("PADDLE_TPU_SAMPLE_EVERY", "").strip()
        try:
            n = max(0, int(raw)) if raw else 0
        except ValueError:
            n = 0
        _SAMPLE_EVERY = n
    return n


def history(kind: str) -> list:
    """The compact summaries of an engine's samples so far (the newest
    ``HISTORY_CAP``), with or without a metrics dir."""
    with _lock:
        return list(_history.get(kind, ()))


def sampling_enabled() -> bool:
    return sample_every() > 0


def rearm() -> int:
    """Read ``PADDLE_TPU_SAMPLE_EVERY`` again (it is memoized at the first
    step) and start each engine's count afresh; returns N."""
    _reset_for_tests()
    return sample_every()


def _reset_for_tests() -> None:
    global _SAMPLE_EVERY
    with _lock:
        _SAMPLE_EVERY = None
        _counts.clear()
        _history.clear()


def maybe_sample_step(kind: str, program=None, scope=None, feed=None,
                      mesh=None, axis_name: str = "dp"
                      ) -> Optional[Dict]:
    """The hook the engines call after a successful step. Off: one global
    load and a branch. On: every Nth call a ``kind`` profiles the
    (program, scope, feed) just run and rolls the report into the metrics
    dir. Returns the report on a sampled step, else None."""
    n = _SAMPLE_EVERY
    if n is None:
        n = sample_every()
    if not n:
        return None
    if program is None or scope is None or feed is None:
        return None
    with _lock:
        c = _counts.get(kind, 0) + 1
        _counts[kind] = c
    if c % n:
        return None
    try:
        return _capture(kind, c, program, scope, feed, mesh, axis_name)
    except Exception as e:  # a broken capture must never break a step
        from . import inc as _inc
        from . import flight as _flight

        _inc("capture.errors", engine=kind)
        _flight.record("capture.error", engine=kind, step=c,
                       error="%s: %s" % (type(e).__name__, e))
        return None


def _capture(kind, step, program, scope, feed, mesh, axis_name):
    from . import device_trace as _dtr
    from . import inc as _inc
    from . import flight as _flight
    from . import profiler as _prof

    t0 = time.monotonic()
    report = _prof.profile_step(program, scope, feed, mesh=mesh,
                                axis_name=axis_name, repeats=1,
                                budget_s=SAMPLE_BUDGET_S, max_bucket_cuts=6)
    if _dtr.capture_enabled():
        _device_block(report, program, scope, feed, mesh, axis_name)
    capture_ms = (time.monotonic() - t0) * 1e3
    _inc("capture.samples", engine=kind)
    _flight.record("capture.sampled", engine=kind, step=step,
                   capture_ms=round(capture_ms, 3),
                   step_ms=report.get("step_ms"),
                   overlap_frac=report.get("overlap_frac"))
    try:
        # the sampled phases join the process's trace and gauges
        _prof._emit_profile(report)
    except Exception:
        # the report is still good; only its echo failed
        _inc("capture.emit_errors", engine=kind)
    _write_rolling_report(kind, step, report, capture_ms)
    return report


def _device_block(report, program, scope, feed, mesh, axis_name):
    """``PADDLE_TPU_DEVICE_TRACE``: the sample's device profile
    (``device_trace.device_profile_step``) joins its report beside the host
    phases, with their agreement, as the JAX package's bench records carry
    it. An empty trace (no phase-attributed kernel: the CPU) leaves the host
    numbers alone and says so, as does a live ``fluid.profiler`` session,
    whose ``torch.profiler`` holds the trace; a failed one fails the
    capture (``capture.errors``)."""
    from . import device_trace as _dtr
    from . import profiler as _prof

    if _prof._torch_prof is not None:
        report["device_trace"] = {"status": "skipped",
                                  "reason": "a profiler session is live"}
        return
    dev = _dtr.device_profile_step(program, scope, feed, mesh=mesh,
                                   axis_name=axis_name,
                                   steps=SAMPLE_TRACE_STEPS)
    if dev is None:
        report["device_trace"] = {"status": "empty", "fallback": "host"}
        return
    cc = _dtr.cross_check(report.get("phase_ms") or {},
                          dev["device_phase_ms"])
    report.update({
        "device_phase_ms": dev["device_phase_ms"],
        "device_overlap_frac": dev["overlap_frac"],
        "device_critical_path_ms": dev["critical_path_ms"],
        "device_exposed_collective_ms": dev["exposed_collective_ms"],
        "host_device_agreement": cc["agreement"],
        "agreement_per_phase": cc["per_phase"],
        "device_trace": {k: dev[k] for k in (
            "n_events", "n_attributed", "unattributed_ms", "kernel_records",
            "steps", "source", "launches", "own_kernel_records")},
    })


def _summary(step, report, capture_ms):
    out = {"step": step, "wrote_at": time.time(),
           "capture_ms": round(capture_ms, 3)}
    for k in ("step_ms", "overlap_frac", "critical_path_ms",
              "exposed_collective_ms", "feed_ms", "optimizer_ms",
              "host_device_agreement"):
        v = report.get(k)
        if isinstance(v, (int, float)):
            out[k] = v
    if report.get("launches"):
        out["launches"] = dict(report["launches"])
    dev_launches = (report.get("device_trace") or {}).get("launches")
    if dev_launches:
        out["device_launches"] = dict(dev_launches)
    return out


def _write_rolling_report(kind, step, report, capture_ms) -> None:
    from .distributed import metrics_dir, process_identity
    from . import timeseries as _ts
    from ..checkpoint import atomic_write_bytes
    import json

    d = metrics_dir()
    with _lock:
        hist = _history.setdefault(kind, [])
        summary = _summary(step, report, capture_ms)
        hist.append(summary)
        del hist[:-HISTORY_CAP]
    if not d:
        return
    role, rank, restart = process_identity()
    base = "%s-%d" % (role, rank)
    if restart:
        base += ".r%d" % restart
    if _ts.series_enabled():
        # the sampled numbers join the windowed series
        for k, v in summary.items():
            if k in ("step", "wrote_at"):
                continue
            if isinstance(v, (int, float)):
                _ts.record_point("capture.%s{engine=%s}" % (k, kind),
                                 v, wall_ts=summary["wrote_at"])
    with _lock:
        doc = {
            "schema": SAMPLED_PROFILE_SCHEMA,
            "proc": base,
            "role": role, "rank": rank, "restart": restart,
            "engine": kind,
            "step": step,
            "sample_every": sample_every(),
            "samples": len(hist),
            "wrote_at": time.time(),
            "profile": report,
            "history": list(hist),
        }
    try:
        os.makedirs(d, exist_ok=True)
        atomic_write_bytes(
            os.path.join(d, base + ".profile.json"),
            json.dumps(doc, default=str).encode())
    except OSError:
        pass
