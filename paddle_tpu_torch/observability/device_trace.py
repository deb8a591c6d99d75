"""Device time by phase: a ``torch.profiler`` trace of a step folded into
the step profiler's phases, and its agreement with the host numbers.

Counterpart of ``paddle_tpu/observability/device_trace.py``. The JAX
package reads an XPlane capture (its protobuf reader and writer,
``parse_xspace`` / ``encode_xspace``); the port reads the chrome trace
that ``torch.profiler`` writes (CUPTI on the card):

**Capture** (``capture_torch_trace`` / ``device_profile_step``). The step
runs with phase annotation armed (each op of the walk inside a
``torch.profiler.record_function("<phase>/<op_type>")`` range, from
``profiler.trace_annotation``), once outside the trace, then ``steps``
times inside it. The traced runs are eager walks: a CUDA graph replay
launches the graph, not the ops, so its kernels come under no op's range
(the host numbers of ``profile_step`` time the replays).

**Events** (``kernel_events``). Each kernel record of the trace (cat
``kernel``) is tied by its correlation id to the runtime call that
launched it (cat ``cuda_runtime`` / ``cuda_driver``), and that call to the
phase-labelled range around it on its thread, or else to the range that
holds it in time on another thread of the process (a grad op's backward
runs on autograd's device thread while the walk waits in the op's
range): the kernel's ``range``.

**Fold** (``fold_device_phases``). A kernel's phase is the first path
component of its range that names a phase (``phase_of_op_name``), else of
its own name. Per-phase device time is the union of the phase's kernel
intervals (concurrent kernels count once); the overlap of collective and
compute and the busy critical path come from the host profiler's
``analyze_timeline``. Kernels with no phase count as ``unattributed_ms``;
a trace with no phase-attributed kernel folds to None, and the caller
keeps the host numbers. The fold counts the kernel records it saw
(``kernel_records``), and ``device_profile_step`` adds the launches the
port's own kernels counted in the traced window (``launches``, from
``ops/cuda/support.launch_counts``) beside the records of those kernels
(``own_kernel_records``): CUPTI has read a kernel's device time under its
bytes bound before (``PERF.md``), so both are printed.

**Cross-check** (``cross_check``). Per-phase agreement
``min(host, device) / max(host, device)`` and a duration-weighted
overall ``agreement``, the JAX package's.

``PADDLE_TPU_DEVICE_TRACE=1`` adds this profile to every sampled capture
(``capture.maybe_sample_step``, under ``PADDLE_TPU_SAMPLE_EVERY``), beside
its host phases with their agreement; unset, one env read a sample.
"""
from __future__ import annotations

import bisect
import json
import os
import shutil
import tempfile
from typing import Dict, List, Optional

__all__ = ["PHASES", "capture_enabled", "capture_torch_trace",
           "kernel_events", "phase_of_op_name", "fold_device_phases",
           "cross_check", "device_profile_step", "OWN_KERNELS"]

PHASES = ("forward", "backward", "collective", "optimizer")

# the port's kernels: a fragment of each __global__ symbol -> its launch
# counter (ops/cuda/*)
OWN_KERNELS = {
    "flash_fwd_kernel": "flash_attention_forward",
    "flash_bwd_dq_kernel": "flash_attention_backward_dq",
    "flash_bwd_dkv_kernel": "flash_attention_backward_dkv",
    "fused_update_kernel": "fused_optimizer_update",
    "conv2d_bn_act_kernel": "conv2d_bn_act",
    "paged_kernel": "paged_decode_attention",
    "add_one_kernel": "probe_add_one",
    "set_conditional_kernel": "graph_conditional",
}


def capture_enabled(default: bool = False) -> bool:
    """The ``PADDLE_TPU_DEVICE_TRACE`` switch; unset keeps the caller's
    default."""
    raw = os.environ.get("PADDLE_TPU_DEVICE_TRACE", "").strip().lower()
    if not raw:
        return bool(default)
    return raw in ("1", "true", "yes", "on")


def phase_of_op_name(op_name) -> Optional[str]:
    """The first path component of a range name that names a phase
    (``"backward/mul_grad"`` -> ``"backward"``); None otherwise."""
    if not op_name:
        return None
    for part in str(op_name).split("/"):
        if part in PHASES:
            return part
    return None


# -- the trace's kernel records ---------------------------------------------

def kernel_events(doc: Dict) -> List[Dict]:
    """The kernel records of a ``torch.profiler`` chrome trace, each
    ``{"name", "ts_us", "dur_us", "range"}``: ``range`` is the
    phase-labelled range around the runtime call that launched it, on
    that call's thread (None when there is none)."""
    evs = doc.get("traceEvents") or []
    launches = {}
    ranges: Dict[tuple, List] = {}
    kernels = []
    for ev in evs:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        if cat == "kernel":
            kernels.append(ev)
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = (ev.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = ev
        elif cat == "user_annotation" and phase_of_op_name(ev.get("name")):
            key = (ev.get("pid"), ev.get("tid"))
            ranges.setdefault(key, []).append(
                (float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0)),
                 ev["name"]))
    # a launch from another thread of the process (autograd's device
    # thread runs a grad op's backward while the walk's thread waits in
    # its range) takes the range that holds it in time
    by_pid: Dict = {}
    for (pid, _tid), rs in ranges.items():
        by_pid.setdefault((pid, None), []).extend(rs)
    ranges.update(by_pid)
    starts = {}
    for key, rs in ranges.items():
        rs.sort()
        starts[key] = [r[0] for r in rs]

    def holding(key, t):
        rs = ranges.get(key)
        if rs:
            i = bisect.bisect_right(starts[key], t) - 1
            if i >= 0 and rs[i][0] <= t <= rs[i][1]:
                return rs[i][2]
        return None

    out = []
    for ev in kernels:
        rng = None
        call = launches.get((ev.get("args") or {}).get("correlation"))
        if call is not None:
            t = float(call["ts"])
            rng = holding((call.get("pid"), call.get("tid")), t) or \
                holding((call.get("pid"), None), t)
        out.append({"name": ev.get("name", ""), "ts_us": float(ev["ts"]),
                    "dur_us": float(ev.get("dur", 0)), "range": rng})
    return out


def capture_torch_trace(run, trace_dir: Optional[str] = None) -> List[Dict]:
    """Run ``run()`` under ``torch.profiler`` (CPU and, with a card, CUDA
    activity) and return its kernel records (``kernel_events``). The
    chrome trace stays in ``trace_dir`` when one is given; a scratch one
    is removed once read."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    d = trace_dir or tempfile.mkdtemp(prefix="ptt_devtrace_")
    path = os.path.join(d, "trace.json")
    try:
        with torch.profiler.profile(activities=acts) as prof:
            run()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path, "r", encoding="utf-8") as f:
            return kernel_events(json.load(f))
    finally:
        if trace_dir is None:
            shutil.rmtree(d, ignore_errors=True)


# -- phase folding -------------------------------------------------------------

def fold_device_phases(events: List[Dict], steps: int = 1) -> Optional[Dict]:
    """Per-phase device time of the kernel records ``events`` (each
    ``{"name", "ts_us", "dur_us"}`` with its ``range`` or ``phase``), over
    ``steps`` steps: the union of each phase's intervals, and the overlap
    and critical path of ``analyze_timeline``. None when no record has a
    phase."""
    from .profiler import _union_length, analyze_timeline

    steps = max(1, int(steps))
    spans = []   # (phase, ts_ms, dur_ms)
    unattributed_us = 0.0
    n_attr = 0
    for ev in events:
        phase = ev.get("phase") or phase_of_op_name(ev.get("range")) \
            or phase_of_op_name(ev.get("name"))
        if phase is None:
            unattributed_us += float(ev.get("dur_us") or 0.0)
            continue
        n_attr += 1
        spans.append((phase, float(ev["ts_us"]) / 1e3,
                      float(ev["dur_us"]) / 1e3))
    if not spans:
        return None
    tl = analyze_timeline(spans)
    phase_ms: Dict[str, float] = {}
    for ph in sorted({s[0] for s in spans}):
        phase_ms[ph] = _union_length(
            [(ts, ts + dur) for p, ts, dur in spans if p == ph]) / steps
    return {
        "device_phase_ms": phase_ms,
        "overlap_frac": tl["overlap_frac"],
        "critical_path_ms": tl["critical_path_ms"] / steps,
        "compute_ms": tl["compute_ms"] / steps,
        "collective_ms": tl["collective_ms"] / steps,
        "exposed_collective_ms": tl["exposed_collective_ms"] / steps,
        "unattributed_ms": unattributed_us / 1e3 / steps,
        "n_events": len(events),
        "n_attributed": n_attr,
        "kernel_records": len(events),
        "steps": steps,
        "source": "torch.profiler",
    }


def cross_check(host_phase_ms: Dict, device_phase_ms: Dict) -> Dict:
    """Per-phase agreement of the host breakdown and the device one,
    ``min / max`` (1.0 agrees, 0 one side missing), and the
    duration-weighted overall ``agreement``. The host ``collective`` is
    the serial microbench's time where the device measures the actual
    (overlapped) intervals: a gap there is a reading, not an error."""
    per: Dict[str, Dict] = {}
    num = den = 0.0
    for ph in sorted(set(host_phase_ms or {}) | set(device_phase_ms or {})):
        h = float((host_phase_ms or {}).get(ph) or 0.0)
        d = float((device_phase_ms or {}).get(ph) or 0.0)
        hi = max(h, d)
        ratio = (min(h, d) / hi) if hi > 0 else 1.0
        per[ph] = {"host_ms": h, "device_ms": d, "agreement": ratio}
        num += ratio * hi
        den += hi
    return {"per_phase": per,
            "agreement": (num / den) if den else None}


def _emit_device_profile(dev: Dict, agreement=None) -> None:
    from .. import observability as _obs

    if not _obs.enabled():
        return
    for phase, ms in dev["device_phase_ms"].items():
        _obs.observe("profile.device_phase_ms", ms, phase=phase)
    if dev["overlap_frac"] is not None:
        _obs.set_gauge("profile.device_overlap_frac", dev["overlap_frac"])
    _obs.set_gauge("profile.device_critical_path_ms",
                   dev["critical_path_ms"])
    if agreement is not None:
        _obs.set_gauge("profile.host_device_agreement", agreement)


# -- one call: the device profile of a program ---------------------------------

def device_profile_step(program, scope, feed, mesh=None,
                        axis_name: str = "dp", steps: int = 3,
                        trace_dir: Optional[str] = None,
                        seed: int = 0) -> Optional[Dict]:
    """The folded device-phase report of ``steps`` eager runs of a
    runnable program (``profiler.profile_step``'s contract: its startup
    run, its rewrites applied; its state read, never written). Phase
    annotation is armed for the profile's step functions and put back
    after. None when the trace holds no phase-attributed kernel (the CPU
    has none)."""
    from . import profiler

    was_on = profiler.annotating()
    profiler.enable_annotation()
    ctx = None
    try:
        ctx = profiler._exec_inputs(program, scope, feed, mesh=mesh,
                                    axis_name=axis_name)
        fn = ctx["make_fn"](list(range(len(ctx["ops"]))))
        core = ctx["core"]

        def eager():
            core.warm.clear()   # an unwarmed key runs eagerly
            fn()

        eager()   # builds the step, handles and kernels outside the trace
        before = profiler._own_launches()

        def run():
            for _ in range(max(1, steps)):
                eager()

        events = capture_torch_trace(run, trace_dir)
        after = profiler._own_launches()
    finally:
        if ctx is not None:
            ctx["core"].close()
        if not was_on:
            profiler.disable_annotation()
    dev = fold_device_phases(events, steps=steps)
    if dev is None:
        return None
    launches = {k: after.get(k, 0) - before.get(k, 0) for k in after
                if after.get(k, 0) - before.get(k, 0)}
    own = {}
    for ev in events:
        for frag, counter in OWN_KERNELS.items():
            if frag in ev["name"]:
                own[counter] = own.get(counter, 0) + 1
    dev["launches"] = launches
    dev["own_kernel_records"] = own
    _emit_device_profile(dev)
    return dev
