"""Step profiler: phase classification and annotation, the measured
phase breakdown of a step, the timeline analyzer, analytic FLOPs, and the
``fluid.profiler`` session API.

Counterpart of ``paddle_tpu/observability/profiler.py``. The pure half
(``classify_ops:113``, ``analyze_timeline:228``, ``build_phase_plan:294``,
``op_flops:1044``, ``program_flops:1074``, the ``flops_*`` formulas) keeps
the JAX package's code and answers. The rest is the torch form:

**Phase classification** (``classify_ops``). Each op of a program lands
in one phase: ``forward`` (before the first grad op), ``backward`` (grad
ops, up to the optimizer), ``collective`` (the ``c_*`` ops, each bucket
numbered) or ``optimizer`` (the update ops and what follows them).

**Phase annotation** (``trace_annotation``). Armed by
``PADDLE_TPU_PROFILE=1`` or ``enable_annotation()``, every step function
built from then on (``core/compiler_engine._Block``, which the executor,
the data-parallel engine and the pipeline run) wraps each op of its walk
in ``torch.profiler.record_function("<phase>/<op_type>")``, so a
``torch.profiler`` trace shows phase-labelled ranges and the kernels each
launched (``observability/device_trace.py`` folds them). Disarmed, a
step function carries no labels and its walk pays one branch a run. A
captured step records the ranges once, at its capture: its replays launch
the graph, not the ops, so the device trace times eager walks.

**Measured phase breakdown** (``profile_step``). Each cut of the phase
plan (end of forward, each bucket's availability point, end of backward,
end of program) is a prefix of the collective-free op sequence, run as
its own step on the port's route (a clone of the program cut to the
prefix): on the card captured into a CUDA graph and its replays timed
with CUDA events, on the CPU its eager walk timed by the host clock. A
segment's time is the difference of adjacent prefixes. The full program
against the collective-free one gives the exposed collective time, and a
psum over the data axes at each bucket's payload its serial time::

    overlap_frac      = 1 - exposed / serial
    critical_path_ms  = compute + exposed

Profiling never moves the training state: every run reads and writes
clones of the state in a scratch scope, on an executor core of its own
(its own graph pool, freed when the profile ends; the executor's
eight-graph cache would evict the training step's graph). Each prefix's
graph is dropped once timed, so the peak holds one. The report carries
``peak_bytes``.

The numbers go out as ``profile.phase_ms{phase=}`` histograms, the
``profile.overlap_frac`` / ``profile.critical_path_ms`` gauges and
chrome-trace rows (cat ``phase``) in the span buffer.

**Timeline analyzer** (``analyze_timeline``). Given any span timeline, the
per-bucket overlap and the busy-time critical path.

**FLOPs** (``program_flops``). Analytic FLOPs of each op from the block's
shapes (grad ops twice their forward op: a training step is three times
its forward), normalized by ``peak_flops``: an NVIDIA H100 80GB HBM3's
dense tensor-core peaks (power limit 700 W), bf16 989 TFLOP/s and, for
float32, the 3xTF32 route's 494.7 / 3 TFLOP/s (the port's float32 GEMMs
keep TF32 off; K1-K3 and K5 take three TF32 products a product).

**Sessions** (``start_profiler`` / ``stop_profiler`` / ``profiler`` /
``cuda_profiler`` / ``RecordEvent``): the reference's ``fluid.profiler``.
A session collects the host spans (``tracing``) and prints the per-event
table at its stop. With ``state`` ``"GPU"`` or ``"All"`` and a card, it
also runs a ``torch.profiler`` session with CUDA activity: the table then
gives each event's device time beside its host time, and lists the
kernels by device time (``device_kernels()`` returns those rows); a
``profile_path`` other than the default gets the session's chrome trace.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    # phase classification / annotation
    "classify_ops", "enable_annotation", "disable_annotation",
    "annotating", "trace_annotation",
    # measured profiling + analysis
    "build_phase_plan", "profile_step", "analyze_timeline",
    # FLOP accounting
    "op_flops", "program_flops", "flops_mlp", "flops_transformer_lm",
    "peak_flops", "mfu_est",
    # the fluid.profiler session API
    "RecordEvent", "record_event", "is_profiler_enabled",
    "get_trace_events", "reset_profiler", "start_profiler",
    "stop_profiler", "profiler", "cuda_profiler", "device_kernels",
]

# the update op types: the boundary between backward and optimizer
# (``fused_optimizer`` carries a whole optimizer instance)
OPTIMIZER_OPS = frozenset({
    "sgd", "momentum", "lars_momentum", "adam", "adamw", "adamax",
    "adagrad", "decayed_adagrad", "adadelta", "rmsprop", "ftrl", "lamb",
    "dpsgd", "dgc", "dgc_momentum", "dgc_clip_by_norm", "proximal_gd",
    "proximal_adagrad", "lookahead_update", "ema_accumulate",
    "ema_adaptive_decay", "model_average_accumulate", "fused_optimizer",
})

# collectives a collective-free run may leave out: in place (their outputs
# rebind their inputs' names) and of the same shape, so the rest runs
_SKIP_SAFE_COLLECTIVES = ("c_allreduce", "c_bucket_allreduce",
                          "c_sharded_update", "c_broadcast")


def _itemsize(dtype) -> int:
    if str(dtype) in ("bfloat16", "float16"):
        return 2
    try:
        return np.dtype(str(dtype)).itemsize
    except TypeError:
        return 4


# -- phase classification ---------------------------------------------------


def classify_ops(block, ops=None) -> List[str]:
    """Phase label per op: forward | backward | collective | optimizer.

    Positional: forward until the first grad op (``_fwd_op_id`` attr or
    an ``@GRAD`` output), backward until the first optimizer op,
    optimizer after. ``c_*`` collectives are always ``collective``.
    """
    from ..core.registry import GRAD_SUFFIX

    ops = list(block.ops) if ops is None else list(ops)
    phases: List[str] = []
    seen_bwd = False
    seen_opt = False
    for op in ops:
        t = op.type
        if t.startswith("c_"):
            phases.append("collective")
            continue
        if t in OPTIMIZER_OPS:
            seen_opt = True
            phases.append("optimizer")
            continue
        if not seen_opt and ("_fwd_op_id" in op.attrs or any(
                GRAD_SUFFIX in n for n in op.output_arg_names if n)):
            seen_bwd = True
            phases.append("backward")
            continue
        phases.append("optimizer" if seen_opt
                      else ("backward" if seen_bwd else "forward"))
    return phases


# -- phase annotation (record_function ranges in the step walk) --------------

_annotating = os.environ.get("PADDLE_TPU_PROFILE", "").lower() in (
    "1", "true", "yes", "on")


def annotating() -> bool:
    return _annotating


def enable_annotation() -> None:
    """Arm phase annotation: step functions built from now on label each
    op of their walk. Steps already built keep none (a new program
    version, or a new executor, builds labelled ones)."""
    global _annotating
    _annotating = True


def disable_annotation() -> None:
    global _annotating
    _annotating = False


def trace_annotation(block, ops) -> Optional[List[str]]:
    """Each op's ``"<phase>/<op_type>"`` label for the step walk, or None
    when annotation is off (the one branch a disarmed build pays)."""
    if not _annotating:
        return None
    try:
        return ["%s/%s" % (ph, op.type)
                for ph, op in zip(classify_ops(block, ops), ops)]
    except Exception:
        return None


# -- timeline analyzer (pure) -----------------------------------------------


def _union_length(intervals: List[Tuple[float, float]]) -> float:
    total = 0.0
    end = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _intersect_length(a0: float, a1: float,
                      merged: List[Tuple[float, float]]) -> float:
    got = 0.0
    for b0, b1 in merged:
        lo, hi = max(a0, b0), min(a1, b1)
        if hi > lo:
            got += hi - lo
    return got


def _merge(intervals: List[Tuple[float, float]]):
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def analyze_timeline(spans) -> Dict:
    """Overlap / critical-path analysis over a span timeline.

    ``spans``: iterable of dicts (``{"phase", "ts", "dur"[, "bucket"]}``)
    or tuples ``(phase, ts, dur[, bucket])``; times in any consistent
    unit (reported as ms). Phases ``forward|backward|optimizer`` (or
    anything else non-collective) count as compute; ``collective``
    spans are the ones whose hidden fraction is measured against the
    compute union. Returns::

        {compute_ms, collective_ms, overlapped_collective_ms,
         exposed_collective_ms, overlap_frac, critical_path_ms,
         serialized_ms, per_bucket: [{bucket, collective_ms,
                                      overlapped_ms, overlap_frac}]}

    ``critical_path_ms`` is the busy time (union of all spans) — on a
    serialized timeline it equals ``serialized_ms``; every unit of
    collective time hidden under compute shortens it by one unit.
    """
    comp: List[Tuple[float, float]] = []
    coll: List[Tuple[float, float, object]] = []
    for sp in spans:
        if isinstance(sp, dict):
            phase = sp.get("phase") or sp.get("cat") or "compute"
            ts, dur = float(sp["ts"]), float(sp["dur"])
            bucket = sp.get("bucket")
        else:
            phase, ts, dur = sp[0], float(sp[1]), float(sp[2])
            bucket = sp[3] if len(sp) > 3 else None
        if dur < 0:
            raise ValueError("span with negative duration: %r" % (sp,))
        if phase == "collective":
            coll.append((ts, ts + dur, bucket))
        else:
            comp.append((ts, ts + dur))
    merged_comp = _merge(comp)
    compute_ms = _union_length(comp)
    per_bucket = []
    coll_total = 0.0
    overlapped = 0.0
    for i, (a, b, bucket) in enumerate(coll):
        dur = b - a
        got = _intersect_length(a, b, merged_comp)
        coll_total += dur
        overlapped += got
        per_bucket.append({
            "bucket": bucket if bucket is not None else i,
            "collective_ms": dur, "overlapped_ms": got,
            "overlap_frac": (got / dur) if dur else 0.0,
        })
    busy = _union_length(comp + [(a, b) for a, b, _ in coll])
    return {
        "compute_ms": compute_ms,
        "collective_ms": coll_total,
        "overlapped_collective_ms": overlapped,
        "exposed_collective_ms": coll_total - overlapped,
        "overlap_frac": (overlapped / coll_total) if coll_total else None,
        "critical_path_ms": busy,
        "serialized_ms": compute_ms + coll_total,
        "per_bucket": per_bucket,
    }


# -- measured phase profiling ----------------------------------------------


def build_phase_plan(program, max_bucket_cuts: int = 12,
                     state=None) -> Dict:
    """Static plan for phase-sliced timing of ``program``:

    - ``phases``: per-op labels (classify_ops);
    - ``collectives``: [{index, type, bucket, bytes, numel, dtype,
      kind}] for every collective op, payloads resolved through the
      same size resolver the bucket planner uses;
    - ``cuts``: [(label, n_compute_ops)] cumulative cut points over
      the collective-free op sequence — end-of-forward, one per bucket
      availability point (capped at ``max_bucket_cuts``), end-of-
      backward, end-of-program;
    - ``skippable``: True when every collective is in-place (the
      collective-free timing run is exact).
    """
    from ..ops.collective_ops import QUANT_PSUM_ITEMSIZE
    from ..parallel.collectives import _numel_and_dtype as numel_and_dtype

    block = program.global_block()
    ops = list(block.ops)
    phases = classify_ops(block, ops)

    collectives = []
    skippable = True
    bucket_no = 0
    for i, (op, ph) in enumerate(zip(ops, phases)):
        if ph != "collective":
            continue
        if op.type == "c_bucket_allreduce_await":
            # the await half of an async pair carries no wire payload
            # (its start op is the bucket entry) and is skip-safe by
            # construction — removing the pair removes both halves
            continue
        if not any(op.type.startswith(p) for p in _SKIP_SAFE_COLLECTIVES):
            skippable = False
        if op.type == "c_sharded_update":
            padded = int(op.attrs.get("padded_size", 0))
            pname = op.input("Param")[0] if op.input("Param") else None
            _, dtype = numel_and_dtype(block, state, pname) \
                if pname else (None, "float32")
            item = _itemsize(dtype)
            q = QUANT_PSUM_ITEMSIZE.get(op.attrs.get("quant", "none"))
            collectives.append({
                "index": i, "type": op.type, "bucket": bucket_no,
                "numel": padded, "dtype": dtype, "kind": "sharded_update",
                # one psum (at the executed quant width) + one allgather
                "bytes": padded * (q or item) + padded * item,
                # psum-equivalent elements at the native dtype (the
                # psum dominates; int32-emulated int8 = native width)
                "bench_numel": max(1, int(padded * (q or item) / item)),
                "avail_pos": None,  # filled below
            })
            bucket_no += 1
            continue
        numel = 0
        dtype = "float32"
        is_bucket = op.type.startswith("c_bucket_allreduce")
        # bucket payload = the X members only (an error-feedback
        # Residual input is device-local state, not wire traffic)
        payload_names = op.input("X") if is_bucket \
            else op.input_arg_names
        for n in payload_names:
            if not n:
                continue
            k, dtype = numel_and_dtype(block, state, n)
            numel += k or 0
        item = _itemsize(dtype)
        base_item = item
        if is_bucket:
            q = QUANT_PSUM_ITEMSIZE.get(op.attrs.get("quant", "none"))
            item = q or item
        collectives.append({
            "index": i, "type": op.type, "bucket": bucket_no,
            "numel": numel, "dtype": dtype,
            # what the serial microbench should move: the EXECUTED
            # wire width (bf16 psums half the f32 bytes; int8 codes
            # psum in int32 = no change) expressed as an equivalent
            # element count at the native dtype
            "bench_numel": max(1, int(numel * item / base_item)),
            "kind": ("allreduce" if "allreduce" in op.type
                     else op.type[2:]),
            "bytes": numel * item,
            # placement-search fitter fields: which spelling and wire
            # mode this measured point belongs to
            "strategy": op.attrs.get("strategy", "ring")
            if is_bucket else "ring",
            "quant": op.attrs.get("quant", "none"),
            "avail_pos": None,  # filled below
        })
        bucket_no += 1

    # compute-only sequence + cumulative cut points
    compute_pos = []           # original index -> compute-seq index
    n_compute = 0
    for ph in phases:
        compute_pos.append(n_compute)
        if ph != "collective":
            n_compute += 1
    fwd_end = sum(1 for ph in phases if ph == "forward")
    bwd_end = sum(1 for ph in phases if ph in ("forward", "backward"))
    for c in collectives:
        # availability point: the compute prefix that must have run
        # for this bucket's payload to exist (the bucket op sits right
        # after its anchor — collectives.plan_buckets hoisted it
        # there). EVERY collective gets one, whether or not it also
        # becomes a timing cut below — the overlap report keys on the
        # position, never on cut labels
        c["avail_pos"] = min(bwd_end, compute_pos[c["index"]])
    cuts: List[Tuple[str, int]] = [("forward", fwd_end)]
    for c in collectives[:max_bucket_cuts]:
        cuts.append(("backward@bucket%d" % c["bucket"], c["avail_pos"]))
    cuts.append(("backward", bwd_end))
    cuts.append(("optimizer", n_compute))
    # dedupe while keeping order + monotonicity
    seen: Dict[int, str] = {}
    ordered = []
    for label, pos in sorted(cuts, key=lambda kv: kv[1]):
        if pos in seen or pos == 0:
            continue
        seen[pos] = label
        ordered.append((label, pos))
    return {"phases": phases, "collectives": collectives,
            "cuts": ordered, "n_compute": n_compute,
            "skippable": skippable}


# -- measured phase profiling --------------------------------------------------

def _state_device(program, scope):
    """The device of the program's state in ``scope`` (the CPU when it
    holds none)."""
    import torch

    from ..core.compiler_engine import _analyze, _scope_tensor

    read_first, _, _ = _analyze(program)
    for n in sorted(read_first):
        t = _scope_tensor(scope, n)
        if isinstance(t, torch.Tensor):
            return t.device
    return torch.device("cpu")


def _scratch_scope(program, scope, feed_names):
    """A scope holding clones of every state var the program reads: what
    the profile's runs read and write."""
    import torch

    from ..core.compiler_engine import _analyze, _scope_tensor
    from ..core.scope import Scope
    from ..core.tensor import LoDTensor

    read_first, _, persist_written = _analyze(program)
    scratch = Scope()
    for n in sorted((read_first | persist_written) - set(feed_names)):
        t = _scope_tensor(scope, n)
        if t is None:
            if n in read_first:
                raise RuntimeError("var %r must be fed or initialized "
                                   "before profiling" % n)
            continue
        if isinstance(t, torch.Tensor):
            scratch.var(n).set(LoDTensor(t.clone()))
    return scratch


def _sub_program(program, keep):
    """A clone of ``program`` whose global block holds the ops at the
    indices ``keep``, with the program's pass state (shard specs, data
    axes, the rewrites' done-flags), so that the engine does not rewrite
    it again."""
    sub = program.clone()
    block = sub.global_block()
    block.ops = [block.ops[i] for i in keep]
    for k, v in program.__dict__.items():
        if k not in sub.__dict__:
            setattr(sub, k, v)
    return sub


def _exec_inputs(program, scope, feed: Dict, mesh=None,
                 axis_name: str = "dp", build_strategy=None) -> Dict:
    """What a measurement needs to run ``program`` as its engine does: the
    ops, the staged feeds, a scratch scope of cloned state, and
    ``make_fn(indices) -> run`` (one step of the sub-program of those
    ops, on an executor core of the profile's own). Shared by
    ``profile_step`` and ``device_trace.device_profile_step``."""
    from ..core.compiler_engine import _analyze, _stage_feeds
    from ..core.executor_core import CoreExecutor

    block = program.global_block()
    ops = list(block.ops)
    feed_vals = _stage_feeds(feed or {})
    device = _state_device(program, scope)
    scratch = _scratch_scope(program, scope, feed_vals)
    core = CoreExecutor(device)
    _, _, persist_written = _analyze(program)

    data_axes: Tuple[str, ...] = ()
    if mesh is not None and not hasattr(mesh, "axis_names"):
        # a list of places: one axis of them, as with_data_parallel takes it
        from ..parallel.mesh_utils import make_mesh

        mesh = make_mesh([len(mesh)], [axis_name], list(mesh))
    if mesh is not None:
        mesh_axes = set(mesh.axis_names)
        data_axes = tuple(a for a in (getattr(program, "_data_axes", None)
                                      or (axis_name,)) if a in mesh_axes)
        if not data_axes:
            data_axes = (mesh.axis_names[0],)

    def make_fn(keep):
        # a cut of the verified program breaks its rewrite contracts by
        # design (a collective-free run reduces no grad): not verified
        from ..analysis import suspended

        sub = _sub_program(program, keep)
        if mesh is None:
            from ..core.compiler_engine import run_compiled_program

            def fn():
                with suspended():
                    run_compiled_program(core, sub, scratch, feed_vals, [],
                                         return_numpy=False)
        else:
            from ..parallel.engine import run_data_parallel

            def fn():
                with suspended():
                    run_data_parallel(core, sub, scratch, feed_vals, [],
                                      places=mesh, axis_name=axis_name,
                                      build_strategy=build_strategy,
                                      return_numpy=False)
        return fn

    return {"block": block, "ops": ops, "feed_vals": feed_vals,
            "device": device, "scratch": scratch, "core": core,
            "data_axes": data_axes, "persist_written": persist_written,
            "mesh": mesh, "make_fn": make_fn}


def _own_launches() -> Dict[str, int]:
    """The port's kernel launch counts (``ops/cuda/support``)."""
    try:
        from ..ops.cuda import support
    except Exception:
        return {}
    return support.launch_counts()


def _timed(fn, device) -> float:
    """Seconds one call takes: CUDA events on the card, the host clock on
    the CPU."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _time_call(fn, device, core, repeats: int):
    """(the best of ``repeats`` timed steps after the eager first run and,
    on the card, the capture; the data-parallel run it made, if any). The
    step's graphs are dropped after, so that one prefix's pool is freed
    before the next is captured."""
    try:
        fn()
        if device.type == "cuda":
            fn()   # the capture
        best = min(_timed(fn, device) for _ in range(max(1, repeats)))
        return best, core.dp_last
    finally:
        core.close()


# a payload above this is timed at the cap and scaled: a collective's time
# is linear in its bytes there
_MICROBENCH_MAX_ELEMS = 4 << 20

# seconds a profile spends before it stops adding optional cuts (the bucket
# prefixes, the feed's time); a caller asks for another with ``budget_s``
PROFILE_BUDGET_S = 120.0


def _bench_collective(group, devices, numel: int, dtype: str, kind: str,
                      repeats: int) -> float:
    """Serial time of one collective at its payload: the data axes'
    psum of one tensor a replica (for a sharded update, then the update's
    all_gather of the shards)."""
    import torch

    from ..core.dtypes import to_torch_dtype

    if group is None or numel <= 0:
        return 0.0
    scale = 1.0
    if numel > _MICROBENCH_MAX_ELEMS:
        scale = numel / float(_MICROBENCH_MAX_ELEMS)
        numel = _MICROBENCH_MAX_ELEMS
    try:
        dt = to_torch_dtype(dtype)
        if not dt.is_floating_point:
            dt = torch.float32
    except Exception:
        dt = torch.float32
    xs = [torch.arange(numel, dtype=torch.float32, device=d).to(dt) + r
          for r, d in enumerate(devices)]
    n = len(devices)

    parts = group.parts() if group.in_process else [(list(range(n)),
                                                     group)]

    def body():
        for ranks, g in parts:
            out = g.psum([xs[r] for r in ranks])
            if kind == "sharded_update":
                shard = max(1, numel // len(ranks))
                g.all_gather([o[:shard] for o in out])

    dev = devices[0]
    body()
    best = min(_timed(body, dev) for _ in range(max(1, repeats)))
    return best * scale


def profile_step(program, scope, feed: Dict, mesh=None,
                 axis_name: str = "dp", repeats: int = 2,
                 budget_s: Optional[float] = None,
                 max_bucket_cuts: int = 12, seed: int = 0,
                 build_strategy=None) -> Dict:
    """Measured phase breakdown and overlap report of one step of a
    static program, on one replica (``mesh`` None) or over a mesh.

    The program must run as it stands: its startup run, its rewrites
    applied (profile after it ran a step through its engine). The state
    in ``scope`` is read and never written (see the module docstring).
    ``seed`` is kept for the JAX package's signature: the runs draw from
    the profile's own executor core."""
    import torch

    if budget_s is None:
        budget_s = PROFILE_BUDGET_S
    deadline = time.monotonic() + budget_s

    ctx = _exec_inputs(program, scope, feed, mesh=mesh,
                       axis_name=axis_name, build_strategy=build_strategy)
    ops, device, core = ctx["ops"], ctx["device"], ctx["core"]
    make_fn = ctx["make_fn"]
    on_card = device.type == "cuda"
    launches0 = _own_launches()
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)

    plan = build_phase_plan(program, max_bucket_cuts=max_bucket_cuts,
                            state=ctx["scratch"])
    every = list(range(len(ops)))
    compute_idx = [i for i, ph in enumerate(plan["phases"])
                   if ph != "collective"]
    t_full, dp_run = _time_call(make_fn(every), device, core, repeats)
    group, devices = None, [device]
    if dp_run is not None:
        group, devices = dp_run.group, dp_run.devices
    exposed_measurable = bool(plan["collectives"]) and plan["skippable"]
    if exposed_measurable:
        t_nocoll = _time_call(make_fn(compute_idx), device, core,
                              repeats)[0]
    else:
        t_nocoll = t_full
    exposed_ms = max(0.0, (t_full - t_nocoll)) * 1e3

    # cumulative prefixes of the collective-free sequence
    phase_ms: Dict[str, float] = {}
    seg_times: List[Tuple[str, float]] = []
    seg_spans: List[Tuple[str, float, int, int]] = []
    prev_pos, prev_t = 0, 0.0
    truncated = False
    for label, pos in plan["cuts"]:
        if time.monotonic() > deadline:
            truncated = True
            break
        t = _time_call(make_fn(compute_idx[:pos]), device, core,
                       repeats)[0]
        seg = max(0.0, t - prev_t) * 1e3
        seg_times.append((label, seg))
        seg_spans.append((label.split("@", 1)[0], seg, prev_pos, pos))
        phase_ms[seg_spans[-1][0]] = \
            phase_ms.get(seg_spans[-1][0], 0.0) + seg
        prev_pos, prev_t = pos, max(t, prev_t)
    compute_ms = sum(phase_ms.values())

    per_bucket = []
    coll_serial_ms = 0.0
    bwd_segs = [(ms, start, end) for base, ms, start, end in seg_spans
                if base == "backward"]
    for c in plan["collectives"]:
        if time.monotonic() > deadline:
            truncated = True
            break
        try:
            c_ms = _bench_collective(group, devices,
                                     c.get("bench_numel", c["numel"]),
                                     c["dtype"], c["kind"], repeats) * 1e3
        except Exception:
            c_ms = 0.0
        coll_serial_ms += c_ms
        pos_c = c["avail_pos"]
        after = sum(ms for ms, _start, end in bwd_segs if end > pos_c)
        per_bucket.append({
            "bucket": c["bucket"], "op": c["type"], "kind": c["kind"],
            "bytes": c["bytes"], "collective_ms": c_ms,
            "strategy": c.get("strategy", "ring"),
            "quant": c.get("quant", "none"),
            "avail_pos": c["avail_pos"],
            "backward_after_ms": after,
            "max_hideable_frac": (min(1.0, after / c_ms)
                                  if c_ms > 0 else 0.0),
        })
    if not plan["collectives"]:
        overlap_frac = None
        exposed_ms = 0.0
    elif not exposed_measurable or coll_serial_ms <= 0:
        # no collective-free run exists: unmeasured, never a made-up
        # overlap
        overlap_frac = None
        exposed_ms = None
    else:
        overlap_frac = max(0.0, min(1.0, 1.0 - exposed_ms
                                    / coll_serial_ms))
    phase_ms_out = dict(phase_ms)
    if plan["collectives"]:
        phase_ms_out["collective"] = coll_serial_ms

    # staging this step's feeds from host memory onto the device
    feed_ms = 0.0
    if ctx["feed_vals"] and time.monotonic() <= deadline:
        host_feed = [v.cpu().numpy() for v in ctx["feed_vals"].values()]

        def stage():
            return [torch.from_numpy(v).to(device) for v in host_feed]

        try:
            stage()
            feed_ms = min(_timed(stage, device)
                          for _ in range(max(1, repeats))) * 1e3
        except Exception:
            feed_ms = 0.0

    prof = {
        "method": "phase-sliced reexecution + collective microbench",
        "step_ms": t_full * 1e3,
        "phase_ms": phase_ms_out,
        "feed_ms": feed_ms,
        "optimizer_ms": phase_ms.get("optimizer", 0.0),
        "segments_ms": seg_times,
        "compute_ms": compute_ms,
        "collective_ms": coll_serial_ms,
        "exposed_collective_ms": exposed_ms,
        "overlap_frac": overlap_frac,
        "critical_path_ms": (compute_ms + exposed_ms
                             if exposed_ms is not None else None),
        "serialized_ms": compute_ms + coll_serial_ms,
        "per_bucket": per_bucket,
        "backward_segments": [[start, end, ms]
                              for ms, start, end in bwd_segs],
        "n_compute": plan["n_compute"],
        "nranks": (int(np.prod([ctx["mesh"].shape[a]
                                for a in ctx["data_axes"]]))
                   if mesh is not None and ctx["data_axes"] else 1),
        "exposed_includes_fused_update": any(
            c["kind"] == "sharded_update" for c in plan["collectives"]),
        "n_ops": len(ops),
        "truncated": truncated,
        "timing": "cuda graph replays, cuda events" if on_card
        else "eager walk, host clock",
        "peak_bytes": (torch.cuda.max_memory_allocated(device)
                       if on_card else None),
    }
    after = _own_launches()
    # the port's kernels launched by the profile's own runs
    prof["launches"] = {k: n - launches0.get(k, 0) for k, n in after.items()
                        if n - launches0.get(k, 0)}
    core.close()
    _emit_profile(prof)
    return prof


def _emit_profile(prof: Dict) -> None:
    """Registry + span emission: ``profile.phase_ms{phase=}``
    histograms, overlap/critical-path gauges, and one chrome-trace row
    per measured segment (cat="phase" — merged into the job trace.json
    through the normal span/spool pipeline)."""
    from .. import observability as _obs
    from . import tracing

    if not _obs.enabled():
        return
    for phase, ms in prof["phase_ms"].items():
        _obs.observe("profile.phase_ms", ms, phase=phase)
    if prof["overlap_frac"] is not None:
        _obs.set_gauge("profile.overlap_frac", prof["overlap_frac"])
    if prof["critical_path_ms"] is not None:
        _obs.set_gauge("profile.critical_path_ms",
                       prof["critical_path_ms"])
    if prof["exposed_collective_ms"] is not None:
        _obs.set_gauge("profile.exposed_collective_ms",
                       prof["exposed_collective_ms"])
    if prof.get("feed_ms") is not None:
        _obs.set_gauge("profile.feed_ms", prof["feed_ms"])
    if tracing.active():
        t0 = time.perf_counter() * 1e6
        off = 0.0
        for label, ms in prof["segments_ms"]:
            tracing._record("profile/" + label, t0 + off, ms * 1e3,
                            "phase", {"phase": label.split("@", 1)[0]})
            off += ms * 1e3
        for b in prof["per_bucket"]:
            tracing._record("profile/collective%s" % b["bucket"],
                            t0 + off, b["collective_ms"] * 1e3, "phase",
                            {"phase": "collective",
                             "bucket": b["bucket"],
                             "bytes": b["bytes"]})
            off += b["collective_ms"] * 1e3


# -- analytic FLOP accounting --------------------------------------------------

# NVIDIA H100 80GB HBM3 (SXM5, power limit 700 W) dense tensor-core peaks
# from its data sheet: bf16 989 TFLOP/s; float32 products float32-accurate
# through the 3xTF32 split, three TF32 products at 494.7 TFLOP/s each (the
# port keeps TF32 off for its float32 GEMMs)
PEAK_FLOPS_BF16 = 989e12
PEAK_FLOPS_F32 = 494.7e12 / 3


def peak_flops(bf16: bool = False, n_devices: int = 1) -> float:
    return (PEAK_FLOPS_BF16 if bf16 else PEAK_FLOPS_F32) * max(
        1, int(n_devices))


def mfu_est(flops_per_step: float, step_s: float, bf16: bool = False,
            n_devices: int = 1) -> Optional[float]:
    if not step_s or not flops_per_step:
        return None
    return flops_per_step / step_s / peak_flops(bf16, n_devices)


def _shape_of(block, state, name) -> Optional[Tuple[int, ...]]:
    if not name:
        return None
    v = block._find_var_recursive(name)
    shape = getattr(v, "shape", None) if v is not None else None
    if shape and all(isinstance(s, int) and s > 0 for s in shape):
        return tuple(shape)
    if state is not None:
        arr = state.get(name) if isinstance(state, dict) else None
        if arr is None and not isinstance(state, dict):
            find = getattr(state, "find_var", None)
            if find is not None:
                var = find(name)
                if var is not None and var.is_initialized():
                    arr = var.raw().array
        if arr is not None and getattr(arr, "shape", None) is not None:
            return tuple(int(s) for s in arr.shape)
    # a grad var mirrors the shape of the var it differentiates; grad
    # vars often carry no static shape of their own
    from ..core.lod_lowering import _grad_base

    base = _grad_base(name)
    if base:
        return _shape_of(block, state, base)
    return None


def _prod(shape) -> int:
    return int(np.prod(shape)) if shape else 0


def _fl_mul(op, shp):
    x, y = shp(op.input("X")[0]), shp(op.input("Y")[0])
    if not x or not y:
        return 0
    xnc = int(op.attrs.get("x_num_col_dims", 1))
    ync = int(op.attrs.get("y_num_col_dims", 1))
    m = _prod(x[:xnc])
    k = _prod(x[xnc:])
    n = _prod(y[ync:])
    return 2 * m * k * n


def _fl_matmul(op, shp):
    x = shp(op.input("X")[0])
    outs = op.output("Out")
    out = shp(outs[0]) if outs else None
    if not x or not out:
        return 0
    k = x[-2] if op.attrs.get("transpose_X") or \
        op.attrs.get("transpose_x") else x[-1]
    return 2 * _prod(out) * int(k)


def _fl_conv2d(op, shp):
    outs = op.output("Output") or op.output("Out")
    out = shp(outs[0]) if outs else None
    f = shp(op.input("Filter")[0])
    if not out or not f:
        return 0
    return 2 * _prod(out) * int(f[1]) * int(f[2]) * int(f[3])


def _fl_flash(op, shp):
    q = shp(op.input("Q")[0])
    if not q or len(q) < 4:
        return 0
    b, h, s, d = q[-4], q[-3], q[-2], q[-1]
    f = 4 * b * h * s * s * d
    return f // 2 if op.attrs.get("causal") else f


def _fl_first_input(mult):
    def fn(op, shp):
        for n in op.input_arg_names:
            s = shp(n)
            if s:
                return mult * _prod(s)
        return 0
    return fn


def _fl_outputs(mult=1):
    def fn(op, shp):
        tot = 0
        for n in op.output_arg_names:
            s = shp(n)
            if s:
                tot += _prod(s)
        return mult * tot
    return fn


# (category, estimator). *_grad ops resolve through their base type at
# 2x (dgrad + wgrad — the standard training-step accounting); unknown
# ops fall back to one flop per output element under "other".
_FLOPS_TABLE = {
    "mul": ("matmul", _fl_mul),
    "matmul": ("matmul", _fl_matmul),
    "conv2d": ("conv", _fl_conv2d),
    "depthwise_conv2d": ("conv", _fl_conv2d),
    "flash_attention": ("attention", _fl_flash),
    "batch_norm": ("norm", _fl_first_input(8)),
    "layer_norm": ("norm", _fl_first_input(8)),
    # fused epilogues (core/fusion.py): add + act (+ dropout) ~= 3
    # elementwise passes; add + layer_norm = 1 + the norm's 8
    "fused_bias_act": ("elementwise", _fl_first_input(3)),
    "fused_residual_layer_norm": ("norm", _fl_first_input(9)),
    "softmax": ("elementwise", _fl_first_input(5)),
    "softmax_with_cross_entropy": ("loss", _fl_first_input(6)),
    "cross_entropy": ("loss", _fl_first_input(3)),
    "lookup_table": ("embedding", lambda op, shp: 0),
    "lookup_table_v2": ("embedding", lambda op, shp: 0),
}

_ZERO_FLOP_OPS = frozenset({
    "fill_constant", "reshape", "reshape2", "transpose", "transpose2",
    "feed", "fetch", "shape", "squeeze", "squeeze2", "unsqueeze",
    "unsqueeze2", "assign", "share_data", "static_axis_size",
})


class _GradOpView:
    """Presents a ``*_grad`` op to a FORWARD estimator: grad ops carry
    the forward op's inputs verbatim plus ``<slot>@GRAD`` inputs for
    each forward output, so a forward formula asking for the output
    slot ("Out"/"Output") resolves through the output-grad input —
    same shape, which is all the estimators read."""

    __slots__ = ("_op",)

    def __init__(self, op):
        self._op = op

    def input(self, slot):
        return self._op.input(slot)

    def output(self, slot):
        got = self._op.output(slot)
        if got:
            return got
        from ..core.registry import GRAD_SUFFIX

        return self._op.input(slot + GRAD_SUFFIX)

    @property
    def attrs(self):
        return self._op.attrs

    @property
    def input_arg_names(self):
        return self._op.input_arg_names

    @property
    def output_arg_names(self):
        return self._op.output_arg_names


def op_flops(op, block, state=None) -> Tuple[int, str]:
    """(flops, category) for one op — analytic, from static shapes."""
    def shp(name):
        return _shape_of(block, state, name)

    t = op.type
    if t.startswith("c_"):
        return 0, "collective"
    if t in _ZERO_FLOP_OPS:
        return 0, "other"
    grad = t.endswith("_grad")
    base = t[:-5] if grad else t
    if base in OPTIMIZER_OPS:
        # a handful of elementwise passes over every param element;
        # fused_optimizer carries a whole instance's params in one
        # duplicable slot — same per-element cost, summed across them
        params = op.input("Param") or []
        if base != "fused_optimizer":
            params = params[:1]
        tot = sum(_prod(shp(n)) or 0 for n in params)
        return 4 * tot, "optimizer"
    cat, fn = _FLOPS_TABLE.get(base, (None, None))
    if fn is None:
        return _fl_outputs(1)(op, shp), "other"
    f = fn(_GradOpView(op) if grad else op, shp)
    if grad:
        f *= 2
    return f, cat


def program_flops(program, state=None) -> Dict:
    """Analytic FLOPs of one execution of ``program``:
    ``{"total": F, "by_category": {...}}`` — per-step when the program
    is a training step. Shapes come from the block (falling back to
    live scope/state values); ops without resolvable shapes count 0.
    """
    block = program.global_block()
    by_cat: Dict[str, int] = {}
    total = 0
    for op in block.ops:
        f, cat = op_flops(op, block, state)
        if f:
            by_cat[cat] = by_cat.get(cat, 0) + f
            total += f
    return {"total": total, "by_category": by_cat}


def flops_mlp(batch: int, dims: Sequence[int], train: bool = True) -> int:
    """Analytic per-step FLOPs of a dense MLP (bench.py's dygraph_mlp
    shape): 2*b*sum(d_i*d_{i+1}) forward, x3 for a training step."""
    fwd = 2 * batch * sum(int(a) * int(b)
                          for a, b in zip(dims, dims[1:]))
    return 3 * fwd if train else fwd


def flops_transformer_lm(batch: int, seq_len: int, d_model: int,
                         n_layers: int, vocab: int,
                         train: bool = True) -> int:
    """Analytic per-step FLOPs of a standard transformer LM block stack
    (qkvo + 4x FFN + attention scores/context) plus the logit matmul —
    bench.py's dygraph_bert shape."""
    per_layer = 24 * batch * seq_len * d_model * d_model \
        + 4 * batch * seq_len * seq_len * d_model
    fwd = n_layers * per_layer + 2 * batch * seq_len * d_model * vocab
    return 3 * fwd if train else fwd


# -- the fluid.profiler session API ---------------------------------------------
#
# The reference's python/paddle/fluid/profiler.py (the ``profiler`` context
# manager, ``start_profiler``, ``stop_profiler``) over the span buffer
# (``tracing``): RecordEvent spans feed the buffer the runtime's spans
# feed, a session is drained into a snapshot at its stop, and the stop
# prints the per-event table. The device side is ``torch.profiler``.

from . import tracing as _tracing  # noqa: E402

_last_trace: List[Tuple] = []   # (name, ts_us, dur_us) of the last session
_torch_prof = None               # the live torch.profiler session, if any
_last_kernels: List[Tuple] = []  # (name, calls, device_ms) of the last


class RecordEvent:
    """RAII annotation of a region (the reference's
    ``platform/profiler.cc`` RecordEvent): a span with cat ``op`` (and,
    while a device session runs, a ``torch.profiler`` range)."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self._span = _tracing.span(self.name, cat="op")
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        return self._span.__exit__(*exc)


def record_event(name):
    return RecordEvent(name)


def is_profiler_enabled():
    return _tracing.profiler_session_active()


def get_trace_events():
    """(name, ts_us, dur_us) host events: the live session's while one
    runs, else the last finished session's."""
    if _tracing.profiler_session_active():
        return [(n, ts, dur)
                for (n, ts, dur, _tid, _cat, _a)
                in _tracing.profiler_session_events()]
    return list(_last_trace)


def reset_profiler():
    # the session's own spans only: other subsystems' stay
    _tracing.profiler_session_reset()


def device_kernels() -> List[Tuple]:
    """The last device session's kernels: (name, calls, device_ms), by
    device time."""
    return list(_last_kernels)


def start_profiler(state="All", tracer_option=None, trace_dir=None):
    """Open a session. ``state`` ``"GPU"`` or ``"All"`` on a machine with
    a card also opens a ``torch.profiler`` session with CUDA activity."""
    global _torch_prof
    _tracing.profiler_session_start()
    if state in ("GPU", "All"):
        import torch

        if torch.cuda.is_available():
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            _torch_prof = torch.profiler.profile(activities=acts)
            _torch_prof.__enter__()
            _tracing._set_range_fn(torch.profiler.record_function)


def _device_rows(prof):
    """(event name -> device ms, kernel rows) of a finished
    torch.profiler session."""
    by_name: Dict[str, float] = {}
    kernels = []
    for ev in prof.key_averages():
        dev_us = float(getattr(ev, "device_time_total", None)
                       or getattr(ev, "cuda_time_total", 0.0) or 0.0)
        by_name[ev.key] = dev_us / 1e3
        self_dev = float(getattr(ev, "self_device_time_total", None)
                         or getattr(ev, "self_cuda_time_total", 0.0) or 0.0)
        if self_dev and not getattr(ev, "cpu_time_total", 0):
            kernels.append((ev.key, int(ev.count), self_dev / 1e3))
    kernels.sort(key=lambda k: -k[2])
    return by_name, kernels


def stop_profiler(sorted_key="total", profile_path="/tmp/profile"):
    """Close the session and print its table: each event's calls, host
    total and mean, and its device time where a device session ran; then
    the kernels by device time. A ``profile_path`` other than the default
    gets the device session's chrome trace."""
    global _torch_prof
    dev_by_name: Dict[str, float] = {}
    kernels: List[Tuple] = []
    if _torch_prof is not None:
        prof, _torch_prof = _torch_prof, None
        _tracing._set_range_fn(None)
        prof.__exit__(None, None, None)
        dev_by_name, kernels = _device_rows(prof)
        if profile_path and profile_path != "/tmp/profile":
            prof.export_chrome_trace(profile_path)
    session, agg = _tracing.profiler_session_stop()
    rows = sorted(((name, (count, total_us / 1e6))
                   for name, (count, total_us) in agg.items()),
                  key=lambda kv: -kv[1][1])
    if rows:
        print("%-40s %10s %14s %14s %14s"
              % ("Event", "Calls", "Total(ms)", "Avg(ms)", "Device(ms)"))
        for name, (count, total) in rows[:50]:
            dev = dev_by_name.get(name)
            print("%-40s %10d %14.3f %14.3f %14s"
                  % (name, count, total * 1e3, total * 1e3 / max(count, 1),
                     "%.3f" % dev if dev is not None else "-"))
    if kernels:
        print("%-60s %10s %14s %14s"
              % ("Kernel", "Calls", "Device(ms)", "Avg(ms)"))
        for name, count, ms in kernels[:40]:
            print("%-60s %10d %14.3f %14.3f"
                  % (name[:60], count, ms, ms / max(count, 1)))
    del _last_kernels[:]
    _last_kernels.extend(kernels)
    del _last_trace[:]
    _last_trace.extend((n, ts, dur) for (n, ts, dur, _t, _c, _a)
                       in session)


@contextlib.contextmanager
def profiler(state="All", sorted_key="total", profile_path="/tmp/profile",
             tracer_option=None):
    start_profiler(state, tracer_option)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


@contextlib.contextmanager
def cuda_profiler(output_file=None, output_mode=None, config=None):
    """A session bracketed by ``torch.cuda.profiler.start`` / ``stop``
    (the CUDA profiler API's capture range) where there is a card."""
    import torch

    cuda = torch.cuda.is_available()
    with profiler("GPU" if cuda else "CPU"):
        if cuda:
            torch.cuda.profiler.start()
        try:
            yield
        finally:
            if cuda:
                torch.cuda.profiler.stop()
