"""Fast collective path: bucketed / quantized allreduce and the
cross-replica sharded weight update, as rewrites of the transpiled program.

Counterpart of ``paddle_tpu/parallel/collectives.py``, applied by the
engine after ``transpiler.insert_allreduce_ops``:

- ``bucket_allreduce_ops``: the per-grad ``c_allreduce_sum`` ops coalesce
  into ``c_bucket_allreduce`` ops (one flat reduction each), assembled in
  the order backward makes the grads available and spliced in just after
  the last op that touches a member, under a byte cap. Bit for bit with the
  per-grad path: each element is summed over the replicas in the same
  rank order either way.
- Quantized allreduce (``PADDLE_TPU_QUANT_ALLREDUCE=bf16|int8``): the
  bucket payload is compressed (``ops.collective_ops.quantized_psum``).
- ``apply_sharded_weight_update``: each optimizer instance's per-param
  (allreduce, update) pairs become one ``c_sharded_update`` op, its state
  re-laid into flat vars sharded over the data axis (each replica holds
  and updates 1/n of them).

Knobs, read at a program's first data-parallel run and baked in:

==============================  ============================================
``PADDLE_TPU_BUCKET_MB``        bucket cap in MB (default 4; ``0`` disables
                                bucketing). ``BuildStrategy.
                                fuse_all_reduce_ops=False`` also disables.
``PADDLE_TPU_QUANT_ALLREDUCE``  ``bf16`` | ``int8`` (default off: exact)
``PADDLE_TPU_SHARDED_UPDATE``   ``1`` enables, ``0`` forces off (over the
                                BuildStrategy knob either way)
``PADDLE_TPU_BUCKET_PLAN``      ``size`` (default) | ``profile``: bucket
                                boundaries from the saved step-profile
                                report ``PADDLE_TPU_BUCKET_PROFILE`` names
                                (``plan_buckets_profile``; the size plan
                                where the report does not fit the program)
``PADDLE_TPU_PLACEMENT_PLAN``   a searched plan (``placement/``): it decides
                                every knob above and the schedule knobs of
                                ``parallel/scheduling.py`` at once
==============================  ============================================

``resync_sharded_state`` is ``core.fusion``'s (one copy of the rule).
"""
from __future__ import annotations

import bisect
import hashlib
import math
import os
from typing import Dict, List, Optional, Tuple

import torch

from ..core.dtypes import convert_dtype, to_torch_dtype
from ..core.fusion import _attrs_sig, _splice_flat_state, _src_token
from ..core.fusion import resync_sharded_state  # noqa: F401
from ..core.lod_lowering import _grad_base
from ..core.tensor import LoDTensor
from ..ops.collective_ops import QUANT_WIRE_ITEMSIZE, SHARDED_UPDATE_SLOTS
from .transpiler import _bump_version, _merge_data_axes
from ..analysis.contracts import checked_rewrite

DEFAULT_BUCKET_MB = 4.0

# optimizer ops whose update is elementwise in (param, grad, state): the
# flat-shard update is then bit for bit the per-param one
_SHARDABLE_OPTIMIZERS = frozenset(SHARDED_UPDATE_SLOTS)


def bucket_mb(build_strategy=None) -> float:
    if build_strategy is not None and not getattr(
            build_strategy, "fuse_all_reduce_ops", True):
        return 0.0
    raw = os.environ.get("PADDLE_TPU_BUCKET_MB", "").strip()
    if not raw:
        return DEFAULT_BUCKET_MB
    try:
        return max(0.0, float(raw))
    except ValueError:
        return DEFAULT_BUCKET_MB


def quant_mode() -> str:
    raw = os.environ.get("PADDLE_TPU_QUANT_ALLREDUCE", "").strip().lower()
    if raw in ("", "0", "none", "off", "false"):
        return "none"
    if raw not in QUANT_WIRE_ITEMSIZE:
        raise ValueError(
            "PADDLE_TPU_QUANT_ALLREDUCE=%r (want bf16 or int8)" % raw)
    return raw


def bucket_plan_mode() -> str:
    """``PADDLE_TPU_BUCKET_PLAN``: ``size`` (default: the byte-capped greedy
    plan) or ``profile`` (boundaries chosen against the saved
    ``profile_step`` report ``PADDLE_TPU_BUCKET_PROFILE`` names)."""
    raw = os.environ.get("PADDLE_TPU_BUCKET_PLAN", "").strip().lower()
    if raw in ("", "size", "static"):
        return "size"
    if raw == "profile":
        return "profile"
    raise ValueError(
        "PADDLE_TPU_BUCKET_PLAN=%r (want size or profile)" % raw)


def load_profile_report(path: Optional[str] = None) -> Optional[Dict]:
    """The saved step-profile report a profile plan reads (a
    ``profile_step`` dict or a record wrapping one): ``per_bucket``
    (measured cost against bytes) and ``backward_segments`` (measured
    backward time by compute position). None when the path is unset or
    unreadable or the document lacks those fields: the caller then plans
    by size (``observability.steering.load_report``)."""
    from ..observability import steering

    return steering.load_report(path)


def sharded_update_enabled(build_strategy=None) -> bool:
    raw = os.environ.get("PADDLE_TPU_SHARDED_UPDATE", "").strip()
    if raw:
        return raw.lower() in ("1", "true", "yes", "on")
    return bool(build_strategy is not None and getattr(
        build_strategy, "fuse_all_optimizer_ops", False))


def _lookup_value(store, name):
    """The live tensor of ``name`` in a Scope or a plain mapping."""
    if store is None or not name:
        return None
    find = getattr(store, "find_var", None)
    if find is None:
        return store.get(name)
    var = find(name)
    if var is not None and var.is_initialized():
        h = var.raw()
        return h.array if isinstance(h, LoDTensor) else h
    return None


def _numel_and_dtype(block, store, name) -> Tuple[Optional[int], str]:
    """Element count and dtype of a var: its block shape, else its live
    value, else the param a grad mirrors. The one size resolver of the
    bucket planner and the engine's byte counters."""
    v = block._find_var_recursive(name)
    shape = getattr(v, "shape", None) if v is not None else None
    dtype = str(getattr(v, "dtype", None) or "float32")
    if shape and all(isinstance(s, int) and s > 0 for s in shape):
        return math.prod(shape), dtype
    arr = _lookup_value(store, name)
    if isinstance(arr, torch.Tensor):
        return arr.numel(), convert_dtype(arr.dtype)
    base = _grad_base(name)
    if base:
        bv = block._find_var_recursive(base)
        bshape = getattr(bv, "shape", None) if bv is not None else None
        if bshape and all(isinstance(s, int) and s > 0 for s in bshape):
            return (math.prod(bshape),
                    str(getattr(bv, "dtype", None) or "float32"))
        arr = _lookup_value(store, base)
        if isinstance(arr, torch.Tensor):
            return arr.numel(), convert_dtype(arr.dtype)
    return None, dtype


def itemsize(dtype) -> int:
    try:
        return torch.empty((), dtype=to_torch_dtype(dtype)).element_size()
    except (TypeError, ValueError, KeyError):
        return 4


def maybe_rewrite_collectives(program, scope, nranks: int, data_axes,
                              build_strategy=None, multiproc=False) -> None:
    """Engine entry point: the sharded-update pass (opt-in), the bucketing
    of the per-grad allreduces left, then the schedule shaping of
    ``scheduling`` (the reduction spelling, per-bucket quantization with
    error feedback, the async start / await split). Every pass runs once a
    program; the knobs are read at the program's first data-parallel run.
    With ``PADDLE_TPU_PLACEMENT_PLAN`` set, a searched plan
    (``placement/``) decides all of them in place of the hand knobs. A
    plan that does not fit is skipped whole and counted in
    ``placement.plan_skipped{reason=}``: its mesh is not this one
    (``mesh_mismatch``), or its sharded update cannot run on this
    topology (``unsupported_topology``); an unreadable plan is counted by
    ``placement.plan.active_plan`` (``unreadable``)."""
    if nranks <= 1 or not data_axes:
        return
    from .. import observability as _obs
    from ..placement.plan import active_plan

    pplan = active_plan()
    if pplan is not None and not pplan.matches(nranks, data_axes):
        _obs.inc("placement.plan_skipped", reason="mesh_mismatch")
        pplan = None
    if pplan is not None and pplan.sharded_update \
            and (len(data_axes) != 1 or multiproc):
        # never the bucket / strategy half without the update it was
        # priced with
        _obs.inc("placement.plan_skipped", reason="unsupported_topology")
        pplan = None
    quant = pplan.quant_mode if pplan is not None else quant_mode()
    use_sharded = (pplan.sharded_update if pplan is not None
                   else sharded_update_enabled(build_strategy))
    if use_sharded and len(data_axes) == 1 and not multiproc:
        apply_sharded_weight_update(program, scope, nranks,
                                    axis=data_axes[0], quant=quant)
    resync_sharded_state(program, scope)
    if pplan is not None:
        mb, plan, report = (pplan.bucket_mb, pplan.bucket_plan_mode,
                            pplan.report)
    else:
        mb = bucket_mb(build_strategy)
        plan = bucket_plan_mode()
        report = load_profile_report() if plan == "profile" else None
    if mb > 0:
        bucket_allreduce_ops(program, bucket_bytes=int(mb * (1 << 20)),
                             quant=quant, scope=scope, plan=plan,
                             report=report)
    elif quant != "none":
        # quantization without coalescing: one-member bucket ops
        bucket_allreduce_ops(program, bucket_bytes=0, quant=quant,
                             scope=scope)
    if getattr(program, "_placement_shaped", False):
        return
    program._placement_shaped = True
    from .scheduling import (async_collectives_enabled,
                             configure_bucket_quant, quant_error_feedback,
                             reduce_strategy_mode,
                             schedule_async_collectives,
                             swap_reduction_strategy)

    strategy = pplan.strategy if pplan is not None \
        else reduce_strategy_mode()
    if strategy != "ring":
        swap_reduction_strategy(program, strategy)
    ef = pplan.error_feedback if pplan is not None \
        else quant_error_feedback()
    qmodes = pplan.quant_buckets if pplan is not None else None
    if ef or qmodes:
        configure_bucket_quant(program, scope, nranks, data_axes[0],
                               modes=qmodes, error_feedback=ef)
    do_async = pplan.async_collectives if pplan is not None \
        else async_collectives_enabled()
    if do_async:
        schedule_async_collectives(program, report=report, scope=scope)
    if pplan is not None:
        program._placement_plan = pplan.summary()
        _obs.inc("placement.plan_applied")
    # the schedule this program got, for a job's postmortem
    bp = getattr(program, "_bucket_plan", None) or {}
    _obs.flight.record(
        "parallel.schedule", nranks=int(nranks), strategy=strategy,
        buckets=bp.get("n_buckets", 0), bucket_plan=bp.get("mode"),
        async_split=(getattr(program, "_async_schedule", None)
                     or {}).get("split", 0),
        plan_digest=pplan.digest if pplan is not None else None)


# -- bucketed allreduce -----------------------------------------------------------


def _pergrad_allreduce_indices(ops) -> List[int]:
    """The per-grad ``c_allreduce_sum`` ops over the whole data group: a
    bucket and the sharded update reduce over that group, so a sum over
    one named axis alone (``_mesh_axis``) keeps its own op."""
    out = []
    for i, op in enumerate(ops):
        if op.type != "c_allreduce_sum" or op.attrs.get("_mesh_axis"):
            continue
        x, o = op.input("X"), op.output("Out")
        if len(x) == 1 and x == o:
            out.append(i)
    return out


def plan_buckets(items, bucket_bytes: int):
    """Greedy size-capped bucketing in availability order.

    ``items``: [(anchor, first_consumer, key, nbytes, idx)]. A bucket
    closes when a member would pass the byte cap, change the (ring, dtype)
    key, or move the bucket's insertion point (max anchor + 1) past a
    member's first consumer. Returns [{"members", "anchor", "key", ...}]."""
    buckets: List[Dict] = []
    open_by_key: Dict = {}
    for anchor, first_use, key, nbytes, idx in sorted(items):
        b = open_by_key.get(key)
        if b is not None:
            new_anchor = max(b["anchor"], anchor)
            fits = (bucket_bytes > 0
                    and b["bytes"] + nbytes <= bucket_bytes)
            ordered = (new_anchor + 1 <= min(b["min_use"], first_use))
            if not (fits and ordered):
                b = None
        if b is None:
            b = {"members": [], "bytes": 0, "anchor": -1,
                 "min_use": first_use, "key": key}
            buckets.append(b)
            open_by_key[key] = b
        b["members"].append(idx)
        b["bytes"] += nbytes
        b["anchor"] = max(b["anchor"], anchor)
        b["min_use"] = min(b["min_use"], first_use)
    return buckets


# a profile-planned bucket's predicted cost stays under this share of the
# measured backward compute left after its availability point
PROFILE_PLAN_BUDGET_FRAC = 0.5


def _fit_cost_model(report) -> Optional[Tuple[float, float]]:
    """(intercept ms, ms a byte) fitted to the report's measured per-bucket
    costs (``placement.cost_model``'s line: one point's intercept is 10%
    of its cost, so splitting is never free)."""
    from ..placement.cost_model import _fit_line

    return _fit_line([(float(b.get("bytes") or 0),
                       float(b.get("collective_ms") or 0))
                      for b in report.get("per_bucket") or []])


def plan_buckets_profile(items, report, bucket_bytes: int,
                         compute_pos) -> Optional[List[Dict]]:
    """Bucketing from measured timing. ``items`` is ``plan_buckets``'s
    list; ``compute_pos(op_index)`` maps an anchor to its position in the
    collective-free op sequence (the report's ``backward_segments``
    coordinates, the same under any bucket plan). A bucket's predicted cost
    (the fitted ``a + b * bytes``) stays under
    ``PROFILE_PLAN_BUDGET_FRAC`` of the backward compute measured after
    its availability point; grads with nothing left to hide behind merge
    into one tail bucket a key. The byte cap and the first-consumer order
    still bind. None when the report gives no cost model (the caller plans
    by size)."""
    model = _fit_cost_model(report)
    segs = [s for s in (report.get("backward_segments") or [])
            if isinstance(s, (list, tuple)) and len(s) == 3]
    if model is None or not segs:
        return None
    icept, slope = model

    def cost(nbytes):
        return icept + slope * nbytes

    def hide(pos):
        return sum(float(ms) for _s, e, ms in segs if e > pos)

    frac = PROFILE_PLAN_BUDGET_FRAC
    buckets: List[Dict] = []
    open_by_key: Dict = {}
    tail_by_key: Dict = {}
    for anchor, first_use, key, nbytes, idx in sorted(items):
        pos = compute_pos(anchor)
        budget = hide(pos)
        hideable = budget > 0.0 and cost(nbytes) - icept < budget
        store = open_by_key if hideable else tail_by_key
        b = store.get(key)
        if b is not None:
            new_anchor = max(b["anchor"], anchor)
            fits_cap = (bucket_bytes > 0
                        and b["bytes"] + nbytes <= bucket_bytes)
            ordered = (new_anchor + 1 <= min(b["min_use"], first_use))
            fits_budget = (not hideable) or (
                cost(b["bytes"] + nbytes)
                <= frac * hide(compute_pos(new_anchor)))
            if not (fits_cap and ordered and fits_budget):
                b = None
        if b is None:
            b = {"members": [], "bytes": 0, "anchor": -1,
                 "min_use": first_use, "key": key}
            buckets.append(b)
            store[key] = b
        b["members"].append(idx)
        b["bytes"] += nbytes
        b["anchor"] = max(b["anchor"], anchor)
        b["min_use"] = min(b["min_use"], first_use)
    return buckets


@checked_rewrite("bucket_allreduce")
def bucket_allreduce_ops(program, bucket_bytes: int = 4 << 20,
                         quant: str = "none", scope=None,
                         plan: str = "size", report=None) -> int:
    """Coalesce the per-grad ``c_allreduce_sum`` ops into
    ``c_bucket_allreduce`` ops at each bucket's availability point; returns
    the number of bucket ops (0: nothing done). ``bucket_bytes <= 0`` is
    one bucket a grad (quantization without coalescing). ``plan="profile"``
    with a ``report`` chooses the boundaries by ``plan_buckets_profile``
    (the size plan when the report was measured on another program)."""
    if getattr(program, "_allreduce_bucketed", False):
        return 0
    program._allreduce_bucketed = True
    from .. import framework

    block = program.global_block()
    ops = block.ops
    cand = _pergrad_allreduce_indices(ops)
    if not cand or (len(cand) <= 1 and quant == "none"):
        return 0
    cand_set = set(cand)
    touched_at: Dict[str, List[int]] = {}
    consumed_at: Dict[str, List[int]] = {}
    for j, op in enumerate(ops):
        ins = op.input_arg_names
        for nm in ins:
            consumed_at.setdefault(nm, []).append(j)
        if j not in cand_set:
            for nm in set(ins) | set(op.output_arg_names):
                touched_at.setdefault(nm, []).append(j)

    items = []
    for i in cand:
        g = ops[i].input("X")[0]
        t = touched_at.get(g, ())
        k = bisect.bisect_left(t, i)
        last = t[k - 1] if k else -1
        c = consumed_at.get(g, ())
        k = bisect.bisect_right(c, i)
        use = c[k] if k < len(c) else len(ops)
        n, dtype = _numel_and_dtype(block, scope, g)
        if n is None:
            continue  # unknown payload: its per-grad op stays
        items.append((last, use, (ops[i].attrs.get("ring_id", 0), dtype),
                      n * itemsize(dtype), i))
    if not items:
        return 0

    mode_used = "size"
    buckets = None
    if plan == "profile" and report is not None:
        # positions in the collective-free op sequence, the report's
        # coordinates; a report of another program shape is ignored
        cpos = []
        k = 0
        for op in ops:
            cpos.append(k)
            if not op.type.startswith("c_"):
                k += 1
        if int(report.get("n_compute") or -1) == k:
            def compute_pos(anchor):
                if anchor < 0:
                    return 0
                return cpos[anchor] + (
                    0 if ops[anchor].type.startswith("c_") else 1)

            buckets = plan_buckets_profile(items, report, bucket_bytes,
                                           compute_pos)
            if buckets is not None:
                mode_used = "profile"
    if buckets is None:
        buckets = plan_buckets(items, bucket_bytes)
    from .. import observability as _obs

    _obs.inc("parallel.bucket_plan", mode=mode_used)
    program._bucket_plan = {
        "requested": plan, "mode": mode_used,
        "n_buckets": len(buckets),
        "bucket_bytes": [b["bytes"] for b in buckets],
        "anchors": [b["anchor"] for b in buckets],
    }
    removed = set()
    after: Dict[int, List] = {}
    for b in buckets:
        names = [ops[i].input("X")[0] for i in b["members"]]
        ar = framework.Operator(
            block, "c_bucket_allreduce", {"X": names}, {"Out": names},
            {"ring_id": b["key"][0], "quant": quant,
             "use_calc_stream": True})
        ar._id = program._next_op_id()
        removed.update(b["members"])
        after.setdefault(b["anchor"], []).append(ar)
    new_ops = list(after.get(-1, []))
    for i, op in enumerate(ops):
        if i not in removed:
            new_ops.append(op)
        new_ops.extend(after.get(i, ()))
    block.ops = new_ops
    _bump_version(program)
    return len(buckets)


# -- cross-replica sharded weight update -------------------------------------------


def _flat_device(scope, names, block):
    for n in names:
        t = _lookup_value(scope, n)
        if isinstance(t, torch.Tensor):
            return t.device
    return torch.device("cpu")


@checked_rewrite("sharded_update")
def apply_sharded_weight_update(program, scope, nranks: int,
                                axis: str = "dp",
                                quant: str = "none") -> int:
    """Rewrite each supported optimizer instance's per-param
    (c_allreduce_sum, update) pairs into one ``c_sharded_update`` op and
    re-lay its state into flat vars sharded over ``axis`` (recorded in
    ``program._var_shard_specs``; the scope's values spliced in, zero-padded
    to a multiple of ``nranks``). Returns the number of groups. One group
    per (op type, attrs, learning rate, dtype); sharded params, sparse
    grads and grads another op reads after their allreduce keep the
    per-param path."""
    prev = getattr(program, "_sharded_update_n", None)
    if prev is not None:
        if prev != nranks:
            raise ValueError(
                "program already sharded-update-rewritten for %d ranks, "
                "mesh now has %d" % (prev, nranks))
        return 0
    program._sharded_update_n = nranks
    from .. import framework

    block = program.global_block()
    ops = block.ops
    shard_specs = getattr(program, "_var_shard_specs", None) or {}
    cand = set(_pergrad_allreduce_indices(ops))
    grad_ar: Dict[str, int] = {ops[i].input("X")[0]: i for i in cand}
    consumed_at: Dict[str, List[int]] = {}
    for j, op in enumerate(ops):
        for nm in op.input_arg_names:
            consumed_at.setdefault(nm, []).append(j)
    groups: Dict[Tuple, List[int]] = {}
    for i, op in enumerate(ops):
        if op.type not in _SHARDABLE_OPTIMIZERS:
            continue
        p = op.input("Param")[0]
        pv = block._find_var_recursive(p)
        if (p in shard_specs or pv is None or not pv.shape
                or not all(isinstance(s, int) and s > 0 for s in pv.shape)
                or getattr(pv, "type", "lod_tensor") != "lod_tensor"):
            continue
        g = op.input("Grad")[0]
        gv = block._find_var_recursive(g)
        if gv is not None and getattr(gv, "type", "") == "selected_rows":
            continue
        ai = grad_ar.get(g)
        if ai is not None and any(j > ai and j != i
                                  for j in consumed_at.get(g, ())):
            continue  # another op reads the reduced grad
        key = (op.type, _attrs_sig(op.attrs),
               op.input("LearningRate")[0], str(pv.dtype))
        groups.setdefault(key, []).append(i)
    if not groups:
        return 0
    removed = set()
    replace_at: Dict[int, object] = {}
    n_groups = 0
    for key, idxs in sorted(groups.items(), key=lambda kv: kv[1][0]):
        op_type, _, lr_name, dtype = key
        member_ops = [ops[i] for i in idxs]
        params = [op.input("Param")[0] for op in member_ops]
        grads = [op.input("Grad")[0] for op in member_ops]
        sizes = [math.prod(block.var(p).shape) for p in params]
        total = sum(sizes)
        padded = -(-total // nranks) * nranks
        n_groups += 1
        # content-derived: two programs sharing one scope keep apart
        sig = hashlib.sha1(("%s|%s" % (op_type, ",".join(
            "%s:%d" % t for t in zip(params, sizes)))).encode())
        gtag = sig.hexdigest()[:8]
        device = _flat_device(scope, params, block)
        inputs = {"Param": params, "Grad": grads, "LearningRate": [lr_name]}
        outputs = {"ParamOut": params}
        for slot_key, slot in zip(("StateA", "StateB"),
                                  SHARDED_UPDATE_SLOTS[op_type]):
            state_names = [op.input(slot)[0] for op in member_ops]
            flat_name = "sharded_update_%s.%s" % (gtag, slot.lower())
            fv = block.create_var(name=flat_name, shape=(padded,),
                                  dtype=dtype, persistable=True)
            fv.stop_gradient = True
            flat = _splice_flat_state(block, scope, state_names, total,
                                      padded, dtype, slot, device)
            for sn in state_names:
                block.var(sn).persistable = False
            scope.var(flat_name).set(LoDTensor(flat))
            for attr in ("_sharded_flat_layout", "_sharded_src_tokens"):
                if getattr(program, attr, None) is None:
                    setattr(program, attr, {})
            program._sharded_flat_layout[flat_name] = (
                tuple(state_names), total, padded, dtype, slot)
            program._sharded_src_tokens[flat_name] = tuple(
                _src_token(scope, sn) for sn in state_names)
            inputs[slot_key] = [flat_name]
            outputs[slot_key + "Out"] = [flat_name]
            specs = getattr(program, "_var_shard_specs", None)
            if specs is None:
                specs = {}
                program._var_shard_specs = specs
            specs[flat_name] = (axis,)
        for scalar in ("Beta1Pow", "Beta2Pow"):
            names = [op.input(scalar) for op in member_ops]
            if all(n for n in names):
                inputs[scalar] = [n[0] for n in names]
                outputs[scalar + "Out"] = [n[0] for n in names]
        attrs = dict(member_ops[0].attrs)
        attrs.update({"op_type": op_type, "shard_axis": axis,
                      "nranks": int(nranks), "padded_size": int(padded),
                      "quant": quant})
        su = framework.Operator(block, "c_sharded_update", inputs,
                                outputs, attrs)
        su._id = program._next_op_id()
        su._role = member_ops[0]._role
        replace_at[idxs[0]] = su
        removed.update(idxs)
        removed.update(grad_ar[g] for g in grads if g in grad_ar)
    new_ops = []
    for i, op in enumerate(ops):
        if i in replace_at:
            new_ops.append(replace_at[i])
        if i not in removed:
            new_ops.append(op)
    block.ops = new_ops
    _merge_data_axes(program, (axis,))
    _bump_version(program)
    return n_groups


# -- steering ---------------------------------------------------------------------


def _steer_bucket_layout(report, items=None, bucket_bytes=4 << 20,
                         compute_pos=None, **_ctx):
    """``steer("bucket_layout", report, items=..., compute_pos=...)``: the
    measured bucket layout, or None where the report or the context cannot
    drive one (the caller plans by size)."""
    if report is None or items is None or compute_pos is None:
        return None
    return plan_buckets_profile(items, report, bucket_bytes, compute_pos)


from ..observability import steering as _steering  # noqa: E402

_steering.register_steerer(
    "bucket_layout", _steer_bucket_layout,
    "profile-guided gradient-bucket boundaries")
