"""Single-chip fusion rewrites: the fused optimizer update and the fused
epilogues.

Counterpart of ``paddle_tpu/core/fusion.py``:

- ``apply_fused_optimizer`` (``:143``): each sgd / momentum / adam /
  adamw instance's per-parameter update ops collapse into ONE
  ``fused_optimizer`` op. In the ``flat`` layout the instance's state is
  re-laid into flat zero-padded vars and one K4 kernel launch
  (``ops/cuda/fused_optimizer.py``) updates every parameter element per
  step; the ``chain`` layout keeps the per-parameter state and applies
  the same math pair by pair.
- ``apply_fused_epilogues`` (``:350``): adjacent forward chains
  ``elementwise_add -> {relu, gelu, tanh, sigmoid} [-> dropout]`` and
  ``elementwise_add -> layer_norm`` collapse into ``fused_bias_act`` and
  ``fused_residual_layer_norm`` (``ops/fused_ops.py``), which compose the
  same registered functions and re-emit every intermediate the pre-built
  backward reads: the same bits, fewer ops.

Knobs, read at a program's first run and baked in (``bench.py``'s
``_enable_fast_paths`` turns both on):

- ``PADDLE_TPU_FUSED_OPTIMIZER``: unset or off leaves programs alone; a
  truthy value is ``auto``, which picks ``flat`` exactly when the
  executor's device is a CUDA card, where K4 runs, and ``chain`` on the
  CPU; ``flat`` / ``chain`` force a layout.
- ``PADDLE_TPU_FUSED_EPILOGUE``: a truthy value fuses the epilogues.

``maybe_rewrite_single_chip`` applies the epilogue pass first, then the
optimizer pass, as the JAX package does. Each pass counts what it fused
(``compiler_engine.inc``: ``fusion.epilogue_chains``,
``fusion.optimizer_groups``, in the registry too while it is armed) and
moves the program's version on, so the step functions and captured graphs
key on the rewritten program. Both are ``checked_rewrite`` passes: under
``PADDLE_TPU_VERIFY_IR`` their contracts (``analysis/contracts.py``:
``fused_epilogue``, ``fused_optimizer``) run around them and the program
is verified after.
"""
from __future__ import annotations

import hashlib
import math
import os
from typing import Dict, List, Optional, Tuple

import torch

from . import compiler_engine as _ce
from .tensor import LoDTensor
from ..analysis.contracts import checked_rewrite

__all__ = ["fused_optimizer_mode", "fused_optimizer_enabled",
           "fused_epilogue_enabled", "maybe_rewrite_single_chip",
           "apply_fused_optimizer", "apply_fused_epilogues",
           "FUSED_OPTIMIZER_TYPES", "EPILOGUE_ACTS", "LANE_PAD"]

# optimizer op types the fused update supports, with the state slots each
# folds into the flat StateA / StateB vars
FUSED_OPTIMIZER_TYPES: Dict[str, Tuple[str, ...]] = {
    "sgd": (),
    "momentum": ("Velocity",),
    "adam": ("Moment1", "Moment2"),
    "adamw": ("Moment1", "Moment2"),
}

EPILOGUE_ACTS = ("relu", "gelu", "tanh", "sigmoid")

# flat state is zero-padded to a multiple of this, the JAX package's
# layout (its TPU kernel tiles [rows, 128]); K4 itself takes any size
LANE_PAD = 8 * 128

_TRUTHY = ("1", "true", "yes", "on")


def fused_optimizer_mode() -> Optional[str]:
    """``PADDLE_TPU_FUSED_OPTIMIZER``: unset/off -> None; truthy ->
    ``"auto"``; ``flat`` / ``chain`` force a layout."""
    raw = os.environ.get("PADDLE_TPU_FUSED_OPTIMIZER")
    if not raw:
        return None
    raw = raw.strip().lower()
    if raw in ("flat", "chain"):
        return raw
    return "auto" if raw in _TRUTHY else None


def fused_optimizer_enabled() -> bool:
    return fused_optimizer_mode() is not None


def fused_epilogue_enabled() -> bool:
    """``PADDLE_TPU_FUSED_EPILOGUE``: truthy fuses the epilogues."""
    raw = os.environ.get("PADDLE_TPU_FUSED_EPILOGUE")
    return bool(raw) and raw.strip().lower() in _TRUTHY


def maybe_rewrite_single_chip(program, scope, device: torch.device) -> None:
    """Executor entry point, called on every run. The knobs are read at a
    program's first run and baked in; later runs only resync the flat
    state after a startup re-run. The epilogue pass runs first, then the
    optimizer pass."""
    state = getattr(program, "_sc_fusion", None)
    if state is not None:
        if state and scope is not None:
            resync_sharded_state(program, scope)
        return
    mode = fused_optimizer_mode()
    if fused_epilogue_enabled():
        apply_fused_epilogues(program)
    n_opt = 0
    if mode is not None:
        n_opt = apply_fused_optimizer(program, scope, device, layout=mode)
    # the flat layout re-laid state into flat vars, which later runs
    # resync after a startup re-run; the chain layout has nothing to resync
    program._sc_fusion = bool(
        n_opt and getattr(program, "_sharded_flat_layout", None))


def _attrs_sig(attrs) -> Tuple:
    return tuple(sorted((k, repr(v)) for k, v in attrs.items()
                        if not k.startswith("_")))


def _splice_flat_state(block, scope, state_names, total, padded, dtype,
                       slot, device) -> torch.Tensor:
    """Concatenate the per-param accumulators named in ``state_names``
    (zeros where uninitialized) into one zero-padded flat tensor on
    ``device``."""
    from . import dtypes as _dt

    tdtype = _dt.to_torch_dtype(dtype)
    parts = []
    for sn in state_names:
        var = scope.find_var(sn)
        if var is not None and var.is_initialized():
            parts.append(var.raw().array.reshape(-1).to(device=device,
                                                         dtype=tdtype))
        else:
            parts.append(torch.zeros(math.prod(block.var(sn).shape),
                                     dtype=tdtype, device=device))
    flat = (torch.cat(parts) if parts
            else torch.zeros(0, dtype=tdtype, device=device))
    if flat.numel() != total:
        raise ValueError("fused optimizer: state %r totals %d elements, "
                         "params total %d" % (slot, flat.numel(), total))
    return torch.cat([flat, flat.new_zeros(padded - total)])


def _src_token(scope, name):
    """The var's current scope value object (None when absent or
    uninitialized): training never touches the retired per-param state
    vars, so a different object means a startup re-run re-initialized the
    var. The token holds the tensor itself, so its address is never
    reused while the token lives."""
    var = scope.find_var(name)
    if var is None or not var.is_initialized():
        return None
    return var.raw().array


def resync_sharded_state(program, scope) -> int:
    """After a startup re-run reset the retired per-param state vars (every
    source var's tensor replaced since the splice by a new one), rebuild
    the flat state from them. A scope that holds none of them (a fresh
    scope a checkpoint of the rewritten program was loaded into: the flat
    vars are its persistables, the per-param ones are not) keeps its flat
    state; the JAX package's rule (``parallel/collectives.py:590``) would
    zero it there. Returns the number of flat vars rebuilt."""
    layout = getattr(program, "_sharded_flat_layout", None)
    if not layout:
        return 0
    tokens = program._sharded_src_tokens
    block = program.global_block()
    n = 0
    for flat_name, (srcs, total, padded, dtype, slot) in layout.items():
        cur = tuple(_src_token(scope, sn) for sn in srcs)
        old = tokens[flat_name]
        signal = [(o, c) for o, c in zip(old, cur)
                  if o is not None or c is not None]
        if not signal or any(o is c or c is None for o, c in signal):
            continue
        device = scope.find_var(flat_name).raw().array.device
        scope.var(flat_name).set(LoDTensor(_splice_flat_state(
            block, scope, srcs, total, padded, dtype, slot, device)))
        tokens[flat_name] = cur
        n += 1
    return n


@checked_rewrite("fused_optimizer")
def apply_fused_optimizer(program, scope, device: torch.device,
                          layout: str = "auto") -> int:
    """Rewrite each supported optimizer instance's per-param update ops
    into ONE ``fused_optimizer`` op; returns the number of instances
    fused. Grouping and the groups spared (sparse or mixed-dtype grads,
    single members, members interleaved with unrelated readers or
    writers) follow the JAX pass exactly."""
    if getattr(program, "_fused_optimizer_applied", False):
        return 0
    program._fused_optimizer_applied = True
    if layout == "auto":
        layout = "flat" if torch.device(device).type == "cuda" else "chain"
    if layout not in ("flat", "chain"):
        raise ValueError("fused optimizer layout %r" % (layout,))
    from .. import framework

    block = program.global_block()
    ops = block.ops

    groups: Dict[Tuple, List[int]] = {}
    for i, op in enumerate(ops):
        if op.type not in FUSED_OPTIMIZER_TYPES:
            continue
        if not op.input("Param") or not op.input("Grad"):
            continue
        p = op.input("Param")[0]
        pv = block._find_var_recursive(p)
        if (pv is None or not pv.shape
                or not all(isinstance(s, int) and s > 0 for s in pv.shape)
                or getattr(pv, "type", "lod_tensor") != "lod_tensor"):
            continue
        gv = block._find_var_recursive(op.input("Grad")[0])
        if gv is not None and getattr(gv, "type", "") == "selected_rows":
            continue
        if gv is not None and getattr(gv, "dtype", None) and \
                str(gv.dtype) != str(pv.dtype):
            continue
        key = (op.type, _attrs_sig(op.attrs), op.input("LearningRate")[0],
               str(pv.dtype))
        groups.setdefault(key, []).append(i)

    n_groups = 0
    removed = set()
    replace_at: Dict[int, object] = {}
    for key, idxs in sorted(groups.items(), key=lambda kv: kv[1][0]):
        if len(idxs) < 2:
            continue  # a single update op is already one launch
        op_type, _, lr_name, dtype = key
        member_ops = [ops[i] for i in idxs]
        # the fused op lands at the first member's position: spare the
        # group if an op between its members reads a member's param or
        # state, or writes anything a member touches
        member_set = set(idxs)
        grads_set = {mop.input("Grad")[0] for mop in member_ops}
        guarded = {lr_name}
        for mop in member_ops:
            guarded.update(n for n in mop.input_arg_names if n)
            guarded.update(n for n in mop.output_arg_names if n)
        read_guard = guarded - grads_set

        def _clashes(j):
            if j in member_set:
                return False
            return any(n in read_guard for n in ops[j].input_arg_names) \
                or any(n in guarded for n in ops[j].output_arg_names)

        if any(_clashes(j) for j in range(idxs[0] + 1, idxs[-1])):
            continue

        params = [op.input("Param")[0] for op in member_ops]
        grads = [op.input("Grad")[0] for op in member_ops]
        sizes = [math.prod(block.var(p).shape) for p in params]
        total = sum(sizes)
        padded = -(-total // LANE_PAD) * LANE_PAD
        n_groups += 1
        sig = hashlib.sha1(("%s|%s" % (op_type, ",".join(
            "%s:%d" % t for t in zip(params, sizes)))).encode())
        gtag = sig.hexdigest()[:8]

        inputs = {"Param": params, "Grad": grads, "LearningRate": [lr_name]}
        outputs = {"ParamOut": params}
        for slot_key, slot in zip(("StateA", "StateB"),
                                  FUSED_OPTIMIZER_TYPES[op_type]):
            state_names = [op.input(slot)[0] for op in member_ops]
            if layout == "chain":
                inputs[slot_key] = state_names
                outputs[slot_key + "Out"] = state_names
                continue
            flat_name = "fused_opt_%s.%s" % (gtag, slot.lower())
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
        for scalar in ("Beta1Pow", "Beta2Pow"):
            names = [op.input(scalar) for op in member_ops]
            if all(n for n in names):
                inputs[scalar] = [n[0] for n in names]
                outputs[scalar + "Out"] = [n[0] for n in names]

        attrs = dict(member_ops[0].attrs)
        attrs.update({"op_type": op_type, "layout": layout,
                      "padded_size": int(padded), "use_pallas": True})
        fo = framework.Operator(block, "fused_optimizer", inputs, outputs,
                                attrs)
        fo._id = program._next_op_id()
        fo._role = member_ops[0]._role
        replace_at[idxs[0]] = fo
        removed.update(idxs)

    if not n_groups:
        return 0
    new_ops = []
    for i, op in enumerate(ops):
        if i in replace_at:
            new_ops.append(replace_at[i])
        if i not in removed:
            new_ops.append(op)
    block.ops = new_ops
    program._fused_optimizer_groups = n_groups
    program._next_op_id()  # a new version: caches key on the rewrite
    _ce.inc("fusion.optimizer_groups", n_groups)
    return n_groups


# -- fused epilogues ----------------------------------------------------------

def _single_writer_names(ops) -> set:
    """Names that exactly one op of ``ops`` writes."""
    counts: Dict[str, int] = {}
    for op in ops:
        for n in op.output_arg_names:
            if n:
                counts[n] = counts.get(n, 0) + 1
    return {n for n, c in counts.items() if c == 1}


def _first_backward_index(ops) -> int:
    """Index of the first backward op: one that carries ``_fwd_op_id`` or
    writes a ``@GRAD`` name (``len(ops)`` when there is none)."""
    from .registry import GRAD_SUFFIX

    for i, op in enumerate(ops):
        if "_fwd_op_id" in op.attrs or any(
                GRAD_SUFFIX in n for n in op.output_arg_names if n):
            return i
    return len(ops)


@checked_rewrite("fused_epilogue")
def apply_fused_epilogues(program) -> int:
    """Collapse adjacent forward epilogue chains into the fused ops:

    - ``elementwise_add -> act`` (act in EPILOGUE_ACTS), optionally
      ``-> dropout``  =>  ``fused_bias_act``
    - ``elementwise_add -> layer_norm``  =>  ``fused_residual_layer_norm``

    Only intermediates written once fuse (a name written twice is not a
    private edge of the chain), only before the first backward op, and
    the fused op emits every intermediate under its original name, so the
    pre-built grad ops read what they were built against. A fused dropout
    carries the absorbed op's id as ``_rng_op_id`` (not ``_fwd_op_id``,
    which marks backward ops) and so draws its mask. Returns the number
    of chains fused."""
    if getattr(program, "_fused_epilogue_applied", False):
        return 0
    program._fused_epilogue_applied = True
    from .. import framework

    block = program.global_block()
    ops = block.ops
    single = _single_writer_names(ops)
    bwd_start = _first_backward_index(ops)

    fused: List[Tuple[int, int, object]] = []  # (start, end exclusive, op)
    i = 0
    while i < bwd_start - 1:
        op_a = ops[i]
        if op_a.type != "elementwise_add" or len(op_a.output("Out")) != 1:
            i += 1
            continue
        a_out = op_a.output("Out")[0]
        if a_out not in single:
            i += 1
            continue
        op_b = ops[i + 1]
        new_op = None
        if op_b.type in EPILOGUE_ACTS and op_b.input("X") == [a_out] \
                and len(op_b.output("Out")) == 1:
            b_out = op_b.output("Out")[0]
            if b_out not in single:
                i += 1
                continue
            attrs = {"act": op_b.type,
                     "axis": op_a.attrs.get("axis", -1),
                     "approximate": bool(op_b.attrs.get("approximate",
                                                        False)),
                     "alpha": op_b.attrs.get("alpha", 0.02),
                     "dropout_prob": -1.0}
            outputs = {"Out": [b_out], "AddOut": [a_out]}
            end = i + 2
            op_c = ops[i + 2] if i + 2 < bwd_start else None
            if (op_c is not None and op_c.type == "dropout"
                    and op_c.input("X") == [b_out]
                    and not op_c.input("Seed")
                    and len(op_c.output("Out")) == 1
                    and op_c.output("Out")[0] in single):
                attrs.update({
                    "dropout_prob": float(
                        op_c.attrs.get("dropout_prob", 0.5)),
                    "is_test": bool(op_c.attrs.get("is_test", False)),
                    "fix_seed": bool(op_c.attrs.get("fix_seed", False)),
                    "seed": int(op_c.attrs.get("seed", 0) or 0),
                    "dropout_implementation": op_c.attrs.get(
                        "dropout_implementation", "downgrade_in_infer"),
                    "_rng_op_id": op_c._id or 0,
                })
                outputs = {"Out": op_c.output("Out"), "AddOut": [a_out],
                           "ActOut": [b_out]}
                if op_c.output("Mask"):
                    outputs["Mask"] = op_c.output("Mask")
                end = i + 3
            new_op = framework.Operator(
                block, "fused_bias_act",
                {"X": op_a.input("X"), "Y": op_a.input("Y")},
                outputs, attrs)
        elif op_b.type == "layer_norm" and op_b.input("X") == [a_out] \
                and not op_b.attrs.get("shard_axis") \
                and len(op_b.output("Y")) == 1 \
                and op_b.output("Y")[0] in single:
            outputs = {"Out": op_b.output("Y"), "AddOut": [a_out],
                       "Mean": op_b.output("Mean"),
                       "Variance": op_b.output("Variance")}
            new_op = framework.Operator(
                block, "fused_residual_layer_norm",
                {"X": op_a.input("X"), "Y": op_a.input("Y"),
                 "Scale": op_b.input("Scale"), "Bias": op_b.input("Bias")},
                outputs,
                {"axis": op_a.attrs.get("axis", -1),
                 "epsilon": op_b.attrs.get("epsilon", 1e-5),
                 "begin_norm_axis": op_b.attrs.get("begin_norm_axis", 1)})
            end = i + 2
        if new_op is None:
            i += 1
            continue
        new_op._id = program._next_op_id()
        fused.append((i, end, new_op))
        i = end

    if not fused:
        return 0
    new_ops: List = []
    k = 0
    for start, end, op in fused:
        new_ops.extend(ops[k:start])
        new_ops.append(op)
        k = end
    new_ops.extend(ops[k:])
    block.ops = new_ops
    program._next_op_id()  # a new version: caches key on the rewrite
    _ce.inc("fusion.epilogue_chains", len(fused))
    return len(fused)
