"""Op-by-op program interpreter.

Counterpart of ``paddle_tpu/core/executor_core.py``: for each op of a
block, read its inputs from the scope, call its function, write its outputs
back. ``Executor.run`` takes this route under ``FLAGS_check_nan_inf``, for
a program that the whole-program route declines (a host op that does not
fold, an op that is not registered; ``compiler_engine.untraceable_reasons``)
and for LoD feeds; every other program runs through
``core/compiler_engine`` (a CUDA graph on the card), which calls the same
ops through the helpers below. PyTorch runs eagerly, so there is no per-op
compile cache; kernels queue on the device's current stream and the host
loop runs ahead until a fetch copies a result back.

- Every op gets the executor's ``torch.device`` (``DEVICE_ATTR``) for the
  tensors it creates; an op marked ``needs_rng`` gets a ``torch.Generator``
  on that device seeded per (executor seed, step, op id), or from its
  ``seed`` attr when that is set, as the JAX package derives its seeds.
- A host op (``OpInfo.host_fn``) reads and writes the scope itself through
  ``_read_var`` / ``_write_var``, the names the JAX package's host ops call.
- Intermediates are freed after their last use (the eager-deletion plan),
  except feeds, fetches and persistables. The plan counts every reader,
  so a forward activation that a grad op reads lives until that grad op.
- Grad ops: a slot bound to ``""`` or ``"@EMPTY@"`` reads as None, every
  op learns which output slots it binds (``BOUND_OUTPUTS_ATTR``), and an
  output list may hold None where a grad is not produced (nothing is
  written for it). A grad op draws its RNG stream from its forward op's
  id (``_fwd_op_id``), so both see the same random numbers, and a fused
  forward op from the id of the RNG op it absorbed (``_rng_op_id``, set by
  ``core.fusion.apply_fused_epilogues``), so that a pre-built
  ``dropout_grad`` sees the fused op's mask.
- Feeds are written into the scope (a later run that leaves one out reads
  the last value, as the JAX package's interpreter does), staged by
  ``core.tensor.stage_feed``: float64 becomes float32.
- ``run_block(block, scope)`` runs a sub-block's ops in the scope it is
  given; the control-flow host ops (``ops/control_flow_ops.py``) call it
  with a child scope, once a trip of a ``while`` and once for a taken
  ``conditional_block``. A name a sub-block touches is never freed by the
  eager-deletion plan of its program's global block.
- Under ``FLAGS_check_nan_inf`` every floating output of each op is
  checked after the op runs; the first that holds an inf or a nan raises
  ``EnforceNotMet``, as in the JAX package. Every failure inside an op is
  annotated with the op's type, inputs and outputs
  (``enforce.annotate_op_error``).

- LoD, as in the JAX interpreter (its ``executor_core.py:164-330``):
  every op's inputs' LoDs are collected; a ``needs_lod`` op (and its grad
  op) gets them as ``attrs['_lod_<slot>']``; each output is written with
  the LoD its ``infer_lod`` names (``"propagate"``: the first input slot
  whose var carries one and is not persistable), and with none otherwise,
  so a reused name never keeps a stale LoD. A propagated LoD attaches only
  where the output's rows match it, and never to a persistable: a table
  grad or a parameter must not carry a sequence LoD into later batches.
- A ``SelectedRows`` (the embedding's ``is_sparse`` grad) is read and
  written as it is; the ops that take one (``sum``, the update ops)
  branch on it, as the JAX package's op bodies do.
  ``FLAGS_check_nan_inf`` checks its values too.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .cuda_graph import GraphCache
from .enforce import EnforceNotMet, annotate_op_error
from .flags import flag
from .registry import (BOUND_OUTPUTS_ATTR, DEVICE_ATTR, GENERATOR_ATTR,
                       LOD_ATTR_PREFIX, OpInfoMap)
from .scope import Scope
from .tensor import LoDTensor, LoDTensorArray, SelectedRows, stage_feed


class RNGState:
    """Host-side seed counter; folded per op id so every RNG op in a step
    draws its own stream, and every step advances."""

    def __init__(self, seed: int = 0):
        self.seed = seed or int(np.random.randint(1, 2**31 - 1))
        self.step = 0

    def next_seed(self, op_id: int) -> int:
        return (self.seed * 1000003 + self.step * 8191
                + op_id * 131) & 0xFFFFFFFF

    def advance(self):
        self.step += 1


_UNBOUND = ("", "@EMPTY@")


def op_attrs(info, op, device: torch.device) -> Dict:
    """The attrs an op's function is called with: the registered defaults,
    the op's own attrs, the device and the bound output slots."""
    attrs = dict(info.attrs)
    attrs.update(op.attrs)
    attrs[DEVICE_ATTR] = device
    attrs[BOUND_OUTPUTS_ATTR] = tuple(
        s.name for s in info.outputs if op.output(s.name))
    return attrs


def rng_seed(rng: RNGState, attrs: Dict, op) -> int:
    """This step's seed of an RNG op: its ``seed`` attr when set, else one
    folded from the step and an op id: the forward op's for a grad op
    (``_fwd_op_id``), the absorbed RNG op's for a fused forward op
    (``_rng_op_id``), else the op's own."""
    seed = int(attrs.get("seed", 0) or 0)
    if seed > 0:
        return seed
    return rng.next_seed(attrs.get("_fwd_op_id",
                                   attrs.get("_rng_op_id", op._id or 0)))


def gather_inputs(info, op, read) -> Dict:
    """Slot -> value (a list for a duplicable slot, None when unbound), each
    name read through ``read``."""
    ins = {}
    for slot in info.inputs:
        names = op.input(slot.name)
        if not names:
            ins[slot.name] = None
            continue
        vals = [read(n) for n in names]
        ins[slot.name] = vals if slot.duplicable else vals[0]
    return ins


def gather_inputs_and_lods(info, op, scope):
    """``gather_inputs`` from a scope, with each slot's LoDs: (ins, slot ->
    tuple of each name's LoD as nested tuples, for the slots where one
    carries a LoD)."""
    ins, in_lods = {}, {}
    for slot in info.inputs:
        names = op.input(slot.name)
        if not names:
            ins[slot.name] = None
            continue
        vals, lods = [], []
        for n in names:
            var = scope.find_var(n) if n not in _UNBOUND else None
            h = var.raw() if var is not None and var.is_initialized() \
                else None
            if isinstance(h, LoDTensor):
                vals.append(h.array)
                lods.append(tuple(tuple(level) for level in h.lod()))
            else:
                vals.append(h)
                lods.append(())
        if any(lods):
            in_lods[slot.name] = tuple(lods)
        ins[slot.name] = vals if slot.duplicable else vals[0]
    return ins, in_lods


def infer_out_lods(info, op, in_lods: Dict, attrs: Dict) -> Dict:
    """(output slot, index) -> the LoD the op's ``infer_lod`` gives it."""
    if info.infer_lod is None:
        return {}
    if callable(info.infer_lod):
        return dict(info.infer_lod(in_lods, attrs) or {})
    blk = op.block
    for slot in info.inputs:
        lods = in_lods.get(slot.name)
        if not (lods and lods[0]):
            continue
        bv = blk._find_var_recursive(op.input(slot.name)[0])
        if bv is not None and bv.persistable:
            continue  # a parameter (lookup_table's W) is never the source
        return {(s.name, i): lods[0] for s in info.outputs
                for i in range(len(op.output(s.name)))}
    return {}


def _lod_for(op, name, value, lod):
    """``lod`` where it may attach to output ``name``: its last level
    must end at the value's row count, and the var must not be
    persistable."""
    if not lod or not isinstance(value, torch.Tensor):
        return None
    if value.dim() == 0 or int(value.shape[0]) != int(lod[-1][-1]):
        return None
    bv = op.block._find_var_recursive(name)
    if bv is not None and bv.persistable:
        return None
    return lod


def call_op(info, op, ins: Dict, attrs: Dict,
            phase: str = "execution") -> Dict:
    try:
        return info.fn(ins, attrs)
    except Exception as e:
        annotate_op_error(e, op, phase)
        raise


def output_pairs(info, op, outs: Dict):
    """(name, value) of every output the op produced and binds."""
    for slot in info.outputs:
        o = outs.get(slot.name)
        if o is None:
            continue
        vals = o if slot.duplicable else [o]
        for n, v in zip(op.output(slot.name), vals):
            if v is not None and n not in _UNBOUND:
                yield n, v


class CoreExecutor:
    def __init__(self, device: torch.device):
        self.device = device
        self.rng = RNGState()
        self._gc_plans: Dict = {}
        # the whole-program route's caches (core/compiler_engine): step
        # functions, captured graphs and the keys run once eagerly
        self.steps: "OrderedDict" = OrderedDict()
        self.graphs = GraphCache(self.device)
        self.warm: "OrderedDict" = OrderedDict()
        # the data-parallel engine's runs (parallel/engine.py)
        self.dp_runs: Dict = {}
        self.dp_last = None

    def close(self) -> None:
        """Drop the step functions and free the captured graphs."""
        self.graphs.clear()
        self.warm.clear()
        self.steps.clear()
        self.dp_runs.clear()
        self.dp_last = None

    def _read_var(self, scope: Scope, name: str):
        if name in _UNBOUND:
            return None
        var = scope.find_var(name)
        if var is None or not var.is_initialized():
            return None
        h = var.raw()
        return h.array if isinstance(h, LoDTensor) else h

    def _write_var(self, scope: Scope, name: str, value, lod=None) -> None:
        if name in _UNBOUND or value is None:
            return
        scope.var(name).set(value if isinstance(
            value, (LoDTensor, LoDTensorArray, SelectedRows))
            else LoDTensor(value, lod))

    def run_op(self, op, scope: Scope) -> None:
        try:
            self._run_op_impl(op, scope)
        except Exception as e:
            annotate_op_error(e, op, "execution")
            raise

    def _run_op_impl(self, op, scope: Scope) -> None:
        info = OpInfoMap.instance().get(op.type)
        if info.host_fn is not None:
            info.host_fn(self, op, scope)
            self._maybe_check_nan_inf(op, scope)
            return
        ins, in_lods = gather_inputs_and_lods(info, op, scope)
        attrs = op_attrs(info, op, self.device)
        if info.needs_lod:
            for k, v in in_lods.items():
                attrs[LOD_ATTR_PREFIX + k] = v
        if info.needs_rng:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(rng_seed(self.rng, attrs, op))
            attrs[GENERATOR_ATTR] = gen
        outs = call_op(info, op, ins, attrs)
        out_lods = infer_out_lods(info, op, in_lods, attrs) \
            if in_lods or callable(info.infer_lod) else {}
        for slot in info.outputs:
            o = outs.get(slot.name)
            if o is None:
                continue
            vals = o if slot.duplicable else [o]
            for i, (n, v) in enumerate(zip(op.output(slot.name), vals)):
                if v is None or n in _UNBOUND:
                    continue
                lod = out_lods.get((slot.name, i))
                self._write_var(scope, n, v,
                                _lod_for(op, n, v, lod) if lod else None)
        self._maybe_check_nan_inf(op, scope)

    def _maybe_check_nan_inf(self, op, scope: Scope) -> None:
        """``FLAGS_check_nan_inf``: every floating output of the op just
        run must be finite (the reference's operator.cc check)."""
        if not flag("check_nan_inf"):
            return
        for n in op.output_arg_names:
            t = self._read_var(scope, n)
            if isinstance(t, SelectedRows):
                t = t.get_tensor().array  # a sparse grad's values
            if isinstance(t, torch.Tensor) and t.is_floating_point() \
                    and not bool(torch.isfinite(t).all()):
                raise EnforceNotMet(
                    "Operator %r output %r contains Inf/Nan "
                    "(FLAGS_check_nan_inf)" % (op.type, n))

    def run_block(self, block, scope: Scope) -> None:
        """Run ``block``'s ops in ``scope``, in order, freeing nothing."""
        for op in block.ops:
            self.run_op(op, scope)

    @staticmethod
    def build_gc_plan(block, protect):
        """Op index -> names whose last use that op is (never feeds,
        fetches, persistables, or a name a sub-block of the program
        touches: a while or conditional body reads and writes the
        parent's vars by name)."""
        protect = set(protect)
        prog = getattr(block, "program", None)
        for sub in (prog.blocks[1:] if prog is not None else ()):
            for op in sub.ops:
                protect.update(op.input_arg_names)
                protect.update(op.output_arg_names)
        last_use: Dict[str, int] = {}
        for i, op in enumerate(block.ops):
            for name in op.input_arg_names + op.output_arg_names:
                last_use[name] = i
        plan: Dict[int, list] = {}
        for name, i in last_use.items():
            if name in protect or name in _UNBOUND:
                continue
            v = block._find_var_recursive(name)
            if v is None or v.persistable:
                continue
            plan.setdefault(i, []).append(name)
        return plan

    def run_program(self, program, scope: Scope, feed: Optional[Dict] = None,
                    fetch_list: Optional[Sequence] = None,
                    return_numpy: bool = True):
        feed = feed or {}
        for name, value in feed.items():
            lod = None
            if isinstance(value, LoDTensor):
                value, lod = value.array, value.lod()
            # a host array is copied, never aliased by the scope
            staged = stage_feed(value).to(
                self.device, copy=not isinstance(value, torch.Tensor))
            self._write_var(scope, name, LoDTensor(staged, lod))
        fetch_names = [f if isinstance(f, str) else f.name
                       for f in (fetch_list or [])]
        block = program.global_block()
        key = (program._uid, len(block.ops), frozenset(feed),
               tuple(fetch_names))
        plan = self._gc_plans.get(key)
        if plan is None:
            plan = self.build_gc_plan(block, set(feed) | set(fetch_names))
            if len(self._gc_plans) >= 64:
                self._gc_plans.pop(next(iter(self._gc_plans)))
            self._gc_plans[key] = plan
        for i, op in enumerate(block.ops):
            self.run_op(op, scope)
            for name in plan.get(i, ()):
                scope.erase(name)
        self.rng.advance()

        results = []
        for name in fetch_names:
            var = scope.find_var(name)
            if var is None or not var.is_initialized():
                raise RuntimeError("fetch variable %r not produced" % name)
            h = var.raw()
            if isinstance(h, SelectedRows):  # fetched dense, as in JAX
                h = LoDTensor(h.to_dense())
            results.append(h.numpy() if return_numpy else h)
        return results
