"""Eager Tracer and tape autograd.

Counterpart of ``paddle_tpu/dygraph/tracer.py``. ``Tracer.trace_op`` runs
an op's registered function at once; when an input needs a gradient it
runs it with autograd on over detached leaves of those inputs and keeps
that graph in a ``TapeRecord`` (the JAX package keeps the ``jax.vjp``
pullback). The record's pullback is ``torch.autograd.grad(outputs,
leaves, cotangents)``: the op's own backward over the saved forward, never
a second forward. So a ``flash_attention`` op launches K1 forward and its
pullback K2 and K3 (``FlashAttentionFunction``).

``BasicEngine.backward`` walks the tape in reverse and sums cotangents
(grads accumulate over calls until ``clear_gradient``; ``stop_gradient``
and ``no_grad`` hold; ``retain_graph=False`` frees each record as it is
pulled and drops the tape; only floating inputs are differentiated).
``PartialGradEngine`` is ``fluid.dygraph.grad``: grads of some inputs,
``.grad`` untouched, and with ``create_graph=True`` the backward itself is
taped (its grads are differentiated again: second order).

Lazy mode (``guard(lazy=True)``, ``lazy.py``): ops, pullbacks, grad sums
and optimizer updates queue on the ``LazyEngine``; shapes come from the
op run on ``meta`` tensors, cached per signature.

RNG: an op marked ``needs_rng`` draws from a ``torch.Generator`` on the
tracer's device seeded with the tracer's per-op seed (its ``seed`` attr
when set, else a counter that starts at a random value), as the JAX
package derives its per-op keys; under a captured flush the generator is
the graph's, seeded before each replay.
"""
from __future__ import annotations

import contextlib
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.registry import (BOUND_OUTPUTS_ATTR, DEVICE_ATTR,
                             GENERATOR_ATTR, OpInfoMap)
from .lazy import aval_of, is_pending, pull
from .varbase import ParamBase, VarBase

_active_tracer: Optional["Tracer"] = None


def _canon_attr(v):
    """Hashable, content-faithful form of an attr value: an array by its
    shape, dtype and a digest of its bytes (``repr`` elides the middle of
    a large array, which would alias two ops onto one cached plan)."""
    if isinstance(v, np.ndarray):
        return ("ndarray", tuple(v.shape), v.dtype.str, hashlib.sha1(
            np.ascontiguousarray(v).tobytes()).hexdigest())
    if isinstance(v, (list, tuple)):
        return tuple(_canon_attr(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _canon_attr(x)) for k, x in v.items()))
    return v


def attrs_signature(attrs: Dict) -> Tuple:
    """Stable, hashable signature of an op's attrs, safe for plan-cache
    keys."""
    return tuple(sorted((k, _canon_attr(v)) for k, v in attrs.items()
                        if k not in (DEVICE_ATTR, GENERATOR_ATTR)))


def current_tracer() -> Optional["Tracer"]:
    return _active_tracer


def _set_tracer(t):
    global _active_tracer
    _active_tracer = t


class TapeRecord:
    """One traced op on the tape: the VarBases in (``in_vars``, aligned
    with ``leaves``) and out (``out_vars``, aligned with ``outs``); eagerly
    the op's autograd graph (``leaves``, ``outs``), in lazy mode
    ``lazy_vjp(cotangent handles) -> grad handles``, which queues a
    backward node."""

    __slots__ = ("op_type", "in_vars", "out_vars", "leaves", "outs",
                 "lazy_vjp", "__weakref__")

    def __init__(self, op_type, in_vars, out_vars, leaves=None, outs=None,
                 lazy_vjp=None):
        self.op_type = op_type
        self.in_vars = in_vars
        self.out_vars = out_vars
        self.leaves = leaves
        self.outs = outs
        self.lazy_vjp = lazy_vjp

    def pull(self, cots, retain=False, create_graph=False):
        """Grads of ``in_vars`` from cotangents aligned with ``out_vars``
        (None where an output has none)."""
        if self.leaves is None:
            raise RuntimeError(
                "the tape record of %r was freed by an earlier backward; "
                "pass retain_graph=True to pull it again" % self.op_type)
        return pull(self.leaves, self.outs, cots, retain=retain,
                    create_graph=create_graph)

    def release(self):
        self.leaves = self.outs = None


def _as_var(v):
    return v if isinstance(v, VarBase) else VarBase(v, stop_gradient=True)


def _flat_outputs(info, outs):
    """(flat outputs in slot order, [(slot, count)])."""
    flat, struct = [], []
    for s in info.outputs:
        o = outs.get(s.name)
        if o is None:
            continue
        if s.duplicable:
            flat.extend(o)
            struct.append((s.name, len(o)))
        else:
            flat.append(o)
            struct.append((s.name, 1))
    return flat, struct


class BasicEngine:
    """Backward over the tape (reference imperative/basic_engine.cc)."""

    def __init__(self, tracer):
        self.tracer = tracer

    def backward(self, loss: VarBase, retain_graph=False):
        if loss._array is None:
            raise ValueError("backward() on uninitialized VarBase")
        if self.tracer.lazy_engine is not None:
            return self._backward_lazy(loss, retain_graph)
        tape = self.tracer.tape
        grads: Dict[int, torch.Tensor] = {
            id(loss): torch.ones_like(loss._force())}
        alive: Dict[int, VarBase] = {id(loss): loss}
        for rec in reversed(tape):
            if not any(id(ov) in grads for ov in rec.out_vars):
                continue
            in_grads = rec.pull([grads.get(id(ov)) for ov in rec.out_vars],
                                retain=retain_graph)
            if not retain_graph:
                rec.release()
            for iv, g in zip(rec.in_vars, in_grads):
                prev = grads.get(id(iv))
                grads[id(iv)] = g if prev is None else prev + g
                alive[id(iv)] = iv
        # deposit on every var that takes a gradient
        for vid, v in alive.items():
            if not v.stop_gradient and vid in grads:
                g = grads[vid]
                v._grad = g if v._grad is None else v._grad + g
        if not retain_graph:
            tape.clear()

    def _backward_lazy(self, loss: VarBase, retain_graph=False):
        """The same walk, each pullback and grad sum queued on the
        LazyEngine: the backward joins the step's flush."""
        eng = self.tracer.lazy_engine
        tape = self.tracer.tape
        grads: Dict[int, object] = {id(loss): eng.ones_like(loss._array)}
        alive: Dict[int, VarBase] = {id(loss): loss}
        for rec in reversed(tape):
            if not any(id(ov) in grads for ov in rec.out_vars):
                continue
            cots = [grads.get(id(ov)) for ov in rec.out_vars]
            if rec.lazy_vjp is not None:
                in_grads = rec.lazy_vjp(cots)
            else:
                # an eagerly traced record: its pullback runs now
                in_grads = rec.pull([c.force() if is_pending(c) else c
                                     for c in cots], retain=retain_graph)
            for iv, g in zip(rec.in_vars, in_grads):
                prev = grads.get(id(iv))
                grads[id(iv)] = g if prev is None else eng.add(prev, g)
                alive[id(iv)] = iv
        for vid, v in alive.items():
            if not v.stop_gradient and vid in grads:
                g = grads[vid]
                v._grad = g if v._grad is None else eng.add(v._grad, g)
        if not retain_graph:
            tape.clear()


class Tracer:
    def __init__(self, lazy=False, device=None):
        self.device = torch.device(device if device is not None else "cpu")
        self.tape: List[TapeRecord] = []
        self.engine = BasicEngine(self)
        self._params: Dict[str, ParamBase] = {}
        self._no_grad = False
        self.train_mode = True
        self._seed_counter = int(np.random.randint(1, 2**31 - 1))
        self.lazy_engine = None
        if lazy:
            from .lazy import LazyEngine

            self.lazy_engine = LazyEngine(self.device)
        # (op_type, attrs_sig, layout, in_avals) -> (out_avals, struct)
        self._aval_cache: Dict = {}
        # (aval_cache_key, stop-gradient pattern) -> wrt positions
        self._wrt_cache: Dict = {}

    def flush(self):
        if self.lazy_engine is not None:
            self.lazy_engine.flush()

    # -- parameter registry (LayerHelper uses this in dygraph mode) -------
    def register_parameter(self, p: ParamBase):
        self._params[p.name] = p

    def get_parameter(self, name) -> Optional[ParamBase]:
        return self._params.get(name)

    def all_parameters(self):
        return list(self._params.values())

    # -- no-grad switch ---------------------------------------------------
    @contextlib.contextmanager
    def no_grad_guard(self):
        old = self._no_grad
        self._no_grad = True
        try:
            yield
        finally:
            self._no_grad = old

    # -- one op -----------------------------------------------------------
    def _op_attrs(self, info, attrs, outputs):
        """The attrs an op's function is called with: the registered
        defaults, the caller's attrs, the bound output slots and the
        device; an RNG op's seed; the signature of what varies (the
        caller's attrs and the bound slots: the defaults are the op
        type's). Returns (attrs, seed or None, signature)."""
        given = dict(attrs or {})
        seed = None
        if info.needs_rng:
            self._seed_counter += 1
            seed = (max(int(given.get("seed", 0) or 0), 0)
                    or (self._seed_counter & 0xFFFFFFFF))
            if "is_test" in info.attrs and "is_test" not in given:
                given["is_test"] = not self.train_mode
        bound = tuple(s.name for s in info.outputs
                      if not outputs or s.name in outputs)
        full = dict(info.attrs)
        full.update(given)
        full[BOUND_OUTPUTS_ATTR] = bound
        full[DEVICE_ATTR] = self.device
        return full, seed, (attrs_signature(given), bound)

    def _bind_outputs(self, info, struct, values, outputs, requires_grad):
        """Out-VarBases (the caller's, when it gave them, so that the tape
        and its code share them) holding ``values``."""
        result: Dict[str, List[VarBase]] = {}
        flat: List[VarBase] = []
        k = 0
        for slot_name, count in struct:
            slot = next(s for s in info.outputs if s.name == slot_name)
            provided = (outputs or {}).get(slot_name)
            plist = (list(provided) if isinstance(provided, (list, tuple))
                     else [provided] if provided is not None else [])
            vs = []
            for j in range(count):
                ov = plist[j] if j < len(plist) and \
                    isinstance(plist[j], VarBase) else VarBase(None)
                ov._array = values[k]
                ov.stop_gradient = (not requires_grad) or slot.no_grad
                k += 1
                vs.append(ov)
                flat.append(ov)
            result[slot_name] = vs
        return result, flat

    def trace_op(self, op_type, inputs, outputs=None, attrs=None,
                 stop_gradient=False):
        """Run an op; returns {slot: [VarBase]}. ``outputs`` may name
        VarBases to fill (LayerHelper's); fresh ones are made for the
        rest."""
        info = OpInfoMap.instance().get(op_type)
        if info.host_fn is not None:
            raise RuntimeError("host op %r is not usable in dygraph"
                               % op_type)
        if self.lazy_engine is not None:
            return self._trace_op_lazy(info, op_type, inputs, outputs,
                                       attrs, stop_gradient)

        var_map: Dict[str, object] = {}
        in_map: Dict[str, object] = {}
        for slot in info.inputs:
            arg = (inputs or {}).get(slot.name)
            if arg is None or (isinstance(arg, (list, tuple)) and not arg):
                var_map[slot.name] = in_map[slot.name] = None
                continue
            vs = [_as_var(a) for a in (arg if isinstance(arg, (list, tuple))
                                       else [arg])]
            var_map[slot.name] = vs if slot.duplicable else vs[0]
            arrs = [v._force() for v in vs]
            in_map[slot.name] = arrs if slot.duplicable else arrs[0]
        attrs, seed, _ = self._op_attrs(info, attrs, outputs)
        if seed is not None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            attrs[GENERATOR_ATTR] = gen

        # differentiable leaves
        leaves: List[torch.Tensor] = []
        in_vars: List[VarBase] = []
        if not self._no_grad and not stop_gradient and info.grad is not None:
            for slot in info.inputs:
                vs = var_map.get(slot.name)
                if slot.no_grad or vs is None:
                    continue
                for i, v in enumerate(vs if isinstance(vs, list) else [vs]):
                    if v.stop_gradient or not v._array.is_floating_point():
                        continue
                    leaf = v._array.detach().requires_grad_(True)
                    if isinstance(vs, list):
                        in_map[slot.name] = list(in_map[slot.name])
                        in_map[slot.name][i] = leaf
                    else:
                        in_map[slot.name] = leaf
                    leaves.append(leaf)
                    in_vars.append(v)
        requires_grad = bool(leaves)
        if requires_grad:
            with torch.enable_grad():
                flat, struct = _flat_outputs(info, info.fn(in_map, attrs))
        else:
            with torch.no_grad():
                flat, struct = _flat_outputs(info, info.fn(in_map, attrs))
        values = [o.detach() if isinstance(o, torch.Tensor) else o
                  for o in flat]
        result, out_vars = self._bind_outputs(info, struct, values, outputs,
                                              requires_grad)
        if requires_grad:
            self.tape.append(TapeRecord(op_type, in_vars, out_vars,
                                        leaves=leaves, outs=list(flat)))
        return result

    def _trace_op_lazy(self, info, op_type, inputs, outputs, attrs,
                       stop_gradient):
        """Queue the op: out-VarBases hold PendingValues whose shapes come
        from the op run on meta tensors (cached per signature)."""
        eng = self.lazy_engine
        var_map: Dict[str, object] = {}
        handles: List[object] = []
        flat_vars: List[VarBase] = []   # aligned with handles
        layout: List[Tuple[str, Optional[int]]] = []  # (slot, n or None)
        for slot in info.inputs:
            arg = (inputs or {}).get(slot.name)
            if arg is None or (isinstance(arg, (list, tuple)) and not arg):
                var_map[slot.name] = None
                continue
            vs = [_as_var(a) for a in (arg if isinstance(arg, (list, tuple))
                                       else [arg])]
            var_map[slot.name] = vs if slot.duplicable else vs[0]
            layout.append((slot.name, len(vs) if slot.duplicable else None))
            handles.extend(v._array for v in vs)
            flat_vars.extend(vs)
        attrs, seed, attrs_sig = self._op_attrs(info, attrs, outputs)
        layout_t = tuple(layout)
        in_avals = tuple(aval_of(h) for h in handles)
        # the slot layout is part of the identity: two dispensable-slot
        # patterns may have equal avals but bind inputs differently
        cache_key = (op_type, attrs_sig, layout_t, in_avals)
        cached = self._aval_cache.get(cache_key)
        if cached is None:
            cached = self._lazy_op(info, attrs, layout_t, in_avals)
            self._aval_cache[cache_key] = cached
        op_fn, out_avals, struct = cached

        # differentiable inputs, cached per (signature, stop-gradient
        # pattern): the checks are hot at BERT scale
        wrt: Tuple[int, ...] = ()
        if not self._no_grad and not stop_gradient and info.grad is not None:
            sg = tuple(v.stop_gradient for v in flat_vars)
            wk = (cache_key, sg)
            wrt = self._wrt_cache.get(wk)
            if wrt is None:
                pos, k = [], 0
                for name, n in layout_t:
                    slot = info.input_slot(name)
                    for _ in range(n or 1):
                        if not slot.no_grad and not flat_vars[k].stop_gradient \
                                and in_avals[k][1].is_floating_point:
                            pos.append(k)
                        k += 1
                wrt = tuple(pos)
                self._wrt_cache[wk] = wrt
        requires_grad = bool(wrt)
        node = eng.add_node(op_fn, handles, out_avals,
                            ("op", op_type, attrs_sig, layout_t),
                            wrt=wrt or None, seed=seed)
        result, out_vars = self._bind_outputs(info, struct, node.outs,
                                              outputs, requires_grad)
        if requires_grad:
            self._tape_lazy(op_type, node, [flat_vars[p] for p in wrt],
                            out_vars, ("vjp", op_type, attrs_sig, layout_t,
                                       wrt))
        return result

    @staticmethod
    def _lazy_op(info, attrs, layout_t, in_avals):
        """(node function, output avals, output slot structure) of an op
        with these attrs over inputs of this layout and these avals: the
        op run on meta tensors once. The function is shared by every
        node of this signature."""
        slot_names = [s.name for s in info.inputs]

        def rebuild(vals):
            m = dict.fromkeys(slot_names)
            k = 0
            for name, n in layout_t:
                if n is None:
                    m[name] = vals[k]
                    k += 1
                else:
                    m[name] = list(vals[k:k + n])
                    k += n
            return m

        def op_fn(vals, gen, _attrs=attrs):
            if gen is not None:
                _attrs = dict(_attrs)
                _attrs[GENERATOR_ATTR] = gen
            return tuple(_flat_outputs(info, info.fn(rebuild(vals),
                                                     _attrs))[0])

        meta_attrs = dict(attrs)
        meta_attrs[DEVICE_ATTR] = torch.device("meta")
        metas = [torch.empty(s, dtype=d, device="meta") for s, d in in_avals]
        flat, struct = _flat_outputs(info, info.fn(rebuild(metas),
                                                   meta_attrs))
        return op_fn, [aval_of(o) for o in flat], struct

    def _tape_lazy(self, op_type, node, in_vars, out_vars, sig):
        """Tape a queued forward node: its ``lazy_vjp`` queues a backward
        node that names it."""
        eng = self.lazy_engine

        def lazy_vjp(cot_handles, _node=node, _sig=sig):
            present = tuple(j for j, c in enumerate(cot_handles)
                            if c is not None)
            grad_avals = [aval_of(_node.ins[p]) for p in _node.wrt]
            return eng.add_node(
                None, list(_node.ins) + [cot_handles[j] for j in present],
                grad_avals, _sig + (present,), fwd=_node,
                cots=present).outs

        rec = TapeRecord(op_type, in_vars, out_vars, lazy_vjp=lazy_vjp)
        # a flush before the backward must materialize the inputs a
        # backward that runs its forward again reads
        for h in node.ins:
            if is_pending(h) and not h._resolved:
                h.add_owner(rec, None)
        self.tape.append(rec)

    @staticmethod
    def _static_index(idx) -> bool:
        """True when idx is a plain Python index, which a plan signature
        can carry."""
        if isinstance(idx, (int, slice, type(None), type(Ellipsis))):
            return True
        if isinstance(idx, tuple):
            return all(Tracer._static_index(i) for i in idx)
        return False

    def trace_getitem(self, var: VarBase, idx):
        """``var[idx]`` traced eagerly (a static index under lazy dygraph
        queues instead: ``_trace_getitem_lazy``)."""
        leaf = var._force().detach().requires_grad_(True)
        with torch.enable_grad():
            out = leaf[idx]
        ov = VarBase(None, stop_gradient=False)
        ov._array = out.detach()
        self.tape.append(TapeRecord("getitem", [var], [ov], leaves=[leaf],
                                    outs=[out]))
        return ov

    def _trace_getitem_lazy(self, var: VarBase, idx):
        """Queue a subscript (a flush for x[i] would defeat lazy mode)."""
        eng = self.lazy_engine
        h = var._array
        shape, dtype = aval_of(h)
        out_aval = aval_of(torch.empty(shape, dtype=dtype,
                                       device="meta")[idx])
        grads = not var.stop_gradient and not self._no_grad
        node = eng.add_node(lambda vals, gen: (vals[0][idx],), [h],
                            [out_aval], ("getitem", repr(idx)),
                            wrt=(0,) if grads else None)
        ov = VarBase(None, stop_gradient=not grads)
        ov._array = node.outs[0]
        if grads:
            self._tape_lazy("getitem", node, [var], [ov],
                            ("getitem_vjp", repr(idx)))
        return ov


class PartialGradEngine:
    """``fluid.dygraph.grad`` (reference imperative/partial_grad_engine.cc):
    walk the tape between ``outputs`` and ``inputs`` and return grads
    without touching ``.grad``. With ``create_graph=True`` each pullback
    runs with ``create_graph`` over leaves of its cotangents and is taped
    itself, so grad-of-grad works."""

    def __init__(self, tracer):
        self.tracer = tracer

    def run(self, outputs, inputs, grad_outputs=None, retain_graph=None,
            create_graph=False, only_inputs=True, allow_unused=False,
            no_grad_vars=None):
        if not only_inputs:
            raise NotImplementedError("only_inputs=False is not supported")
        outputs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        no_grad_ids = {id(v) for v in (no_grad_vars or [])}
        if retain_graph is None:
            retain_graph = create_graph
        if self.tracer.lazy_engine is not None:
            if create_graph:
                raise NotImplementedError(
                    "dygraph.grad(create_graph=True) needs the eager "
                    "tracer — use fluid.dygraph.guard(lazy=False) for "
                    "higher-order gradients")
            return self._run_lazy(outputs, inputs, grad_outputs,
                                  retain_graph, allow_unused, no_grad_ids)

        gvars: Dict[int, VarBase] = {}
        for i, o in enumerate(outputs):
            go = grad_outputs[i] if grad_outputs is not None and \
                i < len(grad_outputs) else None
            if go is None:
                go = VarBase(torch.ones_like(o._force()),
                             stop_gradient=not create_graph)
            gvars[id(o)] = _as_var(go)

        tape = self.tracer.tape
        for rec in reversed(list(tape)):
            if not any(id(ov) in gvars for ov in rec.out_vars):
                continue
            cot_vars = [gvars.get(id(ov)) for ov in rec.out_vars]
            if create_graph:
                # the cotangents as leaves too: d(grad)/d(cotangent) is
                # part of the taped backward
                present = [j for j, c in enumerate(cot_vars) if c is not None]
                c_leaves = [None] * len(cot_vars)
                for j in present:
                    c_leaves[j] = cot_vars[j]._force().detach() \
                        .requires_grad_(True)
                with torch.enable_grad():
                    in_grads = rec.pull(c_leaves, retain=True,
                                        create_graph=True)
                new_gvars = []
                for g in in_grads:
                    gv = VarBase(None, stop_gradient=False)
                    gv._array = g.detach()
                    new_gvars.append(gv)
                tape.append(TapeRecord(
                    rec.op_type + "_grad",
                    list(rec.in_vars) + [cot_vars[j] for j in present],
                    new_gvars,
                    leaves=list(rec.leaves) + [c_leaves[j] for j in present],
                    outs=list(in_grads)))
            else:
                in_grads = rec.pull([None if c is None else c._force()
                                     for c in cot_vars], retain=True)
                new_gvars = [VarBase(g, stop_gradient=True)
                             for g in in_grads]
            for iv, gv in zip(rec.in_vars, new_gvars):
                if id(iv) in no_grad_ids:
                    continue
                prev = gvars.get(id(iv))
                if prev is None:
                    gvars[id(iv)] = gv
                elif create_graph:
                    a = prev._force().detach().requires_grad_(True)
                    b = gv._force().detach().requires_grad_(True)
                    with torch.enable_grad():
                        s = a + b
                    sv = VarBase(None, stop_gradient=False)
                    sv._array = s.detach()
                    tape.append(TapeRecord("grad_add", [prev, gv], [sv],
                                           leaves=[a, b], outs=[s]))
                    gvars[id(iv)] = sv
                else:
                    gvars[id(iv)] = VarBase(prev._force() + gv._force(),
                                            stop_gradient=True)

        results = []
        for v in inputs:
            gv = gvars.get(id(v))
            if gv is None and not allow_unused:
                raise ValueError(
                    "one of the inputs is unreachable from outputs; pass "
                    "allow_unused=True to get None for it")
            results.append(gv)
        if not retain_graph:
            # the graph is freed after grad() unless retained
            tape.clear()
        return results

    def _run_lazy(self, outputs, inputs, grad_outputs, retain_graph,
                  allow_unused, no_grad_ids):
        """grad() under lazy dispatch: the walk queues backward nodes
        (first order; the results are detached VarBases)."""
        eng = self.tracer.lazy_engine
        ghandles: Dict[int, object] = {}
        for i, o in enumerate(outputs):
            go = grad_outputs[i] if grad_outputs is not None and \
                i < len(grad_outputs) else None
            if go is None:
                ghandles[id(o)] = eng.ones_like(o._array)
            else:
                ghandles[id(o)] = _as_var(go)._array

        for rec in reversed(list(self.tracer.tape)):
            if not any(id(ov) in ghandles for ov in rec.out_vars):
                continue
            cots = [ghandles.get(id(ov)) for ov in rec.out_vars]
            if rec.lazy_vjp is not None:
                in_grads = rec.lazy_vjp(cots)
            else:
                in_grads = rec.pull([c.force() if is_pending(c) else c
                                     for c in cots], retain=True)
            for iv, g in zip(rec.in_vars, in_grads):
                if id(iv) in no_grad_ids:
                    continue
                prev = ghandles.get(id(iv))
                ghandles[id(iv)] = g if prev is None else eng.add(prev, g)

        results = []
        for v in inputs:
            h = ghandles.get(id(v))
            if h is None:
                if not allow_unused:
                    raise ValueError(
                        "one of the inputs is unreachable from outputs; "
                        "pass allow_unused=True to get None for it")
                results.append(None)
                continue
            gv = VarBase(None, stop_gradient=True)
            gv._array = h
            results.append(gv)
        if not retain_graph:
            self.tracer.tape.clear()
        return results


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """fluid.dygraph.grad (reference dygraph/base.py grad ->
    PartialGradEngine)."""
    t = current_tracer()
    if t is None:
        raise RuntimeError("dygraph.grad() requires dygraph mode "
                           "(fluid.dygraph.guard())")
    return PartialGradEngine(t).run(
        outputs, inputs, grad_outputs, retain_graph, create_graph,
        only_inputs, allow_unused, no_grad_vars)
