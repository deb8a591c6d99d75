"""Operator registry.

Counterpart of ``paddle_tpu/core/registry.py``. An op's kernel is ONE
function ``fn(ins, attrs) -> outs`` over ``torch`` tensors: ``ins`` and
``outs`` are dicts keyed by slot name (a duplicable slot maps to a list, an
unbound dispensable slot to None). The registered ``attrs`` are the op's
defaults; the executor overlays the op's own attrs on them.

A host op (``register_host_op``) has no ``fn``: its ``host_fn(executor,
op, scope)`` reads and writes the scope itself, on the host, as the JAX
package's host ops do. ``range`` is one (its output's length depends on its
inputs' values); it is ``const_foldable``, so the whole-program route
evaluates it once when its inputs are constants (``core/compiler_engine``).

Executors pass reserved attrs that are never serialized: ``DEVICE_ATTR``
is the ``torch.device`` creation ops build on, ``GENERATOR_ATTR`` the
seeded ``torch.Generator`` a ``needs_rng`` op draws from, and
``BOUND_OUTPUTS_ATTR`` the output slots the op binds. Shape inference runs
the same ``fn`` on ``meta`` tensors.

LoD (ragged sequences as offset tables) travels on the host, as in the
JAX package: the interpreter passes a ``needs_lod`` op its inputs' LoDs
as ``attrs['_lod_<slot>']`` (``LOD_ATTR_PREFIX``), and gives its outputs
the LoD ``infer_lod`` names: ``"propagate"`` (the default: the first
non-persistable input's), ``None`` (none) or a callable ``(in_lods,
attrs) -> {(slot, index): lod}``. A host op's outputs carry what it
writes. An auto-VJP grad op inherits its forward's ``needs_lod``, so it
sees the same LoDs, and propagates none.

Gradients, as in the JAX package: an op registered with ``grad="auto"``
(the default) gets a ``<type>_grad`` op that re-runs the forward ``fn``
and differentiates it (``_vjp_grad_impl``: ``torch.autograd.grad`` on
fresh leaves where JAX calls ``jax.vjp``), or, where the op passes
``grad_fn``, runs that hand-written function over the same slots instead
(``conv2d``: its backward convs alone, with no forward re-run);
``grad=None`` ops are never differentiated; a callable ``grad`` is a grad
maker that emits the backward ops itself.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

DEVICE_ATTR = "_device"
GENERATOR_ATTR = "_generator"
BOUND_OUTPUTS_ATTR = "_bound_outputs"  # tuple of output slots bound in desc
LOD_ATTR_PREFIX = "_lod_"

GRAD_SUFFIX = "@GRAD"


class Slot:
    """One named input/output slot of an op."""

    __slots__ = ("name", "duplicable", "dispensable", "no_grad")

    def __init__(self, name, duplicable=False, dispensable=False,
                 no_grad=False):
        self.name = name
        self.duplicable = duplicable    # slot holds a LIST of variables
        self.dispensable = dispensable  # slot may be absent
        self.no_grad = no_grad          # excluded from autodiff

    def __repr__(self):
        return "Slot(%s)" % self.name


def In(name, **kw):
    return Slot(name, **kw)


def Out(name, **kw):
    return Slot(name, **kw)


class OpInfo:
    def __init__(self, type: str, fn: Callable, inputs: Sequence[Slot],
                 outputs: Sequence[Slot], attrs: Optional[Dict] = None,
                 grad: object = "auto", needs_rng: bool = False,
                 needs_lod: bool = False, side_effect: bool = False,
                 host_fn: Optional[Callable] = None,
                 const_foldable: bool = False,
                 infer_lod: object = "propagate"):
        self.type = type
        self.fn = fn
        self.inputs = tuple(inputs)
        self.outputs = tuple(outputs)
        self.attrs = dict(attrs or {})
        self.grad = grad  # "auto" | None | maker(block, op, pending, finalize)
        self.needs_rng = needs_rng
        self.needs_lod = needs_lod
        self.infer_lod = infer_lod  # "propagate" | None | callable
        self.side_effect = side_effect  # not pure (host ops, prints)
        self.host_fn = host_fn  # host_fn(executor, op, scope); no fn
        # a deterministic host op whose output depends only on its inputs:
        # with constant inputs the compiler engine evaluates it once
        self.const_foldable = const_foldable
        # a collective's form over the replicas of one process
        # (``set_group_form``): ``group_of(attrs)`` names the group its
        # attrs reach, ``group_fn(ins_list, attrs, group)`` runs the op for
        # every local replica at once
        self.group_of: Optional[Callable] = None
        self.group_fn: Optional[Callable] = None

    def input_slot(self, name) -> Optional[Slot]:
        for s in self.inputs:
            if s.name == name:
                return s
        return None


class OpInfoMap:
    _instance: Optional["OpInfoMap"] = None

    def __init__(self):
        self._map: Dict[str, OpInfo] = {}

    @classmethod
    def instance(cls) -> "OpInfoMap":
        if cls._instance is None:
            cls._instance = OpInfoMap()
        return cls._instance

    def insert(self, info: OpInfo):
        if info.type in self._map:
            raise ValueError("op %r registered twice" % info.type)
        self._map[info.type] = info

    def get(self, type: str) -> OpInfo:
        _ensure_ops_loaded()
        info = self._map.get(type)
        if info is None:
            raise KeyError(
                "Operator %r is not registered in the port (%d ops: %s); "
                "ROADMAP.md lists the op types still to port"
                % (type, len(self._map), ", ".join(sorted(self._map))))
        return info

    def has(self, type: str) -> bool:
        _ensure_ops_loaded()
        return type in self._map

    def all_op_types(self) -> List[str]:
        _ensure_ops_loaded()
        return sorted(self._map)


def op_attr_names(type: str):
    """The attr names ``type`` was registered with (none for an op type
    the port does not register)."""
    try:
        return OpInfoMap.instance().get(type).attrs.keys()
    except KeyError:
        return ()


_ops_loaded = False


def _ensure_ops_loaded():
    """Populate the registry on first lookup."""
    global _ops_loaded
    if not _ops_loaded:
        _ops_loaded = True
        from .. import ops as _ops  # noqa: F401  (imports register ops)


def register_op(type: str, inputs: Sequence[Slot], outputs: Sequence[Slot],
                attrs: Optional[Dict] = None, grad: object = "auto",
                needs_rng: bool = False, grad_fn: Optional[Callable] = None,
                needs_lod: bool = False, infer_lod: object = "propagate"):
    """Decorator: register ``fn(ins, attrs) -> outs`` as an operator, and
    its ``<type>_grad`` op when ``grad == "auto"``: the auto-VJP, or
    ``grad_fn(ins, attrs)`` over the same slots when given."""

    def deco(fn):
        info = OpInfo(type, fn, inputs, outputs, attrs, grad=grad,
                      needs_rng=needs_rng, needs_lod=needs_lod,
                      infer_lod=infer_lod)
        OpInfoMap.instance().insert(info)
        if grad == "auto":
            _register_auto_grad_for(info, grad_fn)
        return fn

    return deco


def register_host_op(type: str, inputs: Sequence[Slot],
                     outputs: Sequence[Slot], attrs: Optional[Dict] = None,
                     grad: object = None, const_foldable: bool = False):
    """Decorator: register ``host_fn(executor, op, scope)`` as an op that
    runs on the host against the scope (``executor._read_var`` /
    ``_write_var``), never inside a captured graph."""

    def deco(host_fn):
        OpInfoMap.instance().insert(OpInfo(
            type, None, inputs, outputs, attrs, grad=grad, side_effect=True,
            host_fn=host_fn, const_foldable=const_foldable, infer_lod=None))
        return host_fn

    return deco


def set_group_form(type: str, group_of: Callable,
                   group_fn: Callable) -> None:
    """Give a registered op its form over the replicas of one process: the
    data-parallel engine (``parallel/engine.py``) walks the replicas in
    lockstep and, where ``group_of(attrs)`` names a group of replicas in
    this process, calls ``group_fn(ins_list, attrs, group)`` once, with
    each replica's inputs, for each replica's outputs."""
    info = OpInfoMap.instance()._map[type]
    info.group_of = group_of
    info.group_fn = group_fn


# -- the auto-VJP grad op ------------------------------------------------------

# grad op types whose fn torch can differentiate again, the auto-VJP or a
# ``grad_fn`` of differentiable torch ops: the substrate for grad-of-grad
# registration on demand
_AUTO_VJP_TYPES: set = set()


def _register_auto_grad_for(info: OpInfo,
                            grad_fn: Optional[Callable] = None):
    grad_type = info.type + "_grad"
    if OpInfoMap.instance()._map.get(grad_type) is not None:
        return
    # forward inputs, the outputs' grads; out: the inputs' grads
    grad_inputs = [Slot(s.name, duplicable=s.duplicable, dispensable=True,
                        no_grad=s.no_grad) for s in info.inputs]
    grad_inputs += [Slot(s.name + GRAD_SUFFIX, duplicable=s.duplicable,
                         dispensable=True) for s in info.outputs]
    grad_outputs = [Slot(s.name + GRAD_SUFFIX, duplicable=s.duplicable,
                         dispensable=True) for s in info.inputs]

    def auto_vjp(ins, attrs, _info=info):
        return _vjp_grad_impl(_info, ins, attrs)

    OpInfoMap.instance().insert(OpInfo(
        grad_type, grad_fn or auto_vjp, grad_inputs, grad_outputs,
        attrs=dict(info.attrs), grad=None, needs_rng=info.needs_rng,
        needs_lod=info.needs_lod, infer_lod=None))
    _AUTO_VJP_TYPES.add(grad_type)


def ensure_grad_op(op_type: str) -> bool:
    """Register ``<op_type>_grad`` on demand when ``op_type`` is itself an
    auto-VJP grad op (the static double-grad path). True when the grad op
    exists afterwards."""
    m = OpInfoMap.instance()
    if m.has(op_type + "_grad"):
        return True
    if op_type not in _AUTO_VJP_TYPES:
        return False
    _register_auto_grad_for(m.get(op_type))
    return True


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _vjp_grad_impl(info: OpInfo, ins: Dict, attrs: Dict):
    """Generic backward: re-run ``info.fn`` with autograd on, with respect
    to the floating forward inputs whose ``<slot>@GRAD`` output is bound,
    and pull the outputs' grads back through it. A missing output grad
    counts as zeros; an input the outputs do not depend on gets zeros.
    Integer inputs are never differentiated."""
    return vjp_grad_group(info, [ins], attrs,
                          lambda rebuilt, a: [info.fn(rebuilt[0], a)])[0]


def vjp_grad_group(info: OpInfo, ins_list: List[Dict], attrs: Dict,
                   run_forward: Callable) -> List[Dict]:
    """``_vjp_grad_impl`` over the replicas of a group form at once:
    ``run_forward(rebuilt_list, fwd_attrs)`` runs the forward of every
    replica (one graph where the replicas share a reduction), and every
    replica's output grads pull back through that graph in one
    ``torch.autograd.grad``, so that a replica's input grads take the
    paths through the other replicas' outputs too."""
    bound = set(attrs.get(BOUND_OUTPUTS_ATTR) or ())
    fwd_attrs = {k: v for k, v in attrs.items() if k != BOUND_OUTPUTS_ATTR}
    # Run as the grad op of a grad op (grad of grad), this call's inputs
    # already carry the outer call's graph (one leaf per slot, made by the
    # outer call): keep it, and build a graph of this backward too, so
    # that the outer call can differentiate it.
    nested = any(isinstance(t, torch.Tensor) and t.requires_grad
                 for ins in ins_list for v in ins.values()
                 for t in (v if isinstance(v, list) else [v]))
    wrts, rebuilts, leaves = [], [], []
    for ins in ins_list:
        fwd_ins = {s.name: ins.get(s.name) for s in info.inputs}
        # (slot, index or None) leaves to differentiate with respect to
        wrt: List[Tuple[str, Optional[int]]] = []
        for s in info.inputs:
            want = (not bound) or (s.name + GRAD_SUFFIX) in bound
            v = fwd_ins.get(s.name)
            if s.no_grad or not want or v is None:
                continue
            if s.duplicable:
                wrt.extend((s.name, i) for i, x in enumerate(v)
                           if _is_float(x))
            elif _is_float(v):
                wrt.append((s.name, None))
        rebuilt = {s.name: (list(fwd_ins[s.name]) if s.duplicable
                            and fwd_ins.get(s.name) is not None
                            else fwd_ins.get(s.name)) for s in info.inputs}
        for n, i in wrt:
            x = rebuilt[n] if i is None else rebuilt[n][i]
            if not x.requires_grad:
                x = x.detach().requires_grad_(True)
            leaves.append(x)
            if i is None:
                rebuilt[n] = x
            else:
                rebuilt[n][i] = x
        wrts.append(wrt)
        rebuilts.append(rebuilt)
    if not leaves:
        return [{} for _ in ins_list]
    with torch.enable_grad():
        outs_list = run_forward(rebuilts, fwd_attrs)

    # each produced output that depends on a leaf, with its cotangent
    # (reshaped to the output: the loss grad is [1] where mean gives 0-d)
    ys, cots = [], []
    for ins, outs in zip(ins_list, outs_list):
        for s in info.outputs:
            o = outs.get(s.name)
            if o is None:
                continue
            g = ins.get(s.name + GRAD_SUFFIX)
            os_ = o if s.duplicable else [o]
            gs = (g if g is not None else [None] * len(os_)) \
                if s.duplicable else [g]
            for y, gy in zip(os_, gs):
                if not (isinstance(y, torch.Tensor) and y.requires_grad):
                    continue
                ys.append(y)
                cots.append(torch.zeros_like(y) if gy is None
                            else gy.to(y.dtype).reshape(y.shape))
    grads = (torch.autograd.grad(ys, leaves, cots, allow_unused=True,
                                 create_graph=nested)
             if ys else [None] * len(leaves))

    results: List[Dict] = []
    k = 0
    for ins, wrt in zip(ins_list, wrts):
        result: Dict[str, object] = {}
        for n, i in wrt:
            x, g = leaves[k], grads[k]
            k += 1
            g = torch.zeros_like(x) if g is None else g
            key = n + GRAD_SUFFIX
            if info.input_slot(n).duplicable:
                result.setdefault(key, [None] * len(ins[n]))[i] = g
            else:
                result[key] = g
        results.append(result)
    return results
