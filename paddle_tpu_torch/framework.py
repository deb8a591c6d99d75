"""Program / Block / Operator / Variable — the static-graph IR.

Counterpart of ``paddle_tpu/framework.py``: the same Python-native IR, the
same names and the same JSON form (``io.py`` writes and reads it), so a
program built or saved by either package means the same in the other.

Shape inference runs each op's own function on ``meta`` tensors (shape and
dtype, no data) where the JAX package calls ``jax.eval_shape``. An unknown
dim (-1) rides through as a sentinel size and comes back as -1.

``in_dygraph_mode`` / ``_dygraph_tracer`` / ``_current_expected_place``
name the imperative mode's tracer and place (``dygraph.guard`` sets them).
"""
from __future__ import annotations

import contextlib
import copy
import weakref
from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch

from .core import dtypes as _dt
from .core.registry import (DEVICE_ATTR, GRAD_SUFFIX, OpInfoMap,
                            op_attr_names)
from .utils import unique_name

_SENTINEL = 1223  # stands in for -1 (unknown batch) during shape inference


class Variable:
    """Symbolic variable inside a Block; its runtime value lives in a Scope
    under the same name."""

    def __init__(self, block: "Block", name: Optional[str] = None,
                 shape: Optional[Sequence[int]] = None, dtype="float32",
                 lod_level: int = 0, persistable: bool = False,
                 stop_gradient: bool = False, is_data: bool = False,
                 type: str = "lod_tensor", **kwargs):
        self.block = block
        self.name = (name if name is not None
                     else unique_name.generate("_generated_var"))
        self.shape = (tuple(int(s) for s in shape) if shape is not None
                      else None)
        self.dtype = _dt.convert_dtype(dtype)
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.type = type
        self.op: Optional[Operator] = None  # last writer

    def __repr__(self):
        return "Variable(%s, shape=%s, dtype=%s%s)" % (
            self.name, self.shape, self.dtype,
            ", persistable" if self.persistable else "")

    __str__ = __repr__


class Parameter(Variable):
    """A persistable, trainable variable."""

    def __init__(self, block, shape, dtype, **kwargs):
        self.trainable = kwargs.pop("trainable", True)
        self.optimize_attr = kwargs.pop("optimize_attr",
                                        {"learning_rate": 1.0})
        self.regularizer = kwargs.pop("regularizer", None)
        self.do_model_average = kwargs.pop("do_model_average", None)
        kwargs.setdefault("persistable", True)
        kwargs.setdefault("stop_gradient", False)
        super().__init__(block, shape=shape, dtype=dtype, **kwargs)


class OpRole:
    """Op phase tags, the JAX package's values."""

    Forward = 0x0000
    Backward = 0x0001
    Optimize = 0x0002


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX


class Operator:
    """One op in a Block: (type, slot -> var names, attrs), tagged with
    the role of the phase that appended it (forward, backward, optimize)."""

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs: Dict[str, List[str]] = {}
        self.outputs: Dict[str, List[str]] = {}
        self.attrs: Dict[str, object] = dict(attrs or {})
        self._id = None  # set by Block.append_op
        prog = getattr(block, "program", None) if block is not None else None
        self._role = getattr(prog, "_current_role", OpRole.Forward)
        for slot, arg in (inputs or {}).items():
            self.inputs[slot] = _to_name_list(arg)
        for slot, arg in (outputs or {}).items():
            self.outputs[slot] = _to_name_list(arg)

    def input(self, slot) -> List[str]:
        return self.inputs.get(slot, [])

    def output(self, slot) -> List[str]:
        return self.outputs.get(slot, [])

    @property
    def input_arg_names(self):
        return [n for ns in self.inputs.values() for n in ns]

    @property
    def output_arg_names(self):
        return [n for ns in self.outputs.values() for n in ns]

    def __repr__(self):
        return "Op(%s: %s -> %s)" % (self.type, self.inputs, self.outputs)


def _to_name_list(arg) -> List[str]:
    if arg is None:
        return []
    if isinstance(arg, (list, tuple)):
        return [a.name if isinstance(a, Variable) else str(a) for a in arg]
    return [arg.name if isinstance(arg, Variable) else str(arg)]


class Block:
    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        # a grad block built from a block's ops (a while body's) names it
        self.forward_block_idx = -1
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    @property
    def parent_block(self) -> Optional["Block"]:
        if self.parent_idx < 0:
            return None
        return self.program.block(self.parent_idx)

    def create_var(self, **kwargs) -> Variable:
        name = kwargs.get("name")
        if name and name in self.vars:
            return self.vars[name]
        v = Variable(self, **kwargs)
        self.vars[v.name] = v
        return v

    def create_parameter(self, **kwargs) -> Parameter:
        p = Parameter(self, **kwargs)
        gb = self.program.global_block()
        gb.vars[p.name] = p
        if self is not gb:
            self.vars[p.name] = p
        return p

    def var(self, name: str) -> Variable:
        v = self._find_var_recursive(name)
        if v is None:
            raise ValueError("variable %r not found in block %d"
                             % (name, self.idx))
        return v

    def has_var(self, name: str) -> bool:
        return self._find_var_recursive(name) is not None

    def has_var_local(self, name: str) -> bool:
        return name in self.vars

    def _find_var_recursive(self, name: str) -> Optional[Variable]:
        b: Optional[Block] = self
        while b is not None:
            v = b.vars.get(name)
            if v is not None:
                return v
            b = b.parent_block
        return None

    @property
    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def append_op(self, type, inputs=None, outputs=None, attrs=None,
                  infer_shape=True) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        op._id = self.program._next_op_id()
        self.ops.append(op)
        if infer_shape:
            try:
                infer_op_shapes(self, op)
            except Exception:
                # roll the op back out: a caller that catches the build
                # error must not be left with a poisoned block
                self.ops.pop()
                raise
        return op

    def __repr__(self):
        return "Block(%d, %d ops, %d vars)" % (self.idx, len(self.ops),
                                               len(self.vars))


_block_rw_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def block_rw(block: Block) -> Tuple[Set[str], Set[str]]:
    """(written, read-before-written) over a block, recursing through
    while/conditional sub-blocks (their external reads are this block's
    reads; their writes land in parent vars by name). Memoized per block,
    invalidated by its op count."""
    hit = _block_rw_cache.get(block)
    if hit is not None and hit[0] == len(block.ops):
        return hit[1]
    written: Set[str] = set()
    read_first: Set[str] = set()
    for op in block.ops:
        sb = op.attrs.get("sub_block")
        if op.type in ("while", "conditional_block") and sb is not None:
            sw, sr = block_rw(sb)
            ins, outs = sr | set(op.input_arg_names), \
                sw | set(op.output_arg_names)
        else:
            ins, outs = op.input_arg_names, op.output_arg_names
        read_first.update(n for n in ins if n and n not in written)
        written.update(n for n in outs if n)
    _block_rw_cache[block] = (len(block.ops), (written, read_first))
    return written, read_first


def infer_op_shapes(block: Block, op: Operator) -> None:
    """Set output var shapes/dtypes by running the op's function on
    ``meta`` tensors built from its inputs' metadata. A host op has no
    function to run: its caller sets the shapes."""
    info = OpInfoMap.instance().get(op.type)
    if info.fn is None:
        return
    if info.needs_lod:
        # a LoD op's output rows depend on the fed sequence lengths, which
        # are runtime information: every output takes [-1, trailing dims
        # of the first input], as in the JAX package
        first = next((block._find_var_recursive(op.input(s.name)[0])
                      for s in info.inputs if op.input(s.name)), None)
        for slot in info.outputs:
            for n in op.output(slot.name):
                v = block._find_var_recursive(n)
                if v is None:
                    v = block.create_var(name=n)
                if v.shape is None and first is not None \
                        and first.shape is not None:
                    v.shape = (-1,) + tuple(first.shape[1:])
                v.op = op
        return

    def meta_of(name):
        v = block.var(name)
        if v.shape is None:
            raise ValueError("input %r of op %r has no shape"
                             % (name, op.type))
        shape = tuple(_SENTINEL if d < 0 else d for d in v.shape)
        return torch.empty(shape, dtype=_dt.to_torch_dtype(v.dtype),
                           device="meta")

    ins = {}
    for slot in info.inputs:
        names = op.input(slot.name)
        if not names:
            ins[slot.name] = None
            continue
        metas = [meta_of(n) for n in names]
        ins[slot.name] = metas if slot.duplicable else metas[0]
    attrs = dict(info.attrs)
    attrs.update(op.attrs)
    attrs[DEVICE_ATTR] = torch.device("meta")
    outs = info.fn(ins, attrs)
    for slot in info.outputs:
        m = outs.get(slot.name)
        if m is None:
            continue
        metas = m if isinstance(m, (list, tuple)) else [m]
        for n, mm in zip(op.output(slot.name), metas):
            v = block._find_var_recursive(n)
            if v is None:
                v = block.create_var(name=n)
            v.shape = tuple(-1 if d == _SENTINEL else int(d)
                            for d in mm.shape)
            v.dtype = _dt.convert_dtype(mm.dtype)
            v.op = op


_program_uid_counter = [0]


class Program:
    def __init__(self):
        # process-unique id for per-program caches (never reused, unlike id())
        _program_uid_counter[0] += 1
        self._uid = _program_uid_counter[0]
        self.blocks: List[Block] = [Block(self, 0)]
        self._current_block_idx = 0
        self._op_id = 0
        self.random_seed = 0
        # op-role bookkeeping of the backward and optimizer passes
        self._appending_grad_times = 0
        self._current_role = OpRole.Forward

    def _next_op_id(self):
        self._op_id += 1
        return self._op_id

    @contextlib.contextmanager
    def _role_guard(self, role):
        """Ops appended inside carry ``role``."""
        prev = self._current_role
        self._current_role = role
        try:
            yield
        finally:
            self._current_role = prev

    def _optimized_guard(self, param_and_grads=None):
        return self._role_guard(OpRole.Optimize)

    def _backward_role_guard(self):
        return self._role_guard(OpRole.Backward)

    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self._current_block_idx]

    def block(self, idx: int) -> Block:
        return self.blocks[idx]

    def _create_block(self, parent_idx: Optional[int] = None) -> Block:
        """A new block under the current one (or ``parent_idx``), made
        current: the body of a while, a conditional or a StaticRNN step."""
        parent = self._current_block_idx if parent_idx is None else parent_idx
        b = Block(self, len(self.blocks), parent)
        self.blocks.append(b)
        self._current_block_idx = b.idx
        return b

    def _rollback(self):
        self._current_block_idx = self.current_block().parent_idx

    def all_parameters(self) -> List[Parameter]:
        return self.global_block().all_parameters

    def list_vars(self):
        for b in self.blocks:
            for v in b.vars.values():
                yield v

    def clone(self, for_test: bool = False) -> "Program":
        """A copy with its own blocks, vars and ops. ``for_test`` drops the
        backward and optimizer ops (by their role) and the op types in
        ``_TRAIN_ONLY_SKIP``, and sets ``is_test`` on every op whose
        registered attrs name it, as the JAX package does."""
        p = Program()
        p.blocks = []
        p._op_id = self._op_id
        p.random_seed = self.random_seed
        p._appending_grad_times = self._appending_grad_times
        for b in self.blocks:
            p.blocks.append(Block(p, b.idx, b.parent_idx))
        for b, nb in zip(self.blocks, p.blocks):
            for name, v in b.vars.items():
                nv = copy.copy(v)
                nv.block = nb
                nb.vars[name] = nv
            for op in b.ops:
                if for_test and (op.type in _TRAIN_ONLY_SKIP or op._role & (
                        OpRole.Backward | OpRole.Optimize)):
                    continue
                nop = Operator(nb, op.type, None, None, dict(op.attrs))
                nop.inputs = {k: list(v) for k, v in op.inputs.items()}
                nop.outputs = {k: list(v) for k, v in op.outputs.items()}
                nop._id = op._id
                nop._role = op._role
                if for_test and "is_test" in op_attr_names(op.type):
                    nop.attrs["is_test"] = True
                nb.ops.append(nop)
        return p

    def __repr__(self):
        return "Program(%d blocks, %d ops)" % (
            len(self.blocks), sum(len(b.ops) for b in self.blocks))


# op types dropped by clone(for_test=True), the JAX package's set
_TRAIN_ONLY_SKIP: set = set()

_main_program_ = Program()
_startup_program_ = Program()


def default_main_program() -> Program:
    return _main_program_


def default_startup_program() -> Program:
    return _startup_program_


def switch_main_program(program: Program) -> Program:
    global _main_program_
    old = _main_program_
    _main_program_ = program
    return old


def switch_startup_program(program: Program) -> Program:
    global _startup_program_
    old = _startup_program_
    _startup_program_ = program
    return old


@contextlib.contextmanager
def program_guard(main_program: Program,
                  startup_program: Optional[Program] = None):
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)


# -- dygraph mode (the tracer ``dygraph.guard`` sets; framework.py:531-556) --

_dygraph_tracer_ = None
_dygraph_place_ = None


def in_dygraph_mode() -> bool:
    return _dygraph_tracer_ is not None


def _dygraph_tracer():
    return _dygraph_tracer_


def _current_expected_place():
    """The dygraph guard's place; outside a guard, the card, as every
    entry point of the port defaults to it."""
    from .core.place import CUDAPlace

    if _dygraph_place_ is not None:
        return _dygraph_place_
    return CUDAPlace(0)
