"""Whole-program route: a block run as one step function, captured on the
card as one CUDA graph per (program version, feed names / shapes / dtypes,
fetch names, state names, flags) and replayed.

Counterpart of ``paddle_tpu/core/compiler_engine.py``, where the block is
traced once into one jitted XLA function. The analysis half keeps the JAX
package's names and results (``_program_version``, ``_analyze``,
``_fold_plan``, ``_fold_block_values``, ``untraceable_reasons``; its
``_block_rw`` is ``framework.block_rw``). The execution half is the torch form:

- ``step(state, feeds) -> (fetches, new_state)`` walks the block's ops in
  program order over an env dict, with the interpreter's op calls and its
  eager-deletion plan. Const-foldable host ops (``range`` over constants)
  are evaluated once on a CPU scratch executor, uploaded once to the
  device, and read where the op stood.
- On the CPU the step runs eagerly, every run.
- On the card the first run of a key runs eagerly (it builds cuBLAS
  handles, autograd state and the kernels); the second captures the step
  into a CUDA graph and replays it; later runs replay. State (the names
  read before they are written and not fed: params, optimizer state, BN
  stats, the learning rate) and feeds live in static buffers: the scope
  holds the state buffers, a scope var whose tensor was replaced since
  (a user who loaded persistables) is copied in before the replay, and at
  the end of the captured region each updated state var is copied into
  its buffer unless it already is that memory (K4 updates in place).
  Fetches are copied out of the graph's pool before ``run`` returns.
- Feeds are never written into the scope, as in the JAX package: a run
  that leaves out a feed the program reads raises ``RuntimeError(
  "variable %r must be fed or initialized in scope")``, on the card after
  a capture too. A fetched name, a fed one included, is written into the
  scope after the run, as the JAX route writes its fetches.
- RNG: each RNG op draws from its own generator, registered with the graph
  and seeded before every replay with the seed the interpreter would use
  this step (``executor_core.rng_seed``), so a replay draws exactly what
  the interpreter draws, a fixed ``seed`` attr included.
- Ops that read nothing (``fill_constant``, ``assign_value``) run once
  before the capture, outside the graph: ``assign_value`` copies from
  pageable host memory, which a graph cannot capture.
- A capture or a replay that fails raises: the only way off this route
  is ``untraceable_reasons`` or a LoD feed, decided before any work, as
  in the JAX package (``executor.py``).
- Kernel launches made while capturing are recorded, not counted, and
  counted on every replay (``ops/cuda/support.recording_launches``).
  The capture, the replay, the memory pool an executor's graphs share and
  how many stay captured are ``core/cuda_graph``'s, shared with the lazy
  dygraph queue.

The counters keep the JAX package's names in ``COUNTERS`` (the
observability registry is not ported yet): ``executor.compiles`` (new
step functions), ``executor.jit_traces`` (captures),
``executor.compile_fallbacks`` and ``executor.steps``, the fusion
passes' ``fusion.epilogue_chains`` and ``fusion.optimizer_groups``
(``core/fusion.py``), and the LoD lowering's ``lod_lowering.lowered``
(lowered clones built) and ``lod_lowering.declines`` (each named in
``declines()``; ``core/lod_lowering.py``).

Control flow: the analysis walks ``while`` / ``conditional_block``
sub-blocks as the JAX package does, but where the JAX package lowers them
to ``lax.while_loop`` / ``lax.cond`` this route declines them: a CUDA
graph cannot hold a trip count the data decides. ``untraceable_reasons``
names each such op (``"while (control flow)"``), the executor counts the
program in ``executor.compile_fallbacks`` and runs it on the interpreter,
whose host ops (``ops/control_flow_ops.py``) run the body once a trip in
a child scope, reading the condition off the card once a trip. The
results are those of the JAX package's compiled route. A graph of the
body replayed a trip, and CUDA graph conditional nodes, are later work
(ROADMAP.md).
"""
from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch

from ..framework import block_rw
from . import flags
from .cuda_graph import CapturedGraph, same_memory
from .executor_core import (_UNBOUND, CoreExecutor, call_op, gather_inputs,
                            op_attrs, output_pairs, rng_seed)
from .registry import GENERATOR_ATTR, OpInfoMap
from .scope import Scope
from .tensor import LoDTensor, stage_feed

# step functions of one executor (op tables and plans: light), LRU;
# its captured graphs are a core/cuda_graph.GraphCache
_CACHE_CAP = 128

COUNTERS: Dict[str, int] = {"executor.compiles": 0,
                            "executor.jit_traces": 0,
                            "executor.compile_fallbacks": 0,
                            "executor.steps": 0,
                            "fusion.epilogue_chains": 0,
                            "fusion.optimizer_groups": 0,
                            "lod_lowering.lowered": 0,
                            "lod_lowering.declines": 0}
# each LoD-lowering decline by name ("<op type>: <reason>")
DECLINES: Dict[str, int] = {}
_counters_lock = threading.Lock()


def inc(name: str, n: int = 1) -> None:
    with _counters_lock:
        COUNTERS[name] = COUNTERS.get(name, 0) + n


def counters() -> Dict[str, int]:
    with _counters_lock:
        return dict(COUNTERS)


def reset_counters() -> None:
    with _counters_lock:
        for k in COUNTERS:
            COUNTERS[k] = 0
        DECLINES.clear()


def count_decline(name: str) -> None:
    """One LoD-lowering decline, by name."""
    with _counters_lock:
        COUNTERS["lod_lowering.declines"] += 1
        DECLINES[name] = DECLINES.get(name, 0) + 1


def declines() -> Dict[str, int]:
    with _counters_lock:
        return dict(DECLINES)


def _lru_get(cache, key):
    hit = cache.get(key)
    if hit is not None:
        cache.move_to_end(key)
    return hit


def _lru_put(cache, key, value, cap):
    cache[key] = value
    while len(cache) > cap:
        cache.popitem(last=False)


# -- analysis -----------------------------------------------------------------

def _program_version(program) -> Tuple:
    return (program._uid, program._op_id,
            tuple(len(b.ops) for b in program.blocks))


_analysis_cache: "OrderedDict" = OrderedDict()
_ANALYSIS_CAP = 1024
def _analyze(program):
    """(read-before-write set, written set, written persistables), cached
    per program version."""
    key = _program_version(program)
    hit = _lru_get(_analysis_cache, key)
    if hit is not None:
        return hit
    written, read_first = block_rw(program.global_block())
    block = program.global_block()
    persist_written = frozenset(
        n for n in written
        if (v := block._find_var_recursive(n)) is not None and v.persistable)
    result = (read_first, written, persist_written)
    _lru_put(_analysis_cache, key, result, _ANALYSIS_CAP)
    return result


def _writer_count(block) -> Dict[str, int]:
    """Writes of each var in the block, a sub-block's writes counted at
    its while/conditional op (appended with outputs={})."""
    count: Dict[str, int] = {}
    for op in block.ops:
        for n in op.output_arg_names:
            if n:
                count[n] = count.get(n, 0) + 1
        sb = op.attrs.get("sub_block")
        if op.type in ("while", "conditional_block") and sb is not None:
            for n in block_rw(sb)[0]:
                count[n] = count.get(n, 0) + 1
    return count


def _single_write(block, writer_count, names) -> bool:
    """Every name written once in the block and none persistable."""
    for n in names:
        v = block._find_var_recursive(n)
        if writer_count.get(n, 0) != 1 or (
                v is not None and getattr(v, "persistable", False)):
            return False
    return True


def _fold_plan(block):
    """Constant-folding analysis over the global block.

    A host op (``range``) would keep the whole program off this route.
    When it is ``const_foldable`` and its inputs derive from deterministic
    constant producers (fill_constant chains: not feeds, not scope state,
    not RNG), it is evaluated once, before any step, and its value read
    where it stood.

    Returns (fold_idxs, needed_idxs, fold_out_names): the host-op indices
    to pre-evaluate and skip, the pure producer indices their evaluation
    needs, and the folded output var names.
    """
    infos = OpInfoMap.instance()
    writer_count = _writer_count(block)
    static: Dict[str, int] = {}  # var -> producing op index
    fold_idxs = set()
    for i, op in enumerate(block.ops):
        if op.type in ("while", "conditional_block"):
            continue
        try:
            info = infos.get(op.type)
        except KeyError:
            continue
        const_ok = info.const_foldable and info.host_fn is not None
        pure = (info.host_fn is None and not info.needs_rng
                and not info.needs_lod and not info.side_effect)
        if not (pure or const_ok):
            continue
        ins = [n for n in op.input_arg_names if n]
        outs = [n for n in op.output_arg_names if n]
        if not outs or any(n not in static for n in ins):
            continue
        if not _single_write(block, writer_count, outs):
            continue
        for n in outs:
            static[n] = i
        if const_ok:
            fold_idxs.add(i)
    if not fold_idxs:
        return frozenset(), frozenset(), frozenset()
    needed = set()
    stack = [n for i in fold_idxs
             for n in block.ops[i].input_arg_names if n]
    while stack:
        n = stack.pop()
        i = static.get(n)
        if i is None or i in needed or i in fold_idxs:
            continue
        needed.add(i)
        stack.extend(m for m in block.ops[i].input_arg_names if m)
    fold_outs = frozenset(n for i in fold_idxs
                          for n in block.ops[i].output_arg_names if n)
    return frozenset(fold_idxs), frozenset(needed), fold_outs


def _const_plan(block) -> frozenset:
    """Indices of the pure ops that read nothing and write vars written
    once and not persistable: under capture they run once, outside the
    graph."""
    infos = OpInfoMap.instance()
    writer_count = _writer_count(block)
    idxs = set()
    for i, op in enumerate(block.ops):
        if any(n for n in op.input_arg_names) or not infos.has(op.type):
            continue
        info = infos.get(op.type)
        if (info.host_fn is not None or info.needs_rng or info.needs_lod
                or info.side_effect):
            continue
        outs = [n for n in op.output_arg_names if n]
        if outs and _single_write(block, writer_count, outs):
            idxs.add(i)
    return frozenset(idxs)


def block_is_traceable(block) -> bool:
    """True if every op can run inside the step function (recursively
    through while/conditional_block sub-blocks). Const-foldable host ops
    with constant inputs don't count against a block (_fold_plan)."""
    return not untraceable_reasons(block)


def untraceable_reasons(block) -> List[str]:
    """Blocking op types (with reason tags) that keep this block off the
    whole-program route; the executor's fallback warning names them. Over
    the JAX package's reasons, every while and conditional_block op with
    a sub-block blocks (``"while (control flow)"``)."""
    infos = OpInfoMap.instance()
    fold_idxs = _fold_plan(block)[0]
    reasons: List[str] = []
    for i, op in enumerate(block.ops):
        sb = op.attrs.get("sub_block")
        if op.type in ("while", "conditional_block"):
            if sb is None:
                reasons.append("%s (no sub_block)" % op.type)
            else:
                reasons.append("%s (control flow)" % op.type)
                reasons.extend("%s>%s" % (op.type, r)
                               for r in untraceable_reasons(sb))
            continue
        try:
            info = infos.get(op.type)
        except KeyError:
            reasons.append("%s (unregistered)" % op.type)
            continue
        if i in fold_idxs:
            continue
        if info.host_fn is not None:
            reasons.append("%s (host)" % op.type)
        elif info.needs_lod:
            reasons.append("%s (lod)" % op.type)
    return sorted(set(reasons))


_fold_values_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _fold_block_values(block) -> Dict[str, torch.Tensor]:
    """Evaluate the const-foldable subgraph once (the interpreter over a
    scratch scope on the CPU) and cache the outputs, CPU tensors, per
    block, invalidated by the owning program's version."""
    prog = getattr(block, "program", None)
    stamp = (_program_version(prog) if prog is not None
             else (len(block.ops),))
    hit = _fold_values_cache.get(block)
    if hit is not None and hit[0] == stamp:
        return hit[1]
    fold_idxs, needed, fold_outs = _fold_plan(block)
    values: Dict[str, torch.Tensor] = {}
    if fold_idxs:
        scratch_exe = CoreExecutor(torch.device("cpu"))
        scratch = Scope()
        for i in sorted(needed | fold_idxs):
            scratch_exe.run_op(block.ops[i], scratch)
        for n in fold_outs:
            v = scratch_exe._read_var(scratch, n)
            if v is not None:
                values[n] = v
    _fold_values_cache[block] = (stamp, values)
    return values


# -- execution ----------------------------------------------------------------

_RUN, _FOLDED, _CONST = 0, 1, 2


class _Step:
    """The step function of one (program version, feed names, fetch names,
    state names): the block's ops with their attrs, what each one drops
    after it (the eager-deletion plan), the folded values on the device,
    and the RNG ops."""

    def __init__(self, key, block, device, feed_names, fetch_names,
                 state_names, out_state_names):
        self.key = key
        self.device = device
        self.fetch_names = fetch_names
        self.state_names = state_names
        self.out_state_names = out_state_names
        infos = OpInfoMap.instance()
        fold_idxs, _, _ = _fold_plan(block)
        # uploaded once, outside any graph
        fold_values = {n: v.to(device)
                       for n, v in _fold_block_values(block).items()}
        const_idxs = _const_plan(block) - fold_idxs
        plan = CoreExecutor.build_gc_plan(
            block, set(feed_names) | set(fetch_names) | set(out_state_names))
        self.ops = []  # (kind, index, op, info, attrs, outputs, drops)
        self.rng_ops = {}  # index -> (op, attrs)
        for i, op in enumerate(block.ops):
            drops = tuple(plan.get(i, ()))
            if i in fold_idxs:
                outs = {n: fold_values[n] for n in op.output_arg_names if n}
                self.ops.append((_FOLDED, i, op, None, None, outs, drops))
                continue
            info = infos.get(op.type)
            attrs = op_attrs(info, op, device)
            if info.needs_rng:
                self.rng_ops[i] = (op, attrs)
            kind = _CONST if i in const_idxs else _RUN
            self.ops.append((kind, i, op, info, attrs, None, drops))

    def run(self, env: Dict, rng, gens: Optional[Dict] = None,
            consts: Optional[Dict] = None) -> None:
        """Walk the ops over ``env``. Eager (``gens`` None): each RNG op gets
        a fresh generator seeded as the interpreter seeds it. Under capture:
        the graph's registered generators, and the ops that read nothing
        take their values from ``consts``."""
        for kind, i, op, info, attrs, outs, drops in self.ops:
            if kind == _FOLDED:
                env.update(outs)
            elif kind == _CONST and consts is not None:
                env.update(consts[i])
            else:
                if info.needs_rng:
                    attrs = dict(attrs)
                    if gens is not None:
                        attrs[GENERATOR_ATTR] = gens[i]
                    else:
                        gen = torch.Generator(device=self.device)
                        gen.manual_seed(rng_seed(rng, attrs, op))
                        attrs[GENERATOR_ATTR] = gen
                ins = gather_inputs(info, op, env.get)
                outs = call_op(info, op, ins, attrs, "compiled trace")
                for n, v in output_pairs(info, op, outs):
                    env[n] = v
            for n in drops:
                env.pop(n, None)

    def run_consts(self) -> Dict[int, Dict[str, torch.Tensor]]:
        """The outputs of the ops that read nothing, run once now."""
        consts = {}
        for kind, i, op, info, attrs, _, _ in self.ops:
            if kind == _CONST:
                outs = call_op(info, op, gather_inputs(info, op, dict().get),
                               attrs, "compiled trace")
                consts[i] = dict(output_pairs(info, op, outs))
        return consts


def _scope_tensor(scope: Scope, name: str):
    var = scope.find_var(name)
    if var is None or not var.is_initialized():
        return None
    h = var.raw()
    return h.array if isinstance(h, LoDTensor) else h


class _Graph(CapturedGraph):
    """One captured step: the graph, the static feed and state buffers it
    reads and writes, its fetches (in its pool), the generators it draws
    from and the kernel launches it makes."""

    def __init__(self, step: _Step, core, scope: Scope,
                 feeds: Dict[str, torch.Tensor]):
        dev = core.device
        self.scope = weakref.ref(scope)
        self.state: Dict[str, torch.Tensor] = {}
        for n in step.out_state_names:
            t = _scope_tensor(scope, n)
            if not isinstance(t, torch.Tensor):
                raise RuntimeError(
                    "variable %r must be initialized in scope before the "
                    "step is captured" % n)
            if t.device != dev:
                t = t.to(dev)
                scope.var(n).set(LoDTensor(t))
            self.state[n] = t
        self.feeds = {n: torch.empty(v.shape, dtype=v.dtype, device=dev)
                      for n, v in feeds.items()}
        for n, v in feeds.items():
            self.feeds[n].copy_(v)
        self.gens = {i: torch.Generator(device=dev) for i in step.rng_ops}
        # outside the graph, on the current stream, before the capture's
        # synchronize
        self.consts = step.run_consts()
        env = {n: self.state[n] for n in step.state_names}
        env.update(self.feeds)

        def body():
            step.run(env, None, gens=self.gens, consts=self.consts)
            for n in step.out_state_names:
                new, buf = env.get(n), self.state[n]
                if new is None or new is buf or same_memory(new, buf):
                    continue
                if new.shape != buf.shape or new.dtype != buf.dtype:
                    raise RuntimeError(
                        "state %r changes from %s %s to %s %s in one "
                        "step; a captured step keeps its state's "
                        "shapes" % (n, tuple(buf.shape), buf.dtype,
                                    tuple(new.shape), new.dtype))
                buf.copy_(new)

        self.capture(core.graphs, body, self.gens.values())
        self.fetches = {n: env[n] for n in step.fetch_names if n in env}

    def stage_state(self, step: _Step, scope: Scope) -> bool:
        """Copy into the state buffers the scope vars replaced since the
        last run. False when a replaced value's shape or type differs (the
        caller runs the new shapes eagerly and captures them anew)."""
        stale = []
        for n in step.state_names:
            t = _scope_tensor(scope, n)
            buf = self.state[n]
            if t is buf:
                continue
            if not isinstance(t, torch.Tensor) or t.shape != buf.shape \
                    or t.dtype != buf.dtype:
                return False
            stale.append((buf, t))
        for buf, t in stale:
            buf.copy_(t)
        return True

    def replay(self, step: _Step, core, feeds: Dict[str, torch.Tensor]):
        for n, v in feeds.items():
            self.feeds[n].copy_(v)
        for i, (op, attrs) in step.rng_ops.items():
            self.gens[i].manual_seed(rng_seed(core.rng, attrs, op))
        self.launch()


def _stage_feeds(feed: Dict) -> Dict[str, torch.Tensor]:
    """Feed values as tensors where they lie (``tensor.stage_feed``: numpy
    arrays stay on the host, float64 becomes float32); a LoD feed raises:
    it takes the interpreter."""
    vals = {}
    for name, value in feed.items():
        if isinstance(value, LoDTensor):
            if value.lod():
                raise LoDFeed("LoD feeds use the interpreter")
            value = value.array
        vals[name] = stage_feed(value)
    return vals


class LoDFeed(NotImplementedError):
    """A feed that carries LoD: the whole-program route declines it."""


def compile_program(core, program, feed_names: Tuple[str, ...],
                    fetch_names: Tuple[str, ...],
                    state_names: Tuple[str, ...],
                    out_state_names: Tuple[str, ...]) -> _Step:
    """The (cached) step function of this program on ``core``, keyed on
    the flags too (a flag may route an op, as ``use_pallas_conv`` does)."""
    key = (_program_version(program), feed_names, fetch_names, state_names,
           out_state_names, flags.version())
    step = _lru_get(core.steps, key)
    if step is None:
        inc("executor.compiles")
        step = _Step(key, program.global_block(), core.device, feed_names,
                     fetch_names, state_names, out_state_names)
        _lru_put(core.steps, key, step, _CACHE_CAP)
    return step


def run_compiled_program(core, program, scope: Scope, feed: Dict,
                         fetch_list: Sequence, return_numpy: bool = True):
    fetch_names = tuple(f if isinstance(f, str) else f.name
                        for f in fetch_list)
    feed_vals = _stage_feeds(feed)
    feed_names = tuple(sorted(feed_vals))

    read_first, _, persist_written = _analyze(program)
    state_names = []
    for n in sorted(read_first - set(feed_names)):
        if n in _UNBOUND:
            continue
        if not isinstance(_scope_tensor(scope, n), torch.Tensor):
            raise RuntimeError(
                "variable %r must be fed or initialized in scope" % n)
        state_names.append(n)
    state_names = tuple(state_names)
    # every written persistable (params from startup programs, optimizer
    # state, BN running stats) must land back in the scope
    out_state_names = tuple(sorted(set(state_names) | persist_written))
    step = compile_program(core, program, feed_names, fetch_names,
                           state_names, out_state_names)
    inc("executor.steps")
    if core.device.type == "cuda":
        outs = _run_on_card(core, step, scope, feed_vals)
    else:
        outs = _run_eager(core, step, scope, feed_vals)

    results = []
    for name in fetch_names:
        v = outs.get(name)
        if v is None:
            v = _scope_tensor(scope, name)
            if v is None:
                raise RuntimeError("fetch variable %r not produced" % name)
        elif core.device.type == "cuda":
            v = v.clone()  # out of the graph's pool or a state buffer
        if name not in out_state_names:
            scope.var(name).set(LoDTensor(v))
        t = LoDTensor(v)
        results.append(t.numpy() if return_numpy else t)
    return results


def _run_eager(core, step: _Step, scope: Scope, feeds: Dict) -> Dict:
    env = {n: _scope_tensor(scope, n) for n in step.state_names}
    for n, v in feeds.items():
        env[n] = v.to(core.device, copy=True)
    step.run(env, core.rng)
    core.rng.advance()
    for n in step.out_state_names:
        if n in env:
            scope.var(n).set(LoDTensor(env[n]))
    return {n: env[n] for n in step.fetch_names if n in env}


def _run_on_card(core, step: _Step, scope: Scope, feeds: Dict) -> Dict:
    sig = (step.key, id(scope), tuple(
        (n, tuple(v.shape), v.dtype) for n, v in sorted(feeds.items())))
    graph = core.graphs.get(sig)
    if graph is not None and (graph.scope() is not scope
                              or not graph.stage_state(step, scope)):
        core.graphs.drop(sig)  # another scope at this id, or new shapes
        core.warm.pop(sig, None)
        graph = None
    if graph is None:
        if sig not in core.warm:
            _lru_put(core.warm, sig, True, _ANALYSIS_CAP)
            return _run_eager(core, step, scope, feeds)
        inc("executor.jit_traces")
        graph = _Graph(step, core, scope, feeds)
        core.graphs.put(sig, graph)
    graph.replay(step, core, feeds)
    core.rng.advance()
    for n, buf in graph.state.items():
        var = scope.var(n)
        h = var.raw()
        if not (isinstance(h, LoDTensor) and h.array is buf):
            var.set(LoDTensor(buf))
    return graph.fetches
