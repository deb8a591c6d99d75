"""Mesh execution engine: ``CompiledProgram.with_data_parallel``.

Counterpart of ``paddle_tpu/parallel/engine.py`` (the reference's
ParallelExecutor), for the data axes and the model axes. The JAX engine
wraps the step in one ``shard_map`` over the mesh; here the replicas of
this process run the same step function (``core/compiler_engine``'s
``_Step``) in lockstep, one env each:

- the program is transpiled as the JAX engine does it: the loss grad
  scaled by 1 / (the replicas over the data axes)
  (``GradientScaleStrategy.CoeffNumDevice``), a ``c_allreduce_sum`` over
  the data axes before the optimizer for every grad but those of params
  sharded over a data axis, the batch norms marked under
  ``BuildStrategy.sync_batch_norm``, then
  ``collectives.maybe_rewrite_collectives`` (buckets, quantization, the
  sharded update);
- the data axes are those the program's ``_data_axes`` declares (the
  hybrid passes merge theirs in; default the engine's ``axis_name``) and
  the mesh has. A pure model-parallel mesh has none: its feeds are
  replicated and it does no allreduce. Promoting a model axis to a data
  axis would split the feeds and drop cross-shard grad shares;
- a feed splits on the dims its ``_feed_shard_specs`` entry names
  (default: the batch over the first data axis), one block a replica;
- a var under ``_var_shard_specs`` is held as one block a replica (the
  scope keeps it whole: blocks are views of it where no other replica
  holds the same block, else copies), params and other state are
  replicated, each replica with its own tensors (replica 0's are the
  scope's, the others copies made once and kept);
- every op runs once a replica, except an op with a form over a group (a
  collective, a sync batch norm, a hybrid op over a live ``shard_axis``):
  it runs once a subgroup of its axis (``ops/collective_ops.AxisGroups``),
  which reduces in rank order;
- fetches come back stacked over the data axes ``[n_data, ...]`` (one
  replica a data coordinate), as ParallelExecutor merges them; with no
  data axis, the one value.

On the card the first run of a program and shapes is eager, the second
captures every replica's step and the reductions between them into one
CUDA graph (on ``core.graphs``, the executor's pool), later runs replay it,
as on the single-replica route. The route declines a capture by name
(counted in ``executor.compile_fallbacks``, named in
``compiler_engine.declines()``) and runs every step eagerly for: replicas on more
than one card (a graph holds one), control flow across replicas, and a
collective over a gloo process group (gloo is not capturable). A host op
the step cannot hold (``lookup_table_sparse_grad``, say) is refused before
any replica runs, with the JAX engine's words.

Over a ``torch.distributed`` world (``default_mesh()`` in a process the
launcher started; ``distributed/launch.py``) each process runs one replica
on its own batch shard and the collectives call ``torch.distributed`` on
the group; fetches are gathered from every process. Hybrid shard specs
over such a mesh are refused, as in the JAX engine.

A program the single-chip fused-optimizer pass rewrote is refused on more
than one replica, with the JAX engine's message: its grads would dodge the
reduction. The sharded update is the data-parallel form of that fusion.

``_estimate_collective_bytes`` counts each step's collective traffic by
kind; with the observability layer armed the engine adds it to
``parallel.collective_ops{kind=}`` / ``parallel.collective_bytes{kind=}``
(and ``parallel.steps``, ``parallel.step_ms``, ``parallel.compiles``).
"""
from __future__ import annotations

import contextlib
import math
import time
import warnings
from typing import Dict, List, Sequence, Tuple

import torch

from .. import observability as _obs
from ..core import compiler_engine as _ce
from ..core.compiler_engine import (_CONST, _FOLDED, _IF, _WHILE,
                                    _analyze, _fold_plan, _scope_tensor,
                                    compile_program)
from ..core.cuda_graph import CapturedGraph, same_memory
from ..core.enforce import annotate_op_error
from ..core.executor_core import (_UNBOUND, call_op, gather_inputs,
                                  output_pairs, rng_seed)
from ..core.registry import DEVICE_ATTR, GENERATOR_ATTR, OpInfoMap
from ..core.scope import Scope
from ..core.tensor import LoDTensor, stage_feed
from ..ops.collective_ops import (AxisGroups, ProcessGroupAxis,
                                  mesh_axes_guard, ring_axis_guard)
from ..observability import capture as _capture
from .mesh_utils import Mesh, default_mesh, make_mesh, mesh_key
from .transpiler import insert_allreduce_ops

# replica r > 0 of an RNG op draws from its seed plus r times this
_REPLICA_SALT = 0x9E3779B1

FUSED_OPTIMIZER_REFUSAL = (
    "program was rewritten by the single-chip fused-optimizer "
    "pass; unset PADDLE_TPU_FUSED_OPTIMIZER before running it "
    "on a multi-replica mesh (use PADDLE_TPU_SHARDED_UPDATE "
    "there instead)")


# -- collective traffic --------------------------------------------------------

def _var_nbytes(block, state, name: str) -> Tuple[int, int]:
    """(bytes, itemsize) of a var through ``collectives._numel_and_dtype``;
    an unknown shape counts 0 bytes."""
    from .collectives import _numel_and_dtype, itemsize

    n, dtype = _numel_and_dtype(block, state, name)
    item = itemsize(dtype or "float32")
    return (0 if n is None else n * item), item


# collective op type -> traffic kind (substring match)
_COLLECTIVE_KINDS = (
    ("bucket_allreduce", "allreduce"), ("sharded_update", None),
    ("allreduce", "allreduce"), ("allgather", "allgather"),
    ("reducescatter", "reducescatter"), ("broadcast", "broadcast"),
)


def _quant_wire_itemsize(attrs, exact_itemsize: int,
                         native: bool = False) -> int:
    """Per-element payload width of a (maybe quantized) collective: what
    the reduction here moves, or with ``native`` what a native quantized
    collective would."""
    from ..ops.collective_ops import QUANT_PSUM_ITEMSIZE, QUANT_WIRE_ITEMSIZE

    table = QUANT_WIRE_ITEMSIZE if native else QUANT_PSUM_ITEMSIZE
    wire = table.get(attrs.get("quant", "none"))
    return exact_itemsize if wire is None else wire


def _estimate_collective_bytes(program, state, native_wire: bool = False
                               ) -> Dict:
    """Per-kind collective traffic of a step of the transpiled program:
    ``{"ops": {kind: n}, "bytes": {kind: wire bytes}, "ops_total",
    "bytes_total", "bytes_exact"}``. Wire bytes charge bf16 payloads 2
    bytes an element and int8 codes 4 (summed in int32); ``native_wire``
    charges int8 1 byte."""
    block = program.global_block()
    ops_by_kind: Dict[str, int] = {}
    bytes_by_kind: Dict[str, int] = {}
    exact_total = 0

    def _add(kind, n_ops, wire_bytes, exact_bytes):
        nonlocal exact_total
        ops_by_kind[kind] = ops_by_kind.get(kind, 0) + n_ops
        bytes_by_kind[kind] = bytes_by_kind.get(kind, 0) + wire_bytes
        exact_total += exact_bytes

    for op in block.ops:
        if not op.type.startswith("c_") or op.type.endswith("_await"):
            continue
        kind = next((k for sub, k in _COLLECTIVE_KINDS if sub in op.type),
                    "skip")
        if kind == "skip":
            continue
        if op.type == "c_sharded_update":
            padded = int(op.attrs.get("padded_size", 0))
            pname = op.input("Param")[0] if op.input("Param") else None
            _, item = _var_nbytes(block, state, pname) if pname else (0, 4)
            wire_item = _quant_wire_itemsize(op.attrs, item, native_wire)
            _add("allreduce", 1, padded * wire_item, padded * item)
            _add("allgather", 1, padded * item, padded * item)
            continue
        bucket = op.type.startswith("c_bucket_allreduce")
        names = [n for n in (op.input("X") if bucket
                             else op.input_arg_names) if n]
        exact = sum(_var_nbytes(block, state, n)[0] for n in names)
        if bucket:
            item = _var_nbytes(block, state, names[0])[1] if names else 4
            wire_item = _quant_wire_itemsize(op.attrs, item, native_wire)
            _add(kind, 1, int(exact * wire_item / item), exact)
        else:
            _add(kind, 1, exact, exact)
    return {"ops": ops_by_kind, "bytes": bytes_by_kind,
            "ops_total": sum(ops_by_kind.values()),
            "bytes_total": sum(bytes_by_kind.values()),
            "bytes_exact": exact_total}


# -- the replica walk ----------------------------------------------------------

def _replica_seed(seed: int, attrs, r: int) -> int:
    if r == 0 or int(attrs.get("seed", 0) or 0) > 0:
        return seed
    return (seed + r * _REPLICA_SALT) & 0xFFFFFFFF


_NO_RANGE = contextlib.nullcontext()


def _walk(block, envs: List[Dict], devices, rng, graph=None,
          salts=None) -> None:
    """Run ``block`` (a ``compiler_engine._Block``) for every replica in
    lockstep: each op once a replica, an op with a group form once a
    subgroup of the group its attrs reach. ``salts`` (default: the
    replica's position) seeds each replica's RNG ops: replicas of one data
    coordinate draw the same numbers."""
    n = len(envs)
    salts = list(range(n)) if salts is None else salts
    # "<phase>/<op_type>" ranges while phase annotation is armed
    labels = getattr(block, "labels", None)
    for i, (kind, op, info, attrs, outs, drops) in enumerate(block.ops):
        with (torch.profiler.record_function(labels[i])
              if labels is not None else _NO_RANGE):
            if kind == _FOLDED:
                for env, dev in zip(envs, devices):
                    env.update({k: v if v.device == dev else v.to(dev)
                                for k, v in outs.items()})
            elif kind == _CONST and graph is not None:
                for r, env in enumerate(envs):
                    env.update(graph.consts[r][id(op)])
            elif kind in (_WHILE, _IF):
                for env in envs:
                    block._run_node_eager(outs, env, rng, 0)
            else:
                group = info.group_of(attrs) if info.group_fn is not None \
                    else None
                if group is not None and group.in_process:
                    ins_list = [gather_inputs(info, op, env.get)
                                for env in envs]
                    for ranks, g in group.parts():
                        try:
                            sub = info.group_fn([ins_list[r] for r in ranks],
                                                attrs, g)
                        except Exception as e:
                            annotate_op_error(e, op, "data parallel")
                            raise
                        for r, o in zip(ranks, sub):
                            for k, v in output_pairs(info, op, o):
                                envs[r][k] = v
                else:
                    for r in range(n):
                        a = attrs
                        if devices[r] != attrs.get(DEVICE_ATTR):
                            a = dict(a)
                            a[DEVICE_ATTR] = devices[r]
                        if info.needs_rng:
                            a = dict(a)
                            if graph is not None:
                                a[GENERATOR_ATTR] = graph.gens[r][id(op)]
                            else:
                                gen = torch.Generator(device=devices[r])
                                gen.manual_seed(_replica_seed(
                                    rng_seed(rng, attrs, op), attrs, salts[r]))
                                a[GENERATOR_ATTR] = gen
                        ins = gather_inputs(info, op, envs[r].get)
                        o = call_op(info, op, ins, a, "data parallel")
                        for k, v in output_pairs(info, op, o):
                            envs[r][k] = v
            for env in envs:
                for k in drops:
                    env.pop(k, None)


def refuse_host_ops(block) -> None:
    """Raise the JAX engine's ``NotImplementedError`` at the first host op
    of ``block`` (or of a sub-block) that does not fold to constants: a
    replica's step cannot hold it."""
    infos = OpInfoMap.instance()
    fold_idxs = _fold_plan(block)[0]
    for i, op in enumerate(block.ops):
        sub = op.attrs.get("sub_block")
        if op.type in ("while", "conditional_block"):
            if sub is not None:
                refuse_host_ops(sub)
            continue
        if i in fold_idxs or not infos.has(op.type):
            continue
        if infos.get(op.type).host_fn is not None:
            raise NotImplementedError(
                "host op %r cannot be traced (not const-foldable here)"
                % op.type)


# -- the layout of a var over the mesh -----------------------------------------

def take_block(t: torch.Tensor, spec, coords: Dict[str, int],
               shape: Dict[str, int]) -> torch.Tensor:
    """The block of ``t`` a replica at ``coords`` holds under ``spec`` (the
    mesh axis of each dim, None where the dim is whole): a view."""
    for d, a in enumerate(spec or ()):
        if a:
            n = shape[a]
            if t.shape[d] % n:
                raise ValueError(
                    "dim %d of %s does not split over the %d replicas of "
                    "axis %r" % (d, tuple(t.shape), n, a))
            t = t.narrow(d, coords[a] * (t.shape[d] // n), t.shape[d] // n)
    return t


def _block_key(spec, coords) -> Tuple:
    return tuple(coords[a] for a in (spec or ()) if a)


class _DPRun:
    """One (step, mesh, scope): its groups, the layout of its sharded vars,
    the replicas' copies of the replicated state (eager runs), the traffic
    estimate."""

    def __init__(self, step, mesh, devices, group, axis_groups, sharded,
                 data_axes, coll_est):
        self.step = step
        self.devices = devices
        self.group = group  # the data axes' group (ring 0), or None
        self.axis_groups = axis_groups  # mesh axis name -> group
        self.sharded = sharded  # name -> spec, held as blocks
        self.coll_est = coll_est
        self.shape = dict(mesh.shape)
        self.coords = [mesh.coords(r) for r in range(len(devices))] \
            if not mesh.spans_processes else [
                {a: 0 for a in mesh.axis_names}]
        model = [a for a in mesh.axis_names if a not in data_axes]
        # the replicas a fetch stacks over: one a data coordinate
        self.fetch_ranks = [r for r, c in enumerate(self.coords)
                            if all(c[a] == 0 for a in model)]
        self.stack_fetches = bool(data_axes) or mesh.spans_processes
        # RNG salt: the data coordinate (model replicas draw alike)
        self.salts = []
        for c in self.coords:
            k = 0
            for a in mesh.axis_names:
                if a in data_axes:
                    k = k * self.shape[a] + c[a]
            self.salts.append(k)
        self.copies: Dict[str, Tuple] = {}  # name -> (scope tensor, reps)
        self.capturable = None  # None: not decided; else (bool, reason)
        self.graph = None  # the graph the last step replayed, if any

    @property
    def n(self) -> int:
        return len(self.devices)

    def guards(self):
        ring = {0: self.group, -1: self.group} if self.group else {}
        return ring_axis_guard(ring), mesh_axes_guard(self.axis_groups)

    def blocks(self, t: torch.Tensor, name: str) -> List[torch.Tensor]:
        """Each replica's block of the sharded var ``name`` (whole ``t``):
        a view for the first replica holding a block, a copy for the
        others, each on its replica's device."""
        spec = self.sharded[name]
        seen, out = set(), []
        for c, d in zip(self.coords, self.devices):
            b = take_block(t, spec, c, self.shape)
            key = _block_key(spec, c)
            if key in seen:
                b = b.to(d, copy=True)
            else:
                seen.add(key)
                b = b if b.device == d else b.to(d)
            out.append(b)
        return out

    def assemble(self, name: str, vals, like: torch.Tensor):
        """The whole var from the replicas' blocks (the first holder of
        each), or None where they are still views of ``like``."""
        spec = self.sharded[name]
        firsts, seen = [], set()
        for c, v in zip(self.coords, vals):
            key = _block_key(spec, c)
            if key not in seen:
                seen.add(key)
                firsts.append((c, v))
        if isinstance(like, torch.Tensor) and all(
                same_memory(v, take_block(like, spec, c, self.shape))
                for c, v in firsts):
            return None
        dev = vals[0].device
        full = list(vals[0].shape)
        for d, a in enumerate(spec or ()):
            if a:
                full[d] *= self.shape[a]
        out = torch.empty(full, dtype=vals[0].dtype, device=dev)
        for c, v in firsts:
            take_block(out, spec, c, self.shape).copy_(v.to(dev))
        return out

    def replica_state(self, scope: Scope, name: str) -> List[torch.Tensor]:
        t = _scope_tensor(scope, name)
        if name in self.sharded:
            return self.blocks(t, name)
        hit = self.copies.get(name)
        if hit is not None and hit[0] is t:
            return hit[1]
        d0 = self.devices[0]
        reps = [t if t.device == d0 else t.to(d0)]
        reps += [t.to(d, copy=True) for d in self.devices[1:]]
        self.copies[name] = (t, reps)
        return reps

    def write_back(self, scope: Scope, envs: List[Dict]) -> None:
        for name in self.step.out_state_names:
            vals = [env.get(name) for env in envs]
            if any(v is None for v in vals):
                continue
            if name in self.sharded:
                whole = self.assemble(name, vals,
                                      _scope_tensor(scope, name))
                if whole is not None:
                    scope.var(name).set(LoDTensor(whole))
                continue
            scope.var(name).set(LoDTensor(vals[0]))
            self.copies[name] = (vals[0], vals)


class _DPGraph(CapturedGraph):
    """Every replica's step captured into one graph on one card: the static
    feed buffers a replica, the state buffers (replica 0's the scope's,
    the others copies; a sharded var's replicas slices of the scope's
    tensor), the generators a replica and op, the fetches."""

    def __init__(self, run: _DPRun, core, scope: Scope, feeds):
        step = run.step
        dev = run.devices[0]
        n = run.n
        self.scope_ref = scope
        self.state0: Dict[str, torch.Tensor] = {}
        self.bufs: List[Dict[str, torch.Tensor]] = [{} for _ in range(n)]
        for name in step.out_state_names:
            t = _scope_tensor(scope, name)
            if not isinstance(t, torch.Tensor):
                raise RuntimeError(
                    "variable %r must be initialized in scope before the "
                    "step is captured" % name)
            if t.device != dev:
                t = t.to(dev)
                scope.var(name).set(LoDTensor(t))
            self.state0[name] = t
            if name in run.sharded:
                for r, b in enumerate(run.blocks(t, name)):
                    self.bufs[r][name] = b
            else:
                self.bufs[0][name] = t
                for r in range(1, n):
                    self.bufs[r][name] = t.clone()
        self.feeds = [{k: v.to(dev, copy=True) for k, v in f.items()}
                      for f in feeds]
        self.gens = [{k: torch.Generator(device=dev) for k in step.rng_ops}
                     for _ in range(n)]
        self.consts = [step.run_consts() for _ in range(n)]
        envs = []
        for r in range(n):
            env = {k: self.bufs[r][k] for k in step.state_names}
            env.update(self.feeds[r])
            envs.append(env)

        def body():
            g_ring, g_axes = run.guards()
            with g_ring, g_axes:
                _walk(step.block, envs, run.devices, None, graph=self,
                      salts=run.salts)
            for r in range(n):
                for name in step.out_state_names:
                    new, buf = envs[r].get(name), self.bufs[r][name]
                    if new is None or new is buf or same_memory(new, buf):
                        continue
                    if new.shape != buf.shape or new.dtype != buf.dtype:
                        raise RuntimeError(
                            "state %r changes from %s %s to %s %s in one "
                            "step; a captured step keeps its state's "
                            "shapes" % (name, tuple(buf.shape), buf.dtype,
                                        tuple(new.shape), new.dtype))
                    buf.copy_(new)

        self.capture(core.graphs, body,
                     [g for gens in self.gens for g in gens.values()])
        self.fetches = [{k: env[k] for k in step.fetch_names if k in env}
                        for env in envs]

    def stage_state(self, run: _DPRun, scope: Scope) -> bool:
        """Copy the scope vars replaced since the last run into every
        replica's buffers. False when a shape or type changed."""
        stale = []
        for name in run.step.state_names:
            t = _scope_tensor(scope, name)
            buf = self.state0[name]
            if t is buf:
                continue
            if not isinstance(t, torch.Tensor) or t.shape != buf.shape \
                    or t.dtype != buf.dtype:
                return False
            stale.append((name, t))
        for name, t in stale:
            self.state0[name].copy_(t)
            if name in run.sharded:
                for r, c in enumerate(run.coords):
                    view = take_block(self.state0[name], run.sharded[name],
                                      c, run.shape)
                    if not same_memory(self.bufs[r][name], view):
                        self.bufs[r][name].copy_(view)
            else:
                for r in range(1, run.n):
                    self.bufs[r][name].copy_(t)
        return True

    def replay(self, run: _DPRun, core, feeds) -> None:
        for r, f in enumerate(feeds):
            for k, v in f.items():
                self.feeds[r][k].copy_(v)
        for k, (op, attrs) in run.step.rng_ops.items():
            seed = rng_seed(core.rng, attrs, op)
            for r in range(run.n):
                self.gens[r][k].manual_seed(
                    _replica_seed(seed, attrs, run.salts[r]))
        self.launch()


def _capture_decline(run: _DPRun):
    """The name a capture of this run is declined under, else None."""
    if len(set(run.devices)) > 1:
        return ("data parallel (replicas on %d cards: a graph holds one)"
                % len(set(run.devices)))
    if run.step.nodes:
        return "data parallel>%s (control flow across replicas)" % \
            run.step.nodes[0].op.type
    if isinstance(run.group, ProcessGroupAxis) and any(
            op.type == "c_bucket_allreduce_start"
            for _, op, _, _, _, _ in run.step.block.ops):
        return ("c_bucket_allreduce_start (an async reduction's work "
                "handle: not capturable)")
    if isinstance(run.group, ProcessGroupAxis) and \
            run.group.backend == "gloo":
        g_ring, g_axes = run.guards()
        with g_ring, g_axes:
            for kind, op, info, attrs, _, _ in run.step.block.ops:
                if info is not None and info.group_fn is not None and \
                        info.group_of(attrs) is not None:
                    return "%s (gloo collective: not capturable)" % op.type
    return None


def _run_replicas(core, run: _DPRun, program, scope, feeds):
    """One step of every local replica; returns each replica's fetches."""
    step = run.step
    on_card = run.devices[0].type == "cuda"
    if on_card:
        if run.capturable is None:
            why = _capture_decline(run)
            run.capturable = (why is None, why)
            if why is not None:
                _ce.inc("executor.compile_fallbacks")
                _ce.count_decline(why, counter=None)
                warnings.warn("data-parallel program %s runs every step "
                              "eagerly: capture declined (%s)"
                              % (program._uid, why))
        if run.capturable[0]:
            sig = ("dp", step.key, id(scope),
                   tuple(str(d) for d in run.devices), tuple(
                (k, tuple(v.shape), v.dtype)
                for k, v in sorted(feeds[0].items())))
            graph = core.graphs.get(sig)
            if graph is not None and (graph.scope_ref is not scope
                                      or not graph.stage_state(run, scope)):
                core.graphs.drop(sig)
                core.warm.pop(sig, None)
                graph = None
            if graph is not None or sig in core.warm:
                if graph is None:
                    _ce.inc("executor.jit_traces")
                    graph = _DPGraph(run, core, scope, feeds)
                    core.graphs.put(sig, graph)
                graph.replay(run, core, feeds)
                run.graph = graph
                core.rng.advance()
                for name, buf in graph.state0.items():
                    var = scope.var(name)
                    h = var.raw()
                    if not (isinstance(h, LoDTensor) and h.array is buf):
                        var.set(LoDTensor(buf))
                return graph.fetches
            _ce._lru_put(core.warm, sig, True, _ce._ANALYSIS_CAP)
    run.graph = None
    envs = [{} for _ in range(run.n)]
    for name in step.state_names:
        for env, t in zip(envs, run.replica_state(scope, name)):
            env[name] = t
    for env, f, d in zip(envs, feeds, run.devices):
        env.update({k: v.to(d, copy=True) for k, v in f.items()})
    g_ring, g_axes = run.guards()
    with g_ring, g_axes:
        _walk(step.block, envs, run.devices, core.rng, salts=run.salts)
    core.rng.advance()
    run.write_back(scope, envs)
    return [{k: env[k] for k in step.fetch_names if k in env}
            for env in envs]


def replica_values(executor, name: str) -> List[torch.Tensor]:
    """Each local replica's tensor of the state var ``name`` after the
    executor's last data-parallel step (replica 0's is the scope's; a
    sharded var's are its blocks)."""
    run = executor._core.dp_last
    if run is None:
        raise RuntimeError("the executor ran no data-parallel step")
    if run.graph is not None:
        return [bufs[name] for bufs in run.graph.bufs]
    if name in run.sharded:
        raise ValueError("%r is sharded over the replicas" % name)
    return list(run.copies[name][1])


def _resolve_mesh(core, places, mesh, axis_name) -> Mesh:
    if mesh is None and isinstance(places, Mesh):
        mesh, places = places, None
    if mesh is not None:
        return mesh
    if places:
        return make_mesh([len(places)], [axis_name], list(places))
    from ..core.place import CPUPlace, CUDAPlace
    from .mesh_utils import _world

    cuda = core.device.type == "cuda"
    here = CUDAPlace(core.device.index or 0) if cuda else CPUPlace()
    # one replica a card, or this process's place in a world
    return default_mesh(None, axis_name,
                        place=here if (_world() or not cuda) else None)


def _feed_tensor(name, value) -> torch.Tensor:
    if isinstance(value, LoDTensor):
        if value.lod():
            raise NotImplementedError(
                "feed %r carries LoD: data parallelism takes dense feeds"
                % name)
        value = value.array
    return stage_feed(value)


def _split_feed(name, t: torch.Tensor, spec, run: _DPRun
                ) -> List[torch.Tensor]:
    """Each replica's block of a feed under ``spec``."""
    if not any(spec):
        return [t] * run.n
    for d, a in enumerate(spec):
        if a and (t.dim() <= d or t.shape[d] % run.shape[a]):
            raise ValueError("feed %r of batch %s does not split over %d "
                             "replicas" % (name, tuple(t.shape),
                                           run.shape[a]))
    return [take_block(t, spec, c, run.shape) for c in run.coords]


def _mesh_layout(program, mesh: Mesh, axis_name: str = "dp"):
    """(data axes, var shard specs, feed shard specs) of ``program`` over
    ``mesh``, checked as the JAX engine checks them."""
    shard_specs = dict(getattr(program, "_var_shard_specs", None) or {})
    feed_specs = dict(getattr(program, "_feed_shard_specs", None) or {})
    mesh_axes = set(mesh.axis_names)
    data_axes = tuple(a for a in (getattr(program, "_data_axes", None)
                                  or (axis_name,)) if a in mesh_axes)
    # a pure model-parallel mesh has no data axis: the batch is
    # replicated and the grads need no allreduce
    shard_axes_used = {a for spec in shard_specs.values() for a in spec if a}
    if not data_axes and mesh.axis_names[0] not in shard_axes_used:
        data_axes = (mesh.axis_names[0],)
    for n, spec in list(shard_specs.items()) + list(feed_specs.items()):
        for a in spec:
            if a is not None and a not in mesh_axes:
                raise ValueError(
                    "var %r sharded over axis %r absent from mesh axes %s"
                    % (n, a, sorted(mesh_axes)))
    if mesh.spans_processes and (shard_specs or feed_specs):
        raise NotImplementedError(
            "hybrid shard specs over a multi-process mesh")
    return data_axes, shard_specs, feed_specs


def run_data_parallel(core, program, scope: Scope, feed: Dict,
                      fetch_list: Sequence, loss_name=None, places=None,
                      build_strategy=None, return_numpy=True,
                      mesh=None, axis_name="dp"):
    """One step of ``program`` over the mesh ``places`` (a ``Mesh`` of one
    or more named axes, or a list of places; default: one replica a
    visible card, or a process of a ``torch.distributed`` world). ``feed``
    carries the full batch in one process and each process's own shard
    over a world. Returns each fetch stacked over the data axes."""
    mesh = _resolve_mesh(core, places, mesh, axis_name)
    nranks = mesh.world_size()
    multiproc = mesh.spans_processes
    data_axes, shard_specs, feed_specs = _mesh_layout(program, mesh,
                                                      axis_name)
    data_nranks = math.prod(mesh.shape[a] for a in data_axes) \
        if not multiproc else nranks

    sync_bn = bool(build_strategy is not None and getattr(
        build_strategy, "sync_batch_norm", False))
    if build_strategy is not None and hasattr(build_strategy,
                                              "_warn_inert"):
        build_strategy._warn_inert()
    # One and Customized leave the loss-grad scale to the user
    scale_loss = (build_strategy is None or getattr(
        build_strategy, "gradient_scale_strategy", 0) == 0)
    if nranks > 1 and getattr(program, "_fused_optimizer_groups", 0):
        raise ValueError(FUSED_OPTIMIZER_REFUSAL)
    if nranks > 1:
        skip_axes = getattr(program, "_allreduce_skip_grads", None) or {}
        skipped = {g for g, axes in skip_axes.items()
                   if set(axes) & set(data_axes)}
        # a grad sharded over one data axis that still sums over the
        # others (a layer norm's Scale over a split sequence, under dp)
        rest = skipped & set(getattr(program, "_allreduce_rest_grads",
                                     None) or ())
        axis_grads = {g: tuple(a for a in data_axes
                               if a not in skip_axes[g]
                               and mesh.shape[a] > 1) for g in rest}
        insert_allreduce_ops(
            program, data_nranks, scale_loss=scale_loss,
            skip_grads=skipped,
            axis_grads={g: a for g, a in axis_grads.items() if a})
        from .transpiler import mark_sync_batch_norm

        mark_sync_batch_norm(program, sync_bn)
        from .collectives import maybe_rewrite_collectives

        maybe_rewrite_collectives(program, scope, data_nranks, data_axes,
                                  build_strategy=build_strategy,
                                  multiproc=multiproc)
        shard_specs = dict(getattr(program, "_var_shard_specs", None)
                           or {})
    refuse_host_ops(program.global_block())

    devices = mesh.devices
    if multiproc:
        group = ProcessGroupAxis(None if mesh.process_group == "world"
                                 else mesh.process_group)
        axis_groups = {a: group for a in data_axes}
    elif nranks > 1:
        axis_groups = {a: AxisGroups(mesh.axis_groups([a]), devices)
                       for a in mesh.axis_names}
        group = (AxisGroups(mesh.axis_groups(data_axes), devices,
                            [mesh.axis_groups([a]) for a in data_axes])
                 if data_axes else None)
    else:
        group, axis_groups = None, {}
    n_local = len(devices)

    fetch_names = tuple(f if isinstance(f, str) else f.name
                        for f in fetch_list)
    feed_vals = {k: _feed_tensor(k, v) for k, v in (feed or {}).items()}
    feed_names = tuple(sorted(feed_vals))

    read_first, _, persist_written = _analyze(program)
    state_names = []
    for name in sorted(read_first - set(feed_names)):
        if name in _UNBOUND:
            continue
        if not isinstance(_scope_tensor(scope, name), torch.Tensor):
            raise RuntimeError("var %r must be fed or initialized" % name)
        state_names.append(name)
    state_names = tuple(state_names)
    out_state_names = tuple(sorted(set(state_names) | persist_written))
    step = compile_program(core, program, feed_names, fetch_names,
                           state_names, out_state_names)

    runs = core.dp_runs
    key = (step.key, mesh_key(mesh), tuple(str(d) for d in devices),
           sync_bn, id(scope), data_axes,
           tuple(sorted(shard_specs.items())),
           tuple(sorted(feed_specs.items())))
    run = runs.get(key)
    if run is None:
        # the first run of this (program, mesh): verify the rewritten
        # program and its collective schedule before any replica runs
        # (PADDLE_TPU_VERIFY_IR; a later run never reaches this branch)
        from ..analysis import maybe_verify_program

        maybe_verify_program(program, where="parallel.engine",
                             fetch_names=fetch_names, nranks=nranks,
                             scope=scope)
        _obs.inc("parallel.compiles")
        sharded = {k: tuple(spec) for k, spec in shard_specs.items()
                   if any(spec) and k in set(out_state_names)}
        run = _DPRun(step, mesh, devices, group, axis_groups, sharded,
                     data_axes, _estimate_collective_bytes(program, scope))
        if len(runs) >= 64:
            runs.pop(next(iter(runs)))
        runs[key] = run

    default_spec = (data_axes[0],) if data_axes and n_local > 1 else ()
    split = {k: _split_feed(k, v, feed_specs.get(k, default_spec), run)
             for k, v in feed_vals.items()}
    feeds = [{k: parts[r] for k, parts in split.items()}
             for r in range(n_local)]

    core.dp_last = run
    t_step = time.perf_counter() if _obs.enabled() else None
    with _obs.tracing.span("parallel/step", cat="step", replicas=run.n):
        outs = _run_replicas(core, run, program, scope, feeds)
    _ce.inc("executor.steps", path="parallel")
    _capture.maybe_sample_step("parallel", program, scope, feed,
                               mesh=mesh, axis_name=axis_name)
    if t_step is not None:
        coll = run.coll_est
        _obs.inc("parallel.steps")
        _obs.observe("parallel.step_ms",
                     (time.perf_counter() - t_step) * 1e3)
        _obs.inc("parallel.collective_ops", coll["ops_total"])
        _obs.inc("parallel.collective_bytes", coll["bytes_total"])
        for k, n in coll["ops"].items():
            _obs.inc("parallel.collective_ops", n, kind=k)
        for k, b in coll["bytes"].items():
            _obs.inc("parallel.collective_bytes", b, kind=k)
        saved = coll["bytes_exact"] - coll["bytes_total"]
        if saved > 0:
            _obs.inc("parallel.collective_bytes_saved", saved)

    results = []
    for name in fetch_names:
        vals = [outs[r].get(name) for r in run.fetch_ranks]
        if any(v is None for v in vals):
            t = _scope_tensor(scope, name)
            if t is None:
                raise RuntimeError("fetch variable %r not produced" % name)
            vals = [t] * len(run.fetch_ranks)
        dev = vals[0].device
        if multiproc:
            stacked = group.all_gather([vals[0]])[0]
        elif run.stack_fetches:
            stacked = torch.stack([v.to(dev) for v in vals])
        else:
            stacked = vals[0]
        t = LoDTensor(stacked)
        results.append(t.numpy() if return_numpy else t)
    return results
