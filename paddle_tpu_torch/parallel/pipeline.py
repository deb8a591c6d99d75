"""GPipe pipeline parallelism over a ``pp`` mesh axis.

Counterpart of ``paddle_tpu/parallel/pipeline.py`` (the reference's
pipeline trainer, ``section_worker.cc:142-258``, with the program split at
``cut_list`` by ``PipelineOptimizer``). The JAX engine compiles the stages
into one SPMD program (``lax.switch`` on the stage index, ``lax.ppermute``
of a packed boundary buffer, a ``lax.scan`` over the ticks, ``jax.grad``
through it). Here the replicas of this process run it:

- ``split_forward_at_cuts`` cuts the forward ops into stages at the ops
  that produce the cut vars; ``_boundary_live_sets`` gives each boundary
  the vars written before it and read after it (a skip connection rides
  every boundary it crosses, untouched);
- the program's own backward ops go to the stage of the forward op they
  differentiate (``_fwd_op_id``; an op without that link, such as a
  ``sum`` of partial grads or a grad maker's op, to the first stage of the
  forward vars it names), so the backward runs the port's grad ops and
  kernels (K2 / K3 under flash attention), as the single-device route
  does;
- each stage is the walk (``engine._walk``) over the replicas at its
  ``pp`` coordinate: one a (data, model) coordinate, each with its own
  env a microbatch (its activations and grads), the model axes live
  inside the stage (an ``mp`` table's lookup runs through its group
  form over the stage's ``mp`` subgroups);
- the schedule is GPipe's fill and drain: forward ticks ``t = 0 ..
  M + S - 2``, stage s on microbatch ``t - s``, then the backward ticks
  from the last stage down, each stage's boundary vars (activations
  forward, their grads backward) handed to the next stage's env;
- each stage replica adds its params' grads over its microbatches in
  microbatch order; the grads are averaged over the data axis, the blocks
  of a sharded param assembled, and the wrapped optimizer's update ops
  (``program._pipeline_meta``) run once on them, the accumulators bound
  to the mean grads, as the single-device accumulation route runs them
  on its k-th microbatch;
- the loss is fetched as the mean over the microbatches (and the data
  axis);
- on the card every step runs eagerly, one walk a stage and microbatch
  (no capture yet): a program's first step on a mesh counts the decline
  ``pipeline (eager stages)`` in ``compiler_engine.declines()`` and
  ``executor.compile_fallbacks``, and warns.

It refuses what the JAX engine refuses, with the same exception types:
sequence parallelism (per-feed shard specs) under a pipeline, more than
one data axis, an axis that is neither ``pp``, a model axis nor a declared
data axis, a batch not divisible by ``num_microbatches x dp``, and a
stage count that differs from the ``pp`` axis. Forward-side persistable
writes (batch-norm statistics) are not kept, as in the JAX engine.
"""
from __future__ import annotations

import math
import time
import warnings
from typing import Dict, List, Sequence, Set, Tuple

import torch

from ..core import compiler_engine as _ce
from ..core.compiler_engine import _RUN, _scope_tensor
from ..core.executor_core import op_attrs
from ..core.registry import GRAD_SUFFIX, OpInfoMap
from ..core.scope import Scope
from ..core.tensor import LoDTensor, stage_feed
from ..ops.collective_ops import AxisGroups, mesh_axes_guard
from .mesh_utils import make_mesh, mesh_key


def _cut_names(cut_list) -> List[str]:
    """A reference cut_list is a list of lists of Variables; flat lists
    and names are taken too."""
    names = []
    for entry in cut_list or []:
        group = entry if isinstance(entry, (list, tuple)) else [entry]
        for v in group:
            names.append(v if isinstance(v, str) else v.name)
    return names


def split_forward_at_cuts(program, cut_list, n_fwd_ops: int):
    """``ops[0:n_fwd_ops]`` in ``len(cuts) + 1`` contiguous stages; stage
    i ends with the op that produces the i-th cut var."""
    ops = list(program.global_block().ops[:n_fwd_ops])
    idxs = []
    for name in _cut_names(cut_list):
        prods = [i for i, op in enumerate(ops)
                 if name in op.output_arg_names]
        if not prods:
            raise ValueError("cut var %r is not produced by any forward "
                             "op" % name)
        idxs.append(max(prods))
    if idxs != sorted(idxs):
        raise ValueError("cut_list vars must appear in program order; "
                         "producer indices %r" % idxs)
    bounds = [0] + [i + 1 for i in idxs] + [len(ops)]
    stages = [ops[bounds[i]:bounds[i + 1]] for i in range(len(bounds) - 1)]
    if any(not s for s in stages):
        raise ValueError("empty pipeline stage (consecutive cuts at the "
                         "same op?)")
    return stages


def _stage_rw(ops) -> Tuple[Set[str], Set[str]]:
    written, read_first = set(), set()
    for op in ops:
        for n in op.input_arg_names:
            if n and n not in written:
                read_first.add(n)
        for n in op.output_arg_names:
            if n:
                written.add(n)
    return written, read_first


def _boundary_live_sets(stages, external: Set[str]) -> List[List[str]]:
    """For each boundary i (between stage i and i + 1): the vars written
    by stages <= i and read before written by stages > i, less
    ``external`` (feeds and state, which every stage holds)."""
    rw = [_stage_rw(s) for s in stages]
    live = []
    for i in range(len(stages) - 1):
        produced = set()
        for w, _ in rw[:i + 1]:
            produced |= w
        needed, shadow = set(), set()
        for w, r in rw[i + 1:]:
            needed |= (r - shadow)
            shadow |= w
        live.append(sorted((produced & needed) - external))
    return live


class _StageOps:
    """A stage's op list as ``engine._walk`` runs it."""

    def __init__(self, ops, device):
        from ..observability.profiler import trace_annotation

        infos = OpInfoMap.instance()
        self.labels = trace_annotation(None, list(ops))
        self.ops = []
        for op in ops:
            if op.type in ("while", "conditional_block"):
                raise NotImplementedError(
                    "%s in a pipeline stage: the stages run straight-line "
                    "ops" % op.type)
            info = infos.get(op.type)
            self.ops.append((_RUN, op, info, op_attrs(info, op, device),
                             None, ()))


def _split_backward(program, meta, stages):
    """(extra forward ops of the last stage, backward ops a stage, the
    grad of each param)."""
    block = program.global_block()
    ops = block.ops
    n_fwd = int(meta["n_fwd_ops"])
    writes_grad = [any(GRAD_SUFFIX in n for n in op.output_arg_names if n)
                   for op in ops]
    start = next((i for i in range(n_fwd, len(ops)) if writes_grad[i]),
                 len(ops))
    update_ids = {id(op) for op in meta["update_ops"]}
    end = next((i for i in range(start, len(ops))
                if id(ops[i]) in update_ids or not writes_grad[i]),
               len(ops))
    extra_fwd = list(ops[n_fwd:start])
    bwd = list(ops[start:end])
    stage_of = {op._id: s for s, st in enumerate(stages) for op in st}
    last = len(stages) - 1
    for op in extra_fwd:
        stage_of[op._id] = last
    # a forward var's stage: its producer's, else the first that reads it
    var_stage: Dict[str, int] = {}
    for s, st in enumerate(stages + [extra_fwd]):
        for op in st:
            for n in op.output_arg_names:
                var_stage[n] = min(s, last)
    for s, st in enumerate(stages):
        for op in st:
            for n in op.input_arg_names:
                var_stage.setdefault(n, s)
    assigned = []
    for op in bwd:
        s = stage_of.get(op.attrs.get("_fwd_op_id"))
        if s is None:
            # a grad op without the link (a grad maker's, a sum of
            # partial grads, the loss grad's seed): the stage of the
            # forward vars it names
            bases = [var_stage.get(n.split(GRAD_SUFFIX)[0])
                     for n in op.input_arg_names + op.output_arg_names if n]
            bases = [b for b in bases if b is not None]
            s = min(bases) if bases else last
        assigned.append(s)
    bwd_stages = [[op for op, s in zip(bwd, assigned) if s == k]
                  for k in range(len(stages))]
    # the grad each param's accumulator takes
    acc_map = dict(meta["acc_map"])
    acc_of = {a: p for p, a in acc_map.items()}
    grad_of = {}
    for op in ops[end:]:
        if op.type == "elementwise_add" and op.input("X") and \
                op.input("X")[0] in acc_of and op.output("Out") == \
                op.input("X"):
            grad_of[acc_of[op.input("X")[0]]] = op.input("Y")[0]
    for p, a in acc_map.items():
        grad_of.setdefault(p, a)  # k == 1: the accumulator is the grad
    return extra_fwd, bwd_stages, grad_of


def _pipeline_axes(program, mesh, axis_name):
    """(dp axis or None, shard specs), refused as the JAX engine refuses."""
    shard_specs = dict(getattr(program, "_var_shard_specs", None) or {})
    if getattr(program, "_feed_shard_specs", None):
        raise NotImplementedError(
            "pipeline + per-feed shard specs (sequence parallelism) "
            "is not supported — drop strategy.pipeline or the sp pass")
    model_axes = {a for spec in shard_specs.values() for a in spec if a}
    model_axes |= {op.attrs.get("shard_axis")
                   for op in program.global_block().ops
                   if op.attrs.get("shard_axis")}
    declared_data = set(getattr(program, "_data_axes", None) or ("dp",))
    dp_axes = tuple(a for a in mesh.axis_names
                    if a != axis_name and a not in model_axes)
    bad = [a for a in dp_axes if a not in declared_data]
    if bad:
        raise ValueError(
            "mesh axes %r are neither the pp axis, a model shard axis, "
            "nor declared data axes %r — refusing to guess"
            % (bad, sorted(declared_data)))
    if len(dp_axes) > 1:
        raise NotImplementedError(
            "at most one data axis composes with pp (got %r)" % (dp_axes,))
    for n, spec in shard_specs.items():
        for a in spec:
            if a is not None and a not in mesh.axis_names:
                raise ValueError(
                    "var %r sharded over axis %r absent from mesh %s"
                    % (n, a, list(mesh.axis_names)))
    return (dp_axes[0] if dp_axes else None), shard_specs


# the decline a pipelined step on the card is counted under: the stages
# run eagerly, one walk a stage and microbatch (no capture yet)
EAGER_DECLINE = "pipeline (eager stages)"
_DECLINED: Set[Tuple] = set()  # (program uid, mesh key) counted once
_VERIFIED: Set[Tuple] = set()  # (program uid, version, mesh key)


def pipeline_stats() -> Dict:
    """The last pipelined step's layout: stages, microbatches, the bubble
    fraction ``(S - 1) / (M + S - 1)``, each boundary's forward bytes a
    microbatch and replica, and the largest gap between the model
    replicas' grads of a replicated param (0 where they agree bit for
    bit)."""
    return dict(_LAST)


_LAST: Dict = {}


def run_pipeline_parallel(core, program, scope: Scope, feed: Dict,
                          fetch_list: Sequence, mesh=None,
                          axis_name: str = "pp", return_numpy: bool = True):
    """One full-batch training step, pipelined over the mesh's ``pp`` axis.
    ``feed`` carries the full batch, split into ``num_microbatches`` on
    dim 0 (and each microbatch over the data axis). The one fetch taken is
    the loss, the mean over the microbatches."""
    from .. import observability as _obs
    from .engine import _walk, refuse_host_ops, take_block

    meta = getattr(program, "_pipeline_meta", None)
    if meta is None:
        raise ValueError(
            "program has no pipeline metadata — minimize() it with "
            "PipelineOptimizer(cut_list=...) first")
    stages = split_forward_at_cuts(program, meta["cut_list"],
                                   meta["n_fwd_ops"])
    n_stages = len(stages)
    n_micro = int(meta["num_microbatches"])
    loss_name = meta["loss"]
    if mesh is None:
        mesh = make_mesh([n_stages], [axis_name])
    if mesh.shape.get(axis_name) != n_stages:
        raise ValueError("mesh axis %r has %d devices but cut_list "
                         "defines %d stages"
                         % (axis_name, mesh.shape.get(axis_name, 0),
                            n_stages))
    dp_axis, shard_specs = _pipeline_axes(program, mesh, axis_name)
    dp = mesh.shape[dp_axis] if dp_axis else 1
    block = program.global_block()
    refuse_host_ops(block)
    from ..analysis import maybe_verify_program, verify_enabled

    vkey = (program._uid, program._op_id, mesh_key(mesh))
    if verify_enabled() and vkey not in _VERIFIED:
        # the stage split and the program, once a (program version, mesh)
        from ..analysis.contracts import check_pipeline_split

        check_pipeline_split(program, stages, meta["n_fwd_ops"])
        maybe_verify_program(program, where="parallel.pipeline",
                             scope=scope)
        _VERIFIED.add(vkey)
    if mesh.devices[0].type == "cuda" and \
            (program._uid, mesh_key(mesh)) not in _DECLINED:
        _DECLINED.add((program._uid, mesh_key(mesh)))
        _ce.inc("executor.compile_fallbacks")
        _ce.count_decline(EAGER_DECLINE, counter=None)
        warnings.warn("pipelined program %s runs every step eagerly: "
                      "capture declined (%s)" % (program._uid,
                                                 EAGER_DECLINE))

    feeds = {}
    for name, value in (feed or {}).items():
        t = stage_feed(value.array if isinstance(value, LoDTensor)
                       else value)
        if t.shape[0] % (n_micro * dp):
            raise ValueError(
                "feed %r batch %d not divisible by num_microbatches %d "
                "x dp %d" % (name, t.shape[0], n_micro, dp))
        feeds[name] = t

    extra_fwd, bwd_stages, grad_of = _split_backward(program, meta, stages)
    fwd_stages = [list(s) for s in stages]
    fwd_stages[-1] += extra_fwd

    # the replicas of each stage, in rank order (one a data and model
    # coordinate, the same order on every stage)
    coords = [mesh.coords(r) for r in range(mesh.world_size())]
    devices = mesh.devices
    members = [[r for r, c in enumerate(coords) if c[axis_name] == s]
               for s in range(n_stages)]
    other_axes = [a for a in mesh.axis_names if a != axis_name]
    guards = []
    for s in range(n_stages):
        guards.append({a: AxisGroups(
            [[members[s].index(r) for r in g]
             for g in mesh.axis_groups([a], members[s])],
            [devices[r] for r in members[s]]) for a in other_axes})

    # external state: params and anything else the stages read first
    state_names = set()
    shadow = set()
    for ops in fwd_stages + bwd_stages[::-1]:
        w, r = _stage_rw(ops)
        state_names |= (r - shadow)
        shadow |= w
    state_names -= set(feeds)
    state = {}
    for n in sorted(state_names):
        t = _scope_tensor(scope, n)
        if t is None:
            if block._find_var_recursive(n) is None:
                continue
            raise RuntimeError("var %r must be fed or initialized" % n)
        state[n] = t

    external = set(feeds) | set(state)
    live_fwd = _boundary_live_sets(fwd_stages, external)
    live_bwd = _boundary_live_sets(bwd_stages[::-1], external | {
        n for ops in fwd_stages for op in ops
        for n in op.output_arg_names})

    def replica_state(s):
        envs = []
        for r in members[s]:
            env = {}
            for n, t in state.items():
                spec = shard_specs.get(n)
                b = take_block(t, spec, coords[r], mesh.shape) \
                    if spec and any(spec) else t
                env[n] = b if b.device == devices[r] else b.to(devices[r])
            envs.append(env)
        return envs

    def feed_block(m, r):
        out = {}
        for n, t in feeds.items():
            mb = t.shape[0] // n_micro
            x = t[m * mb:(m + 1) * mb]
            if dp_axis:
                x = x.chunk(dp)[coords[r][dp_axis]]
            out[n] = x.to(devices[r])
        return out

    stage_ops_f = [_StageOps(ops, core.device) for ops in fwd_stages]
    stage_ops_b = [_StageOps(ops, core.device) for ops in bwd_stages]
    base = [replica_state(s) for s in range(n_stages)]
    envs = [[None] * n_micro for _ in range(n_stages)]
    grad_writer = {}
    for s, ops in enumerate(bwd_stages):
        for op in ops:
            for n in op.output_arg_names:
                grad_writer[n] = s
    acc: Dict[str, List] = {}  # param -> its grad summed, a stage replica
    acc_stage: Dict[str, int] = {}
    loss_sums = [None] * len(members[-1])

    def run(s, ops_block, m):
        mem = members[s]
        salts = [m * len(mem) + j for j in range(len(mem))]
        with _obs.tracing.span("pipeline/stage", cat="stage", stage=s,
                               microbatch=m), \
                mesh_axes_guard(guards[s]):
            _walk(ops_block, envs[s][m], [devices[r] for r in mem],
                  core.rng, salts=salts)

    n_ticks = n_micro + n_stages - 1
    t0 = time.perf_counter()
    # fill: stage s runs microbatch t - s; its boundary vars go on
    for t in range(n_ticks):
        for s in range(n_stages):
            m = t - s
            if not 0 <= m < n_micro:
                continue
            if s == 0:
                envs[0][m] = [dict(e) for e in base[0]]
            for j, r in enumerate(members[s]):
                envs[s][m][j].update(feed_block(m, r))
            run(s, stage_ops_f[s], m)
            if s + 1 < n_stages:
                nxt = [dict(e) for e in base[s + 1]]
                for j, r in enumerate(members[s + 1]):
                    for n in live_fwd[s]:
                        v = envs[s][m][j][n]
                        nxt[j][n] = v if v.device == devices[r] \
                            else v.to(devices[r])
                envs[s + 1][m] = nxt
            else:
                for j, e in enumerate(envs[s][m]):
                    v = e[loss_name].reshape(()).to(torch.float32)
                    loss_sums[j] = v if loss_sums[j] is None \
                        else loss_sums[j] + v
    # drain: the backward from the last stage down, microbatches in order
    for t in range(n_ticks):
        for k in range(n_stages):
            s = n_stages - 1 - k
            m = t - k
            if not 0 <= m < n_micro:
                continue
            run(s, stage_ops_b[s], m)
            if s > 0:
                for j, r in enumerate(members[s - 1]):
                    for n in live_bwd[k]:
                        v = envs[s][m][j][n]
                        envs[s - 1][m][j][n] = v if v.device == devices[r] \
                            else v.to(devices[r])
            for p, g in grad_of.items():
                if grad_writer.get(g) != s:
                    continue
                vals = acc.setdefault(p, [None] * len(members[s]))
                for j, e in enumerate(envs[s][m]):
                    vals[j] = (torch.zeros_like(e[g]) if vals[j] is None
                               else vals[j]) + e[g]
                acc_stage[p] = s
            envs[s][m] = None  # this microbatch's activations are done
    step_ms = (time.perf_counter() - t0) * 1e3
    if _obs.tracing.active():
        _obs.tracing._record("pipeline/step", t0 * 1e6, step_ms * 1e3,
                             "step", {"stages": n_stages,
                                      "microbatches": n_micro})

    # the mean over the data axis, the sharded blocks assembled
    def global_grad(p):
        s = acc_stage[p]
        vals = acc[p]
        by_model: Dict[Tuple, List] = {}
        for j, r in enumerate(members[s]):
            key = tuple(coords[r][a] for a in other_axes if a != dp_axis)
            by_model.setdefault(key, []).append((r, vals[j]))
        spec = shard_specs.get(p)
        blocks = {}
        for key, rv in by_model.items():
            tot = rv[0][1]
            for _, v in rv[1:]:
                tot = tot + v.to(tot.device)
            if dp > 1:
                tot = tot / dp
            blocks[key] = (coords[rv[0][0]], tot)
        first = next(iter(blocks.values()))[1]
        if not (spec and any(spec)):
            # a replicated param: every model replica's grad is the same
            for _, v in blocks.values():
                gaps.append((v.to(first.device) - first).abs().max())
            return first
        full = list(first.shape)
        for d, a in enumerate(spec):
            if a:
                full[d] *= mesh.shape[a]
        out = torch.empty(full, dtype=first.dtype, device=first.device)
        for c, v in blocks.values():
            take_block(out, spec, c, mesh.shape).copy_(v.to(out.device))
        return out

    gaps = []
    upd_env = {}
    update_ops = meta["update_ops"]
    upd_w, upd_r = _stage_rw(update_ops)
    for n in upd_r:
        t = _scope_tensor(scope, n)
        if t is not None:
            upd_env[n] = t
    acc_map = meta["acc_map"]
    for p, a in acc_map.items():
        if p in acc:
            upd_env[a] = global_grad(p)
    with mesh_axes_guard({}):
        _walk(_StageOps(update_ops, core.device), [upd_env],
              [core.device], core.rng)
    core.rng.advance()
    for n in upd_w:
        v = block._find_var_recursive(n)
        if v is None or not v.persistable or n.endswith(".pipe_acc") \
                or n not in upd_env:
            continue
        scope.var(n).set(LoDTensor(upd_env[n]))

    last = members[-1]
    by_data = [loss_sums[j] for j, r in enumerate(last)
               if all(coords[r][a] == 0 for a in other_axes
                      if a != dp_axis)]
    loss = by_data[0]
    for v in by_data[1:]:
        loss = loss + v.to(loss.device)
    loss = loss / (n_micro * len(by_data))

    bubble = (n_stages - 1.0) / (n_micro + n_stages - 1.0)
    bytes_mb = []
    for i, names in enumerate(live_fwd):
        b = 0
        for n in names:
            v = block._find_var_recursive(n)
            shape = getattr(v, "shape", None) or ()
            numel = abs(math.prod(int(d) for d in shape)) if shape else 0
            b += numel * 4
        bytes_mb.append(b)
    _LAST.clear()
    _LAST.update({"stages": n_stages, "microbatches": n_micro,
                  "bubble_fraction": bubble, "boundary_bytes": bytes_mb,
                  "model_replica_gap": (float(torch.stack(gaps).max())
                                        if gaps else 0.0)})
    if _obs.enabled():
        _obs.inc("pipeline.steps")
        _obs.observe("pipeline.step_ms", step_ms)
        _obs.set_gauge("pipeline.stages", n_stages)
        _obs.set_gauge("pipeline.microbatches", n_micro)
        _obs.set_gauge("pipeline.bubble_fraction", bubble)
        for i, s in enumerate(fwd_stages):
            _obs.set_gauge("pipeline.stage_ops", len(s), stage=i)

    results = []
    for f in fetch_list or []:
        name = f if isinstance(f, str) else f.name
        if name != loss_name:
            raise NotImplementedError(
                "pipeline fetch supports the loss var only, got %r" % name)
        t = LoDTensor(loss)
        results.append(t.numpy() if return_numpy else t)
    return results
