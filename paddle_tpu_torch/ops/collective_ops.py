"""Collective communication ops (``c_*``), the legacy ``allreduce`` /
``broadcast``, the bucketed and quantized reductions and the cross-replica
sharded weight update.

Counterpart of ``paddle_tpu/ops/collective_ops.py``: every op under the
same type, slots and attrs. Where the JAX package lowers a collective to
the XLA collective of a named mesh axis inside ``shard_map``, the port
names a *group* of replicas:

- ``ReplicaGroup``: the replicas of one process, which the data-parallel
  engine (``parallel/engine.py``) walks in lockstep, one env each. A
  collective runs once for all of them (its form over the replicas,
  ``core.registry.set_group_form``) and reduces in a fixed rank order
  (``((x0 + x1) + x2) + ...``), so a run is reproducible bit for bit and a
  concat-then-sum is elementwise the sum-then-concat. Each replica gets its
  own copy of the result: replicas never share a buffer.
- ``AxisGroups``: a named axis of a mesh of several axes (or a set of
  axes): one ``ReplicaGroup`` a subgroup, the replicas that differ only on
  that axis. The engine runs a collective once a subgroup.
- ``ProcessGroupAxis``: one replica a process, the group a
  ``torch.distributed`` process group (gloo for CPU tensors, NCCL across
  distinct cards); the op calls the ``torch.distributed`` collective.

``ring_axis_guard`` maps ring ids to groups while the engine runs a step,
as the JAX engine maps them to mesh axis names; ``mesh_axes_guard`` names
the live axes and their groups (``c_sharded_update``'s ``shard_axis``, the
hybrid ops' ``shard_axis``): an op over a live axis runs through its form
over the subgroup that holds each replica, where ``axis_index`` is the
replica's position and ``ppermute`` the ring rotation ``r -> r + 1 mod
n`` (``lax.axis_index`` and ``lax.ppermute`` in the JAX package).
Outside both (one replica, world 1) every collective is the identity, as
in the JAX package; ``c_sharded_update`` then runs its dense form. The
host ops (``c_gen_nccl_id``, ``c_comm_init``, ``c_sync_calc_stream``,
``c_sync_comm_stream``, ``barrier``) keep their no-op or pass-through
bodies: ``torch.distributed.init_process_group`` is the rendezvous
(``dygraph/parallel.prepare_context``).

``strategy_psum`` spells a reduction over a group as ``ring`` (the one
rank-order sum), ``tree`` (a reduce-scatter and then an all-gather: the
ring's bits) or ``two_stage`` (one sum over each data axis of the mesh in
turn, ``ReplicaGroup.stages``). ``c_bucket_allreduce_start`` /
``c_bucket_allreduce_await`` split a bucket reduction: over a process group
the start issues it with ``async_op=True`` and the await waits on its work
handle. ``quantized_psum`` is the JAX function over a group: ``bf16`` sums the
payload in bfloat16; ``int8`` scales every replica by the same step (the
group's max of the local absmax, / 127), rounds half to even into
[-127, 127] and sums the codes in int32, with EQuARX error feedback when a
residual is given. ``c_sharded_update`` updates each replica's 1/n shard of
the flat parameters and state with the K4 wrapper
(``ops/cuda/fused_optimizer.fused_optimizer_update``: the CUDA kernel on the
card, its plain version on the CPU), the port of the shard math the JAX op
takes from ``optimizer_ops``."""
from __future__ import annotations

from functools import reduce
from typing import Dict, List, Optional

import torch

from ..core.registry import (In, Out, register_host_op, register_op,
                             set_group_form)

# -- groups ---------------------------------------------------------------------


class ReplicaGroup:
    """The replicas of one process, walked in lockstep. Every method takes
    and returns one tensor a replica, in rank order."""

    in_process = True

    def __init__(self, devices, stages=None):
        self.devices = [torch.device(d) for d in devices]
        self.nranks = len(self.devices)
        # the two-stage spelling's stages: for each data axis of the mesh,
        # the positions in this group that differ only on that axis
        self.stages = stages

    def parts(self):
        """(replica positions, group) of each subgroup: here one."""
        return [(list(range(self.nranks)), self)]

    def axis_index(self, local: int) -> int:
        return local

    def ppermute(self, xs, shift: int = 1):
        """The ring rotation: replica r gets ``xs[(r - shift) % n]``."""
        n = self.nranks
        return [xs[(r - shift) % n].to(d, copy=True)
                for r, d in enumerate(self.devices)]

    def _spread(self, acc: torch.Tensor) -> List[torch.Tensor]:
        return [acc if r == 0 else acc.to(d, copy=True)
                for r, d in enumerate(self.devices)]

    def _fold(self, xs, fn) -> torch.Tensor:
        dev = xs[0].device
        return reduce(lambda a, b: fn(a, b.to(dev)), xs[1:], xs[0])

    def psum(self, xs):
        return self._spread(self._fold(xs, torch.add))

    def pmax(self, xs):
        return self._spread(self._fold(xs, torch.maximum))

    def pmin(self, xs):
        return self._spread(self._fold(xs, torch.minimum))

    def all_gather(self, xs):
        """``[n, *x.shape]`` on every replica."""
        dev = xs[0].device
        return self._spread(torch.stack([x.to(dev) for x in xs]))

    def broadcast(self, xs, root: int):
        return [xs[root].to(d, copy=True) for d in self.devices]

    def psum_scatter(self, xs):
        """Replica r gets rows r * m / n ... of the sum (dim 0, tiled)."""
        total = self._fold(xs, torch.add)
        return [c.to(d, copy=True) for c, d in
                zip(total.chunk(self.nranks), self.devices)]

    def all_to_all(self, xs):
        """``xs[r]`` is ``[n, ...]``; replica r gets ``[xs[i][r] for i]``."""
        return [torch.stack([x[r].to(d) for x in xs])
                for r, d in enumerate(self.devices)]


class AxisGroups:
    """A named axis (or set of axes) over replicas walked in lockstep: one
    ``ReplicaGroup`` a subgroup. ``subgroups`` lists each subgroup's
    replica positions, in rank order."""

    in_process = True

    def __init__(self, subgroups, devices, stage_axes=None):
        """``stage_axes``: one list of subgroups (replica ranks) a mesh axis
        the group spans, in the order a two-stage reduction sums over
        them."""
        self.subgroups = [list(g) for g in subgroups]
        self.groups = [ReplicaGroup([devices[r] for r in g],
                                    _stages_of(g, stage_axes))
                       for g in self.subgroups]

    def parts(self):
        return list(zip(self.subgroups, self.groups))


def _stages_of(ranks, stage_axes):
    """Each axis's partition of ``ranks`` into positions of the group; None
    when fewer than two axes split it (two stages would be one)."""
    if not stage_axes:
        return None
    pos = {r: i for i, r in enumerate(ranks)}
    stages = []
    for parts in stage_axes:
        stage = [[pos[r] for r in part if r in pos] for part in parts]
        stage = [p for p in stage if p]
        if any(len(p) > 1 for p in stage):
            stages.append(stage)
    return stages if len(stages) > 1 else None


class ProcessGroupAxis:
    """One replica a process over a ``torch.distributed`` group."""

    in_process = False

    def __init__(self, group=None):
        import torch.distributed as dist

        self.group = group
        self.nranks = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = str(dist.get_backend(group))

    def axis_index(self, local: int) -> int:
        return self.rank

    def _reduce(self, xs, op):
        import torch.distributed as dist

        y = xs[0].reshape(-1).clone()  # a 0-d value travels as [1]
        dist.all_reduce(y, op=op, group=self.group)
        return [y.reshape(xs[0].shape)]

    def psum(self, xs):
        import torch.distributed as dist

        return self._reduce(xs, dist.ReduceOp.SUM)

    def pmax(self, xs):
        import torch.distributed as dist

        return self._reduce(xs, dist.ReduceOp.MAX)

    def pmin(self, xs):
        import torch.distributed as dist

        return self._reduce(xs, dist.ReduceOp.MIN)

    def all_gather(self, xs):
        import torch.distributed as dist

        x = xs[0].contiguous()
        # gloo gathers host tensors only
        staged = x.cpu() if self.backend == "gloo" else x
        parts = [torch.empty_like(staged) for _ in range(self.nranks)]
        dist.all_gather(parts, staged, group=self.group)
        return [torch.stack(parts).to(x.device)]

    def broadcast(self, xs, root: int):
        import torch.distributed as dist

        y = xs[0].clone()
        dist.broadcast(y, src=dist.get_global_rank(self.group, root)
                       if self.group is not None else root, group=self.group)
        return [y]

    def psum_scatter(self, xs):
        total = self.psum(xs)[0]
        return [total.chunk(self.nranks)[self.rank].clone()]

    def all_to_all(self, xs):
        import torch.distributed as dist

        if self.backend == "gloo":  # gloo has no all_to_all
            return [self.all_gather(xs)[0][:, self.rank].contiguous()]
        x = xs[0].contiguous()
        outs = [torch.empty_like(x[0]) for _ in range(self.nranks)]
        dist.all_to_all(outs, list(x.unbind(0)), group=self.group)
        return [torch.stack(outs)]


# ring_id -> group, set while the engine runs a step
_ACTIVE_RING_AXES: Dict[int, object] = {}


class ring_axis_guard:
    """Maps ring ids to the groups live in the current step."""

    def __init__(self, mapping: Dict[int, object]):
        self.mapping = dict(mapping)

    def __enter__(self):
        self._saved = dict(_ACTIVE_RING_AXES)
        _ACTIVE_RING_AXES.update(self.mapping)
        return self

    def __exit__(self, *exc):
        _ACTIVE_RING_AXES.clear()
        _ACTIVE_RING_AXES.update(self._saved)
        return False


def axis_for_ring(ring_id: int):
    return _ACTIVE_RING_AXES.get(ring_id, _ACTIVE_RING_AXES.get(-1))


# mesh axis name -> group, live in the current step
_ACTIVE_MESH_AXES: Dict[str, object] = {}


class mesh_axes_guard:
    """Declares which named axes are live, and their groups."""

    def __init__(self, axes):
        self.axes = dict(axes or {})

    def __enter__(self):
        self._saved = dict(_ACTIVE_MESH_AXES)
        _ACTIVE_MESH_AXES.update(self.axes)
        return self

    def __exit__(self, *exc):
        _ACTIVE_MESH_AXES.clear()
        _ACTIVE_MESH_AXES.update(self._saved)
        return False


def mesh_axis_active(name: Optional[str]) -> bool:
    return bool(name) and name in _ACTIVE_MESH_AXES


def group_for_axis(name: Optional[str]):
    return _ACTIVE_MESH_AXES.get(name) if name else None


def _ring_group(attrs):
    # ``_mesh_axis``: a reduction over one named axis of the mesh alone
    # (the data-parallel pass's allreduce of a grad sharded over another
    # data axis)
    axis = attrs.get("_mesh_axis")
    if axis:
        return group_for_axis(axis)
    return axis_for_ring(attrs.get("ring_id", 0))


def register_collective(type: str, inputs, outputs, attrs, group_of=None):
    """Register ``group_fn(ins_list, attrs, group)`` (group None: no live
    group, one replica) as op ``type``: its plain function calls it with
    this replica's inputs, and the engine calls it with every replica's."""
    group_of = group_of or _ring_group

    def deco(group_fn):
        def single(ins, attrs, _type=type):
            group = group_of(attrs)
            if group is not None and group.in_process:
                raise RuntimeError(
                    "%s reached one replica of an in-process group: a "
                    "collective runs through the data-parallel engine's "
                    "replica walk (not inside a while or conditional "
                    "block)" % _type)
            return group_fn([ins], attrs, group)[0]

        register_op(type, inputs=inputs, outputs=outputs, attrs=attrs,
                    grad=None)(single)
        set_group_form(type, group_of, group_fn)
        return group_fn

    return deco


def _each(fn, ins_list, slot="X", out="Out"):
    return [{out: fn(ins[slot])} for ins in ins_list]


def _allreduce(name, reducer):
    @register_collective(
        name, inputs=[In("X")], outputs=[Out("Out")],
        attrs={"ring_id": 0, "use_calc_stream": False,
               "use_model_parallel": False})
    def _op(ins_list, attrs, group, _red=reducer):
        xs = [ins["X"] for ins in ins_list]
        if group is None:
            return [{"Out": x} for x in xs]
        return [{"Out": y} for y in _red(group, xs)]

    return _op


_allreduce("c_allreduce_sum", lambda g, xs: g.psum(xs))
_allreduce("c_allreduce_max", lambda g, xs: g.pmax(xs))
_allreduce("c_allreduce_min", lambda g, xs: g.pmin(xs))
_allreduce("c_allreduce_prod",
           lambda g, xs: [torch.exp(s) for s in
                          g.psum([torch.log(x) for x in xs])])


@register_collective(
    "c_broadcast", inputs=[In("X")], outputs=[Out("Out")],
    attrs={"ring_id": 0, "root": 0, "use_calc_stream": False})
def _c_broadcast(ins_list, attrs, group):
    xs = [ins["X"] for ins in ins_list]
    if group is None:
        return [{"Out": x} for x in xs]
    return [{"Out": y}
            for y in group.broadcast(xs, int(attrs.get("root", 0)))]


@register_collective(
    "c_allgather", inputs=[In("X")], outputs=[Out("Out")],
    attrs={"ring_id": 0, "nranks": 1, "use_calc_stream": False})
def _c_allgather(ins_list, attrs, group):
    xs = [ins["X"] for ins in ins_list]
    if group is None:
        return [{"Out": x} for x in xs]
    return [{"Out": g.reshape((-1,) + tuple(x.shape[1:]))}
            for g, x in zip(group.all_gather(xs), xs)]


@register_collective(
    "c_reducescatter", inputs=[In("X")], outputs=[Out("Out")],
    attrs={"ring_id": 0, "nranks": 1, "use_calc_stream": False})
def _c_reducescatter(ins_list, attrs, group):
    xs = [ins["X"] for ins in ins_list]
    if group is None:
        return [{"Out": x} for x in xs]
    return [{"Out": y} for y in group.psum_scatter(xs)]


@register_collective(
    "c_concat", inputs=[In("X")], outputs=[Out("Out")],
    attrs={"ring_id": 0, "nranks": 1, "rank": 0})
def _c_concat(ins_list, attrs, group):
    xs = [ins["X"] for ins in ins_list]
    if group is None:
        return [{"Out": x} for x in xs]
    return [{"Out": torch.cat(list(g.unbind(0)), dim=-1)}
            for g in group.all_gather(xs)]


@register_collective(
    "alltoall", inputs=[In("X")], outputs=[Out("Out")],
    attrs={"ring_id": 0})
def _alltoall(ins_list, attrs, group):
    xs = [ins["X"] for ins in ins_list]
    if group is None:
        return [{"Out": x} for x in xs]
    n = group.nranks
    split = [x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
             for x in xs]
    return [{"Out": y.reshape(x.shape)}
            for y, x in zip(group.all_to_all(split), xs)]


# -- bootstrap / sync: host ops ---------------------------------------------------


@register_host_op("c_gen_nccl_id", inputs=[],
                  outputs=[Out("Out", dispensable=True)],
                  attrs={"rank": 0, "endpoint": "", "other_endpoints": [],
                         "ring_id": 0})
def _c_gen_nccl_id(executor, op, scope):
    # the rendezvous is torch.distributed.init_process_group's, at launch
    pass


@register_host_op("c_comm_init", inputs=[In("X", dispensable=True)],
                  outputs=[],
                  attrs={"nranks": 1, "rank": 0, "device_id": 0,
                         "ring_id": 0})
def _c_comm_init(executor, op, scope):
    pass


@register_host_op("c_sync_calc_stream", inputs=[In("X")],
                  outputs=[Out("Out")], attrs={})
def _c_sync_calc_stream(executor, op, scope):
    # the collectives run on the compute stream: program order is the sync
    executor._write_var(scope, op.output("Out")[0],
                        executor._read_var(scope, op.input("X")[0]))


@register_host_op("c_sync_comm_stream", inputs=[In("X")],
                  outputs=[Out("Out")], attrs={"ring_id": 0})
def _c_sync_comm_stream(executor, op, scope):
    executor._write_var(scope, op.output("Out")[0],
                        executor._read_var(scope, op.input("X")[0]))


@register_host_op("barrier", inputs=[In("X", dispensable=True)],
                  outputs=[Out("Out", dispensable=True)],
                  attrs={"ring_id": 0})
def _barrier(executor, op, scope):
    pass


def _pprod(group, xs):
    mags = group.psum([torch.log(torch.abs(x) + 1e-38) for x in xs])
    negs = group.psum([(x < 0).to(torch.int32) for x in xs])
    return [torch.exp(m) * torch.where(n % 2 == 1, -1.0, 1.0).to(m.dtype)
            for m, n in zip(mags, negs)]


@register_collective(
    "allreduce", inputs=[In("X")], outputs=[Out("Out")],
    attrs={"reduce_type": 0, "sync_mode": False},
    group_of=lambda attrs: axis_for_ring(0))
def _allreduce_legacy(ins_list, attrs, group):
    """Legacy dygraph-DP allreduce (reduce_type 0..3 = sum / prod / max /
    min over ring 0)."""
    xs = [ins["X"] for ins in ins_list]
    if group is None:
        return [{"Out": x} for x in xs]
    rt = int(attrs.get("reduce_type", 0))
    fns = {0: group.psum, 1: lambda v: _pprod(group, v), 2: group.pmax,
           3: group.pmin}
    if rt not in fns:
        raise ValueError("allreduce: bad reduce_type %d" % rt)
    return [{"Out": y} for y in fns[rt](xs)]


@register_collective(
    "broadcast", inputs=[In("X")], outputs=[Out("Out")],
    attrs={"sync_mode": False, "root": 0},
    group_of=lambda attrs: axis_for_ring(0))
def _broadcast_legacy(ins_list, attrs, group):
    return _c_broadcast(ins_list, {**attrs, "ring_id": 0}, group)


# -- bucketed / quantized collectives (parallel/collectives.py rewrites) -------

# wire width per element a native quantized collective would move; None
# means the tensor's own itemsize
QUANT_WIRE_ITEMSIZE = {"none": None, "bf16": 2, "int8": 1}

# payload width per element the reduction here moves: bf16 crosses as bf16,
# int8 codes are summed in int32 (4 bytes an element)
QUANT_PSUM_ITEMSIZE = {"none": None, "bf16": 2, "int8": 4}

# the spellings of one reduction (the placement search's swap dimension):
#   ring       the one rank-order sum over the group
#   tree       a reduce-scatter and then an all-gather over the group (the
#              ring's bits: each shard is the rank-order sum of its slice)
#   two_stage  one sum over each data axis of the mesh in turn (another
#              association of the sum; the ring where one axis spans the
#              group)
REDUCTION_STRATEGIES = ("ring", "tree", "two_stage")


def _tree_gather(shards, group, numel):
    """The all-gather half of the tree spelling: every replica's shard,
    stacked, cut back to ``numel``."""
    return [g.reshape(-1)[:numel] for g in group.all_gather(shards)]


def strategy_psum(xs, group, strategy="ring"):
    """The sum of ``xs`` (one tensor a replica) over ``group``, spelled per
    ``strategy`` (``REDUCTION_STRATEGIES``). Integer payloads are exact
    under every spelling."""
    if strategy in (None, "", "auto", "ring"):
        return group.psum(xs)
    if strategy == "tree":
        n = group.nranks
        numel = xs[0].numel()
        pad = (-numel) % n
        flats = [x.reshape(-1) if not pad else torch.cat(
            [x.reshape(-1), x.new_zeros(pad)]) for x in xs]
        full = _tree_gather(group.psum_scatter(flats), group, numel)
        return [f.reshape(x.shape) for f, x in zip(full, xs)]
    if strategy == "two_stage":
        stages = getattr(group, "stages", None)
        if not stages:
            return group.psum(xs)
        out = list(xs)
        for stage in stages:
            nxt = list(out)
            for pos in stage:
                sub = ReplicaGroup([group.devices[p] for p in pos])
                for p, y in zip(pos, sub.psum([out[p] for p in pos])):
                    nxt[p] = y
            out = nxt
        return out
    raise ValueError("unknown reduction strategy %r (want one of %s)"
                     % (strategy, ", ".join(REDUCTION_STRATEGIES)))


def _quantize(srcs, group, quant):
    """(payloads, finish, new residuals of srcs) of a compressed reduction:
    ``finish(reduced payloads)`` widens the sums back."""
    if quant == "bf16":
        qs = [s.to(torch.bfloat16) for s in srcs]
        return (qs, lambda ys: [y.to(s.dtype) for y, s in zip(ys, srcs)],
                [s - q.to(s.dtype) for s, q in zip(srcs, qs)])
    if quant == "int8":
        absmax = group.pmax([s.abs().max() for s in srcs])
        scales = [torch.where(a > 0, a / 127.0,
                              torch.ones_like(a)).to(s.dtype)
                  for a, s in zip(absmax, srcs)]
        qs = [torch.clamp(torch.round(s / sc), -127, 127).to(torch.int32)
              for s, sc in zip(srcs, scales)]
        return (qs, lambda ys: [y.to(s.dtype) * sc
                                for y, s, sc in zip(ys, srcs, scales)],
                [s - q.to(s.dtype) * sc
                 for s, q, sc in zip(srcs, qs, scales)])
    raise ValueError("unknown quantized-allreduce mode %r" % (quant,))


def quantized_psum(xs, group, quant="none", residuals=None,
                   strategy="ring"):
    """psum of one tensor a replica with an optional compressed payload
    (``paddle_tpu/ops/collective_ops.py:quantized_psum``), spelled per
    ``strategy``. With ``residuals`` (one a replica) returns ``(reduced,
    new_residuals)``."""
    if quant in (None, "", "none"):
        out = strategy_psum(xs, group, strategy)
        return out if residuals is None else (out, list(residuals))
    srcs = (list(xs) if residuals is None
            else [x + r for x, r in zip(xs, residuals)])
    qs, finish, new_res = _quantize(srcs, group, quant)
    out = finish(strategy_psum(qs, group, strategy))
    return out if residuals is None else (out, new_res)


def _flat_concat(xs):
    if len(xs) == 1:
        return xs[0].reshape(-1)
    return torch.cat([x.reshape(-1) for x in xs])


def _slice_back(red, xs):
    outs, off = [], 0
    for x in xs:
        k = x.numel()
        outs.append(red[off:off + k].reshape(x.shape))
        off += k
    return outs


def _bucket_reduce(ins_list, attrs, group):
    """(reduced flat a replica, new residual a replica or None)."""
    flats = [_flat_concat(ins["X"]) for ins in ins_list]
    residuals = [ins.get("Residual") for ins in ins_list]
    if residuals[0] is None:
        residuals = None
    if group is None:
        return flats, residuals
    quant = attrs.get("quant", "none")
    strategy = attrs.get("strategy", "ring")
    if residuals is not None:
        return quantized_psum(flats, group, quant, residuals, strategy)
    return quantized_psum(flats, group, quant, strategy=strategy), None


@register_collective(
    "c_bucket_allreduce",
    inputs=[In("X", duplicable=True), In("Residual", dispensable=True)],
    outputs=[Out("Out", duplicable=True),
             Out("ResidualOut", dispensable=True)],
    attrs={"ring_id": 0, "quant": "none", "strategy": "ring",
           "use_calc_stream": True})
def _c_bucket_allreduce(ins_list, attrs, group):
    """N same-dtype grads coalesced into one flat psum (the bucketed form
    of N per-grad ``c_allreduce_sum`` ops), spelled per its ``strategy``;
    a bound Residual arms error feedback. With no group: the identity, the
    residual untouched."""
    if group is None:
        return [{"Out": list(ins["X"]), "ResidualOut": ins.get("Residual")}
                for ins in ins_list]
    reds, new_res = _bucket_reduce(ins_list, attrs, group)
    return [{"Out": _slice_back(red, ins["X"]),
             "ResidualOut": None if new_res is None else new_res[r]}
            for r, (red, ins) in enumerate(zip(reds, ins_list))]


# the reductions a start op issued over a process group and its await has
# not waited on: id(Pending) -> (Pending, work handle, finish)
_IN_FLIGHT: Dict[int, tuple] = {}


def _start_in_flight(ins, attrs, group):
    """Issue one replica's bucket reduction over a ``torch.distributed``
    group with ``async_op=True``; the await op waits on its handle. The
    int8 scale (a max over the group) is agreed on before the sum is
    issued."""
    import torch.distributed as dist

    flat = _flat_concat(ins["X"])
    residual = ins.get("Residual")
    src = flat if residual is None else flat + residual
    quant = attrs.get("quant", "none")
    if quant in (None, "", "none"):
        payload, finish, new_res = src.clone(), (lambda y: y), residual
    else:
        (payload,), fin, (new_res,) = _quantize([src], group, quant)
        if residual is None:
            new_res = None
        finish = (lambda y, _fin=fin: _fin([y])[0])
    strategy = attrs.get("strategy", "ring")
    if strategy not in REDUCTION_STRATEGIES:
        raise ValueError("unknown reduction strategy %r" % (strategy,))
    if strategy == "tree":
        # the reduce-scatter half in flight (gloo has no reduce_scatter:
        # the sum, of which each rank keeps its slice), the all-gather at
        # the await
        n, numel = group.nranks, payload.numel()
        pad = (-numel) % n
        if pad:
            payload = torch.cat([payload, payload.new_zeros(pad)])
        reduce_fin = finish

        def finish(y, _n=n, _numel=numel):
            shard = y.chunk(_n)[group.rank].clone()
            return reduce_fin(_tree_gather([shard], group, _numel)[0])
    work = dist.all_reduce(payload, group=group.group, async_op=True)
    _IN_FLIGHT[id(payload)] = (payload, work, finish)
    return {"Pending": payload, "ResidualOut": new_res}


def _landed(pending):
    """The reduced flat of a Pending buffer: waited on and widened when a
    start op left it in flight, else the buffer itself."""
    entry = _IN_FLIGHT.get(id(pending))
    if entry is None or entry[0] is not pending:
        return pending
    del _IN_FLIGHT[id(pending)]
    entry[1].wait()
    return entry[2](pending)


@register_collective(
    "c_bucket_allreduce_start",
    inputs=[In("X", duplicable=True), In("Residual", dispensable=True)],
    outputs=[Out("Pending"), Out("ResidualOut", dispensable=True)],
    attrs={"ring_id": 0, "quant": "none", "strategy": "ring",
           "use_calc_stream": True})
def _c_bucket_allreduce_start(ins_list, attrs, group):
    """The first half of an async bucket reduction
    (``parallel/scheduling.schedule_async_collectives``): the flat
    reduction of the bucket into ``Pending``, which the matching
    ``c_bucket_allreduce_await`` slices back into the grads before their
    first later use. Over the replicas of one process the reduction
    completes here; over a process group it is issued with
    ``async_op=True`` and completes at the await. With no group
    ``Pending`` is the unreduced concat (the identity)."""
    if group is None:
        return [{"Pending": _flat_concat(ins["X"]),
                 "ResidualOut": ins.get("Residual")} for ins in ins_list]
    if not group.in_process:
        return [_start_in_flight(ins, attrs, group) for ins in ins_list]
    reds, new_res = _bucket_reduce(ins_list, attrs, group)
    return [{"Pending": red,
             "ResidualOut": None if new_res is None else new_res[r]}
            for r, red in enumerate(reds)]


@register_collective(
    "c_bucket_allreduce_await",
    inputs=[In("Pending"), In("X", duplicable=True)],
    outputs=[Out("Out", duplicable=True)],
    attrs={"ring_id": 0, "use_calc_stream": True})
def _c_bucket_allreduce_await(ins_list, attrs, group):
    """The second half: waits on the start's reduction where it is in
    flight and slices ``Pending`` back into the member grads. It carries
    no payload of its own (X is read for the members' shapes)."""
    return [{"Out": _slice_back(_landed(ins["Pending"]), ins["X"])}
            for ins in ins_list]


# state slots each sharded-update optimizer carries, in (StateA, StateB)
# order
SHARDED_UPDATE_SLOTS = {
    "sgd": (),
    "momentum": ("Velocity",),
    "adam": ("Moment1", "Moment2"),
    "adamw": ("Moment1", "Moment2"),
}


def _sharded_group(attrs):
    return group_for_axis(attrs.get("shard_axis") or None)


def _pad_to(flat, padded):
    if padded > flat.numel():
        return torch.cat([flat, flat.new_zeros(padded - flat.numel())])
    return flat


@register_collective(
    "c_sharded_update",
    inputs=[In("Param", duplicable=True), In("Grad", duplicable=True),
            In("LearningRate"),
            In("StateA", dispensable=True), In("StateB", dispensable=True),
            In("Beta1Pow", duplicable=True, dispensable=True),
            In("Beta2Pow", duplicable=True, dispensable=True)],
    outputs=[Out("ParamOut", duplicable=True),
             Out("StateAOut", dispensable=True),
             Out("StateBOut", dispensable=True),
             Out("Beta1PowOut", duplicable=True, dispensable=True),
             Out("Beta2PowOut", duplicable=True, dispensable=True)],
    attrs={"op_type": "sgd", "shard_axis": "", "nranks": 1,
           "padded_size": 0, "quant": "none"},
    group_of=_sharded_group)
def _c_sharded_update(ins_list, attrs, group):
    """Cross-replica sharded weight update: one flat (optionally
    quantized) psum of the group's grads; each replica updates its 1/n
    shard of the flat params with its shard of the flat state (StateA /
    StateB arrive as the replica's shard) through K4; one all-gather of
    the updated shards. With no group the same update runs on the full
    flat arrays (the dense form)."""
    from .cuda.fused_optimizer import fused_optimizer_update

    op_type = attrs["op_type"]
    slots = SHARDED_UPDATE_SLOTS[op_type]
    quant = attrs.get("quant", "none")
    params0 = ins_list[0]["Param"]
    sizes = [p.numel() for p in params0]
    total = sum(sizes)
    padded = int(attrs.get("padded_size") or total)
    g_flats = [_pad_to(_flat_concat([g.to(p.dtype) for g, p in
                                     zip(ins["Grad"], ins["Param"])]),
                       padded) for ins in ins_list]
    p_flats = [_pad_to(_flat_concat(ins["Param"]), padded)
               for ins in ins_list]
    if group is not None:
        shard = padded // int(attrs.get("nranks", 1))
        g_sums = quantized_psum(g_flats, group, quant)
    updated = []
    for r, ins in enumerate(ins_list):
        sa = ins.get("StateA") if slots else None
        sb = ins.get("StateB") if len(slots) > 1 else None
        b1 = ins["Beta1Pow"][0].reshape(1) if ins.get("Beta1Pow") else None
        b2 = ins["Beta2Pow"][0].reshape(1) if ins.get("Beta2Pow") else None
        if group is None:
            g, p = g_flats[r], p_flats[r]
        else:
            start = group.axis_index(r) * shard
            g = g_sums[r][start:start + shard]
            p = p_flats[r][start:start + shard]
        updated.append(fused_optimizer_update(
            op_type, attrs, p, g, ins["LearningRate"].reshape(1), sa, sb,
            b1, b2))
    if group is None:
        p_news = [u[0][:total] for u in updated]
    else:
        p_news = [g.reshape(-1)[:total]
                  for g in group.all_gather([u[0] for u in updated])]
    results = []
    for ins, p_new, (_, sa_out, sb_out) in zip(ins_list, p_news, updated):
        res = {"ParamOut": [c.view(p.shape) for p, c in
                            zip(ins["Param"], p_new.split(sizes))],
               "StateAOut": sa_out if slots else None,
               "StateBOut": sb_out if len(slots) > 1 else None}
        for slot, beta, dflt in (("Beta1Pow", "beta1", 0.9),
                                 ("Beta2Pow", "beta2", 0.999)):
            if ins.get(slot):
                b = attrs.get(beta, dflt)
                res[slot + "Out"] = [t * b for t in ins[slot]]
        results.append(res)
    return results
