"""The LoD rank-table host ops, ``DynamicRNN``'s substrate: the port's copy
of ``paddle_tpu/ops/gap_ops.py:411-663`` (``LoDRankTable``,
``lod_rank_table``, ``max_sequence_len``, ``lod_tensor_to_array`` and
``array_to_lod_tensor`` with their adjoint grad makers,
``shrink_rnn_memory`` and its grad, ``reorder_lod_tensor_by_rank``,
``rank_table_boot_memory``), the same slots and attrs.

They read LoDs and the step counter on the host and build their row
indices there, once a call; the rows stay on the op's device and move by
``index_select`` through an index copied there once (``lod_utils``).

Two of them follow the reference's semantics where the JAX package's do
not (ROADMAP.md lists the faults the port does not copy):

- ``shrink_rnn_memory`` keeps the first k *sequences* of an input that
  carries a LoD (the reference's ``shrink_rnn_memory_op.cc``: the LoD's
  first k sequences and their rows, the sub-LoD kept), where the JAX
  package keeps the first k rows. ``DynamicRNN.static_input`` shrinks its
  reordered input this way each step, as the reference's does. Its grad
  zero-pads the rows the shrink dropped.
- ``reorder_lod_tensor_by_rank`` has a grad, ``reorder_lod_tensor_by_rank
  _grad``, which puts the rows back in the input's order (the reference's
  ``ReorderLoDTensorByRankGradOp``); the JAX package registers none, so no
  grad reaches a ``DynamicRNN``'s ``memory(init=)`` or ``static_input``.
"""
from __future__ import annotations

import torch

from ..backward import bind_partial_grad
from ..core import dtypes as _dt
from ..core.registry import In, Out, register_host_op
from ..core.tensor import LoDTensor, LoDTensorArray
from .lod_utils import host_index


class LoDRankTable:
    """(index, length) items sorted by length, longest first, stable
    (``lod_rank_table.h``): the order a time-major RNN steps its
    sequences in. ``level`` is the LoD level the lengths came from:
    ``lod_tensor_to_array`` takes sub-sequences at level + 1 against it."""

    def __init__(self, items, level: int = 0):
        self.items = list(items)  # [(original sequence index, length)]
        self.level = int(level)

    def active_at(self, t: int) -> int:
        return sum(1 for _, ln in self.items if ln > t)

    def max_len(self) -> int:
        return self.items[0][1] if self.items else 0


def _holder(scope, name):
    return scope.find_var(name).raw()


@register_host_op("lod_rank_table", inputs=[In("X", no_grad=True)],
                  outputs=[Out("Out")], attrs={"level": 0})
def _lod_rank_table(executor, op, scope):
    t = _holder(scope, op.input("X")[0])
    lod = t.lod()
    level = int(op.attrs.get("level", 0))
    if lod:
        offs = lod[level]
        lengths = [offs[i + 1] - offs[i] for i in range(len(offs) - 1)]
    else:
        lengths = [1] * int(t.array.shape[0])
    items = sorted(enumerate(lengths), key=lambda kv: -kv[1])
    scope.var(op.output("Out")[0]).set(LoDRankTable(items, level))


@register_host_op("max_sequence_len",
                  inputs=[In("RankTable", no_grad=True)],
                  outputs=[Out("Out")])
def _max_sequence_len(executor, op, scope):
    table = _holder(scope, op.input("RankTable")[0])
    executor._write_var(scope, op.output("Out")[0], torch.tensor(
        [table.max_len()], dtype=torch.int64, device=executor.device))


def _adjoint_maker(grad_type):
    """``lod_tensor_to_array`` and ``array_to_lod_tensor`` are each
    other's adjoint: the grad of one is the other over the out-grad, with
    the same rank table."""

    def maker(block, op, pending, finalize):
        g_out = finalize(op.output("Out")[0])
        if g_out is None:
            return
        gname = bind_partial_grad(block, pending, op.input("X")[0])
        block.append_op(
            grad_type, {"X": [g_out], "RankTable": [op.input("RankTable")[0]]},
            {"Out": [gname]}, {}, infer_shape=False)

    return maker


@register_host_op("lod_tensor_to_array",
                  inputs=[In("X"), In("RankTable", no_grad=True)],
                  outputs=[Out("Out")],
                  grad=_adjoint_maker("array_to_lod_tensor"))
def _lod_tensor_to_array(executor, op, scope):
    """X split into a time-major array by the rank table
    (``lod_tensor_to_array_op.cc``): entry t stacks row t of every
    sequence still active at step t, in rank order; under a deeper LoD
    level each item is a whole sub-sequence, and the entry carries their
    LoD."""
    xv = _holder(scope, op.input("X")[0])
    table = _holder(scope, op.input("RankTable")[0])
    x, lod = xv.array, xv.lod()
    level = table.level
    offsets = lod[level] if lod else list(range(int(x.shape[0]) + 1))
    deeper = lod[level + 1] if lod and len(lod) > level + 1 else None
    arr = LoDTensorArray()
    for t in range(table.max_len()):
        rows, sub = [], [0]
        for idx, ln in table.items:
            if ln <= t:
                continue
            s = offsets[idx] + t
            r0, r1 = (deeper[s], deeper[s + 1]) if deeper is not None \
                else (s, s + 1)
            rows.extend(range(r0, r1))
            sub.append(sub[-1] + r1 - r0)
        arr.append(LoDTensor(x.index_select(0, host_index(rows, x.device)),
                             [sub] if deeper is not None else None))
    scope.var(op.output("Out")[0]).set(arr)


@register_host_op("array_to_lod_tensor",
                  inputs=[In("X"), In("RankTable", no_grad=True)],
                  outputs=[Out("Out")],
                  grad=_adjoint_maker("lod_tensor_to_array"))
def _array_to_lod_tensor(executor, op, scope):
    """The inverse of ``lod_tensor_to_array``: the sequences back in
    their original order with their LoD (``array_to_lod_tensor_op.cc``),
    gathered in one ``index_select`` from the entries concatenated."""
    arr = _holder(scope, op.input("X")[0])
    table = _holder(scope, op.input("RankTable")[0])
    steps = [t.array for t in arr]
    step_lods = [t.lod() for t in arr]
    has_sub = any(step_lods)
    base = [0]
    for s in steps:
        base.append(base[-1] + int(s.shape[0]))
    length = dict(table.items)
    rank = {idx: r for r, (idx, _) in enumerate(table.items)}
    rows, offs, sub_offs = [], [0], [0]
    for orig in range(len(table.items)):
        r = rank[orig]
        for t in range(length[orig]):
            # rank r lies in step t's active prefix: ranks are sorted by
            # length, so length > t holds for every rank up to r
            if has_sub and step_lods[t]:
                o = step_lods[t][0]
                r0, r1 = o[r], o[r + 1]
            else:
                r0, r1 = r, r + 1
            rows.extend(range(base[t] + r0, base[t] + r1))
            sub_offs.append(sub_offs[-1] + r1 - r0)
        offs.append(offs[-1] + length[orig])
    if steps:
        cat = torch.cat(steps, 0) if len(steps) > 1 else steps[0]
        full = cat.index_select(0, host_index(rows, cat.device))
    else:
        full = torch.zeros((0, 0), dtype=torch.float32,
                           device=executor.device)
    scope.var(op.output("Out")[0]).set(
        LoDTensor(full, [offs, sub_offs] if has_sub else [offs]))


def _first_sequences(lod, k):
    """The sub-LoD of the first ``k`` level-0 sequences, and the row count
    they hold (``GetSubLoDAndAbsoluteOffset(lod, 0, k, 0)``)."""
    sub, end = [], k
    for level in lod:
        sub.append(list(level[:end + 1]))
        end = level[end]
    return sub, end


@register_host_op("shrink_rnn_memory",
                  inputs=[In("X"), In("RankTable", no_grad=True),
                          In("I", no_grad=True)],
                  outputs=[Out("Out")])
def _shrink_rnn_memory(executor, op, scope):
    """The first k sequences of X, k the sequences still active at step
    I (``shrink_rnn_memory_op.cc``): the first k rows of a tensor with no
    LoD, the first k sequences and their sub-LoD of one with a LoD."""
    xv = _holder(scope, op.input("X")[0])
    table = _holder(scope, op.input("RankTable")[0])
    step = executor._read_var(scope, op.input("I")[0])
    k = table.active_at(int(step.reshape(-1)[0].item()))
    lod = xv.lod()
    if lod:
        sub, rows = _first_sequences(lod, k)
        out = LoDTensor(xv.array[:rows], sub)
    else:
        out = LoDTensor(xv.array[:k])
    scope.var(op.output("Out")[0]).set(out)


@register_host_op("shrink_rnn_memory_grad",
                  inputs=[In("X", no_grad=True),
                          In("Out@GRAD", no_grad=True)],
                  outputs=[Out("X@GRAD")])
def _shrink_rnn_memory_grad(executor, op, scope):
    """The shrunk grad, zero-padded back to X's rows: the rows (or whole
    sequences) the shrink dropped get a zero grad."""
    xv = _holder(scope, op.input("X")[0])
    og = executor._read_var(scope, op.input("Out@GRAD")[0])
    g = torch.zeros_like(xv.array)
    g[:og.shape[0]] = og.reshape((og.shape[0],) + tuple(g.shape[1:]))
    scope.var(op.output("X@GRAD")[0]).set(LoDTensor(g, xv.lod()))


def _rank_order_rows(x, lod, table):
    """The rows of X's sequences in rank order, and the new offsets."""
    offsets = lod[0] if lod else list(range(int(x.shape[0]) + 1))
    rows, new_offs = [], [0]
    for idx, _ in table.items:
        rows.extend(range(offsets[idx], offsets[idx + 1]))
        new_offs.append(new_offs[-1] + offsets[idx + 1] - offsets[idx])
    return rows, new_offs


@register_host_op("reorder_lod_tensor_by_rank",
                  inputs=[In("X"), In("RankTable", no_grad=True)],
                  outputs=[Out("Out")])
def _reorder_lod_tensor_by_rank(executor, op, scope):
    """X's sequences (rows, without a LoD) in rank-table order
    (``reorder_lod_tensor_by_rank_op.cc``): row r of a ``DynamicRNN``'s
    ``static_input`` and ``memory(init=)`` belongs to the rank-r
    sequence."""
    xv = _holder(scope, op.input("X")[0])
    table = _holder(scope, op.input("RankTable")[0])
    x, lod = xv.array, xv.lod()
    rows, new_offs = _rank_order_rows(x, lod, table)
    scope.var(op.output("Out")[0]).set(LoDTensor(
        x.index_select(0, host_index(rows, x.device)),
        [new_offs] if lod else None))


@register_host_op("reorder_lod_tensor_by_rank_grad",
                  inputs=[In("X", no_grad=True),
                          In("RankTable", no_grad=True),
                          In("Out@GRAD", no_grad=True)],
                  outputs=[Out("X@GRAD")])
def _reorder_lod_tensor_by_rank_grad(executor, op, scope):
    """The out-grad's rows back in X's order: the forward is a
    permutation of rows, so its adjoint gathers by the inverse."""
    xv = _holder(scope, op.input("X")[0])
    table = _holder(scope, op.input("RankTable")[0])
    og = executor._read_var(scope, op.input("Out@GRAD")[0])
    rows, _ = _rank_order_rows(xv.array, xv.lod(), table)
    inverse = [0] * len(rows)
    for pos, r in enumerate(rows):
        inverse[r] = pos
    scope.var(op.output("X@GRAD")[0]).set(LoDTensor(
        og.index_select(0, host_index(inverse, og.device)), xv.lod()))


@register_host_op("rank_table_boot_memory",
                  inputs=[In("RankTable", no_grad=True)],
                  outputs=[Out("Out")],
                  attrs={"shape": [], "value": 0.0, "dtype": 5})
def _rank_table_boot_memory(executor, op, scope):
    """A ``DynamicRNN.memory()``'s boot: [sequences, *shape] filled with
    ``value``."""
    table = _holder(scope, op.input("RankTable")[0])
    shape = [len(table.items)] + [int(s) for s in op.attrs.get("shape", [])]
    executor._write_var(scope, op.output("Out")[0], torch.full(
        shape, float(op.attrs.get("value", 0.0)),
        dtype=_dt.to_torch_dtype(op.attrs.get("dtype", 5)),
        device=executor.device))
