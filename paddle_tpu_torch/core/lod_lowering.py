"""LoD -> padded lowering onto the whole-program route, the port's copy of
``paddle_tpu/core/lod_lowering.py`` (its tables ``RANK_SAFE`` and
``SWAPS``, ``plan_lowering``, ``build_lowered``, ``bucket_len`` and
``pad_lod_feed``).

A program with ragged (LoD) feeds and sequence ops would run op by op on
the interpreter. This pass keeps the LoD on the host: the executor pads
each ragged feed to ``[B, T_bucket, ...]`` plus a ``[B]`` length feed
``<feed>@SEQ_LEN`` (T the next power of two, so a run of batches sees few
shapes), and a lowered clone of the program swaps each sequence op for
its padded twin (``ops/sequence_ops.py`` ``*_padded``), which reads the
lengths as a mask on the device. The clone takes the whole-program route:
on the card one CUDA graph per (program, bucket, batch), whose length
vector is a staged feed, so batches of other lengths in one bucket replay
the same graph.

The ragged region between a LoD feed and the sequence op that collapses it
must be rank-safe (ops that treat the leading dims alike: lookups,
activations, elementwise ops over one length); any other op that reads
ragged data (``fc``'s ``mul``, ``lstm``, a SelectedRows host op) declines
the lowering, and the program takes the interpreter. A ``Decline`` names
the op and the reason; the executor counts it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .registry import GRAD_SUFFIX
from .tensor import stage_feed

# ops that treat leading dims uniformly: ragged [sum, ...] -> padded
# [B, T, ...] without a change of meaning (their grads likewise);
# elementwise ops and sum are safe where every ragged operand shares one
# length var (checked in the plan)
RANK_SAFE = {
    "lookup_table", "lookup_table_v2", "relu", "tanh", "sigmoid", "gelu",
    "scale", "cast", "dropout", "square", "abs", "softsign", "sqrt",
    "exp", "log", "elementwise_add", "elementwise_sub", "elementwise_mul",
    "sum",
}

# sequence op -> (padded twin, whether its output is dense [B, ...]).
# Ragged vars are tracked by their length var (a feed's is
# <feed>@SEQ_LEN; sequence_concat's twin emits a new one in the graph)
SWAPS = {
    "sequence_pool": ("sequence_pool_padded", True),
    "sequence_softmax": ("sequence_softmax_padded", False),
    "sequence_conv": ("sequence_conv_padded", False),
    "sequence_expand": ("sequence_expand_padded", False),
    "sequence_pad": ("sequence_pad_padded", True),
    "sequence_unpad": ("sequence_unpad_padded", False),
    "sequence_concat": ("sequence_concat_padded", False),
}


def _grad_base(name: str) -> Optional[str]:
    """emb.tmp_0@GRAD / emb.tmp_0@GRAD@RENAME... -> emb.tmp_0."""
    i = name.find(GRAD_SUFFIX)
    return name[:i] if i > 0 else None


class Decline:
    """Why a lowering was refused: the op's index and type and the reason.
    Falsy, so ``if not plan`` reads as a refusal."""

    __slots__ = ("op_index", "op_type", "reason")

    def __init__(self, op_index: int, op_type: str, reason: str):
        self.op_index = op_index
        self.op_type = op_type
        self.reason = reason

    def __bool__(self):
        return False

    def __repr__(self):
        return "Decline(op #%d %s: %s)" % (self.op_index, self.op_type,
                                           self.reason)


def _len_name(feed: str) -> str:
    return feed + "@SEQ_LEN"


def plan_lowering(program, lod_feeds):
    """(swaps, ragged, axis_bumps): op index -> (padded op type, [length
    var names]) for every sequence op and grad op over ragged data; every
    ragged var -> its length var; the elementwise ops whose dense operand's
    axis moves right by one in the padded form. A ``Decline`` where an op
    the plan cannot lower reads ragged data."""
    block = program.global_block()
    ragged: Dict[str, str] = {f: _len_name(f) for f in lod_feeds}
    swaps: Dict[int, Tuple[str, List[str]]] = {}
    axis_bumps: List[int] = []
    for i, op in enumerate(block.ops):
        r_ins = [n for n in op.input_arg_names if n and n in ragged]
        if op.type == "sequence_unpad" and not r_ins:
            # dense padded values and a length value: the twin is the
            # identity and the output is ragged by the Length input var
            swaps[i] = ("sequence_unpad_padded", [])
            for o in op.output("Out"):
                ragged[o] = op.input("Length")[0]
            continue
        if not r_ins:
            continue
        is_grad = op.type.endswith("_grad")
        base_type = op.type[:-5] if is_grad else op.type

        def decline(why, _i=i, _op=op):
            return Decline(_i, _op.type, why)

        if base_type in SWAPS:
            new_type, collapses = SWAPS[base_type]
            if base_type == "sequence_conv":
                if op.attrs.get("paddingTrainable"):
                    return decline("trainable conv padding")
                x = op.input("X")[0]
                if x not in ragged:
                    return decline("conv of non-ragged X")
                lens = [ragged[x]]
                out_len = lens[0]
            elif base_type == "sequence_expand":
                x, y = op.input("X")[0], op.input("Y")[0]
                if x in ragged or y not in ragged:
                    # a ragged X changes the batch by data
                    return decline("ragged-X expand")
                lens = [ragged[y]]
                out_len = lens[0]
            elif base_type == "sequence_pad":
                x = op.input("X")[0]
                if x not in ragged:
                    return decline("pad of non-ragged X")
                if int(op.attrs.get("padded_length", -1)) < 0:
                    # the twin would pad to the bucket, not the batch max
                    return decline("sequence_pad without explicit "
                                   "padded_length")
                lens = [ragged[x]]
                out_len = None
            elif base_type == "sequence_unpad":
                if op.input("X")[0] in ragged:
                    return decline("unpad of ragged X")
                lens = []
                out_len = op.input("Length")[0]
            elif base_type == "sequence_concat":
                xs = op.input("X")
                if not all(x in ragged for x in xs):
                    return decline("concat of mixed ragged/dense")
                lens = [ragged[x] for x in xs]
                out_len = "NEW"
            else:  # pool / softmax
                x = op.input("X")[0]
                if x not in ragged:
                    return decline("pool/softmax of non-ragged X")
                lens = [ragged[x]]
                out_len = None if collapses else lens[0]
            swaps[i] = (new_type + ("_grad" if is_grad else ""), lens)
            if is_grad:
                for o in op.output_arg_names:
                    b = _grad_base(o)
                    if o and b in ragged:
                        ragged[o] = ragged[b]
            elif out_len == "NEW":
                out0 = op.output("Out")[0]
                for o in op.output("Out"):
                    ragged[o] = out0 + "@SEQ_LEN"
            elif out_len is not None:
                for o in op.output("Out"):
                    if o:
                        ragged[o] = out_len
            continue
        if base_type in RANK_SAFE:
            if len({ragged[n] for n in r_ins}) > 1:
                return decline("mixed-length elementwise")
            if base_type.startswith("elementwise_"):
                x_in, y_in = op.input("X"), op.input("Y")
                if x_in and y_in and x_in[0] not in ragged \
                        and y_in[0] in ragged:
                    return decline("dense-X + ragged-Y elementwise")
                if int(op.attrs.get("axis", -1)) >= 0 and y_in \
                        and y_in[0] not in ragged:
                    # X gained a leading batch dim: a left-aligned dense Y
                    # broadcasts one axis further right
                    axis_bumps.append(i)
            origin = ragged[r_ins[0]]
            for o in op.output_arg_names:
                if not o:
                    continue
                if is_grad:
                    b = _grad_base(o)
                    if b in ragged:
                        ragged[o] = ragged[b]
                else:
                    ragged[o] = origin
            continue
        return decline("unsupported op consumes ragged data")
    return swaps, ragged, axis_bumps


def build_lowered(program, lod_feeds):
    """(lowered clone, the feeds to pad, every ragged var: a fetch of one
    would read padded values), or the plan's ``Decline``."""
    plan = plan_lowering(program, lod_feeds)
    if isinstance(plan, Decline):
        return plan
    swaps, ragged, axis_bumps = plan
    clone = program.clone()
    block = clone.global_block()
    for f in lod_feeds:
        block.create_var(name=_len_name(f), shape=None, dtype="int64")
    for i, (new_type, lens) in swaps.items():
        op = block.ops[i]
        op.type = new_type
        if lens:
            op.inputs["Length"] = list(lens)
        if new_type == "sequence_concat_padded":
            ln = op.output("Out")[0] + "@SEQ_LEN"
            op.outputs["OutLength"] = [ln]
            if not block.has_var_local(ln):
                block.create_var(name=ln, shape=None, dtype="int64")
        op.outputs.pop("MaxIndex", None)
    for i in axis_bumps:
        op = block.ops[i]
        op.attrs["axis"] = int(op.attrs.get("axis", -1)) + 1
    clone._next_op_id()  # a version of its own
    return clone, set(lod_feeds), set(ragged)


def bucket_len(n: int, minimum: int = 8) -> int:
    """The next power of two >= n (and >= minimum)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def pad_lod_feed(value) -> Tuple[torch.Tensor, torch.Tensor]:
    """A ragged LoDTensor ([sum, ...] rows, level-0 offsets) -> (padded
    [B, T_bucket, ...] where its rows lie, int64 lengths [B] on the
    host)."""
    arr = stage_feed(value.array)
    offsets = np.asarray(value.lod()[0], dtype=np.int64)
    lens = np.diff(offsets)
    b = len(lens)
    t = bucket_len(int(lens.max()) if b else 1)
    dest = np.concatenate([k * t + np.arange(lens[k]) for k in range(b)]
                          or [np.zeros(0, np.int64)])
    padded = arr.new_zeros((b * t,) + tuple(arr.shape[1:]))
    padded[torch.from_numpy(dest).to(arr.device)] = arr
    return (padded.reshape((b, t) + tuple(arr.shape[1:])),
            torch.from_numpy(lens))
