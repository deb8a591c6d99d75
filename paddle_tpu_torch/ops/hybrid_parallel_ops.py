"""Hybrid-parallelism ops: the program surface of tensor (sharded
embedding), sequence (ring attention) and expert (MoE) parallelism.

Counterpart of ``paddle_tpu/ops/hybrid_parallel_ops.py:27-163``, with its
slots and attrs. The transpiler passes (``parallel/transpiler.py``) swap a
user's ops for these before the backward is built. Each op carries a
``shard_axis``: where the data-parallel engine runs the step with that
axis live (``collective_ops.mesh_axes_guard``), the op runs once a
subgroup of the axis through its form over the replicas
(``core.registry.set_group_form``); everywhere else (one replica, the
interpreter, inference) it computes the exact dense result, so one
program serves both runs.

The grads: ring attention and MoE shard their tokens over a data axis, so
each replica's cotangent is of its own outputs, and the auto-VJP of every
replica's forward as one graph (``core.registry.vjp_grad_group``) is the
grad. ``c_sharded_lookup``'s cotangent is the same on every ``mp``
replica (they see one batch): one graph would add those identical
cotangents into each block, an ``mp``-fold overcount. Its grad form takes
each block's own hit rows of the replica's own cotangent instead
(``parallel.sharded_embedding.sharded_lookup_grad``), the JAX package's
custom VJP (``:61-103``).
"""
from __future__ import annotations

import torch

from ..core.registry import (BOUND_OUTPUTS_ATTR, GRAD_SUFFIX, In, OpInfoMap,
                             Out, register_op, set_group_form,
                             vjp_grad_group)
from .collective_ops import group_for_axis


def _axis_group(attrs):
    return group_for_axis(attrs.get("shard_axis") or None)


def _register(type, inputs, outputs, attrs, group_fn, grad_group_fn=None):
    """Register ``type`` (its dense function: ``group_fn`` over one replica
    and no group) with its auto grad, and the forms over a subgroup of
    both; the grad's default form is the one-graph auto-VJP."""
    def single(ins, a):
        return group_fn([ins], a, None)[0]

    register_op(type, inputs=inputs, outputs=outputs, attrs=attrs)(single)
    set_group_form(type, _axis_group, group_fn)
    info = OpInfoMap.instance().get(type)
    if grad_group_fn is None:
        def grad_group_fn(ins_list, a, group):
            return vjp_grad_group(info, ins_list, a,
                                  lambda rebuilt, fa: group_fn(rebuilt, fa,
                                                               group))
    set_group_form(type + "_grad", _axis_group, grad_group_fn)


# -- c_sharded_lookup ------------------------------------------------------------

def _lookup_ids(ids, attrs):
    # lookup_table drops a trailing [.., 1] ids dim; lookup_table_v2 keeps
    # it (the transpiler records which)
    if attrs.get("squeeze_last", True) and ids.dim() >= 2 \
            and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    return ids


def _sharded_lookup(ins_list, attrs, group):
    """Under the mesh W is the replica's row block and the ids are global:
    each block contributes its hits, one psum over the subgroup assembles
    them. The dense form is ``lookup_table``'s."""
    from ..parallel.sharded_embedding import sharded_embedding_lookup

    pad = int(attrs.get("padding_idx", -1))
    ids_list = [_lookup_ids(ins["Ids"], attrs) for ins in ins_list]
    if group is None:
        outs = []
        for ins, ids in zip(ins_list, ids_list):
            w = ins["W"]
            outs.append(w[ids.to(torch.int64).clamp(0, w.shape[0] - 1)])
    else:
        outs = sharded_embedding_lookup([ins["W"] for ins in ins_list],
                                        ids_list, group)
    if pad >= 0:
        outs = [torch.where((ids == pad)[..., None],
                            torch.zeros((), dtype=o.dtype, device=o.device),
                            o) for o, ids in zip(outs, ids_list)]
    return [{"Out": o} for o in outs]


def _sharded_lookup_grad(ins_list, attrs, group):
    """Each block's grad: its hit rows of this replica's own cotangent."""
    from ..parallel.sharded_embedding import sharded_lookup_grad

    bound = set(attrs.get(BOUND_OUTPUTS_ATTR) or ())
    if bound and "W" + GRAD_SUFFIX not in bound:
        return [{} for _ in ins_list]
    pad = int(attrs.get("padding_idx", -1))
    results = []
    for i, ins in enumerate(ins_list):
        ids = _lookup_ids(ins["Ids"], attrs)
        ct = ins["Out" + GRAD_SUFFIX]
        if pad >= 0:
            ct = torch.where((ids == pad)[..., None],
                             torch.zeros((), dtype=ct.dtype,
                                         device=ct.device),
                             ct.reshape(ids.shape + ct.shape[-1:]))
        results.append({"W" + GRAD_SUFFIX: sharded_lookup_grad(
            ins["W"], ids, ct, group.axis_index(i))})
    return results


_register("c_sharded_lookup",
          inputs=[In("W"), In("Ids", no_grad=True)], outputs=[Out("Out")],
          attrs={"shard_axis": "mp", "padding_idx": -1, "vocab_size": 0,
                 "squeeze_last": True},
          group_fn=_sharded_lookup, grad_group_fn=_sharded_lookup_grad)


# -- c_ring_attention --------------------------------------------------------------

def _ring_attention(ins_list, attrs, group):
    """Sequence-parallel attention over ``[B, H, S_local, D]`` shards: the
    K/V blocks of the subgroup stream past each replica's Q block
    (``parallel/ring_attention.py``); ``Lengths`` [B] holds the global key
    lengths. The dense form is exact full-sequence attention."""
    from ..parallel.ring_attention import (reference_attention,
                                           ring_attention)

    causal = bool(attrs.get("causal"))
    scale = attrs.get("scale", 0.0) or None
    if group is None:
        return [{"Out": reference_attention(
            ins["Q"], ins["K"], ins["V"], causal=causal, scale=scale,
            lengths=ins.get("Lengths"))} for ins in ins_list]
    lens = [ins.get("Lengths") for ins in ins_list]
    outs = ring_attention([ins["Q"] for ins in ins_list],
                          [ins["K"] for ins in ins_list],
                          [ins["V"] for ins in ins_list], causal=causal,
                          scale=scale,
                          lengths=None if lens[0] is None else lens,
                          group=group)
    return [{"Out": o} for o in outs]


_register("c_ring_attention",
          inputs=[In("Q"), In("K"), In("V"),
                  In("Lengths", dispensable=True, no_grad=True)],
          outputs=[Out("Out")],
          attrs={"shard_axis": "sp", "causal": False, "scale": 0.0},
          group_fn=_ring_attention)


# -- moe ---------------------------------------------------------------------------

def _moe(ins_list, attrs, group):
    """Switch-routed MoE FFN over ``[T, D]`` tokens (``layers.switch_moe``):
    under the mesh the experts are the replicas' shards and two
    all-to-alls route the slots (``parallel/moe.py``); the dense form runs
    the same routing in ``num_groups`` chunks, so both drop the same
    tokens."""
    from ..parallel.moe import expert_parallel_moe, moe_reference

    cf = float(attrs.get("capacity_factor", 1.0))
    if group is None:
        groups = int(attrs.get("num_groups", 1) or 1)
        return [{"Out": moe_reference(ins["X"], ins["GateW"], ins["WIn"],
                                      ins["WOut"], cf, groups)}
                for ins in ins_list]
    outs = expert_parallel_moe([ins["X"] for ins in ins_list],
                               [ins["GateW"] for ins in ins_list],
                               [ins["WIn"] for ins in ins_list],
                               [ins["WOut"] for ins in ins_list], group, cf)
    return [{"Out": o} for o in outs]


_register("moe",
          inputs=[In("X"), In("GateW"), In("WIn"), In("WOut")],
          outputs=[Out("Out")],
          attrs={"shard_axis": "", "num_groups": 1, "capacity_factor": 1.0},
          group_fn=_moe)
