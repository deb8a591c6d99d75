"""Expert parallelism: switch-routed MoE over a mesh axis.

Counterpart of ``paddle_tpu/parallel/moe.py`` (GShard / Switch style):

- top-1 gating with a fixed capacity an expert (``_top1_dispatch``); the
  tokens past an expert's capacity are dropped, in token order, exactly
  as the JAX code drops them;
- ``expert_parallel_moe``: every replica of an ``ep`` subgroup dispatches
  its own tokens into ``[E_total, C, D]`` slots; one all-to-all moves each
  expert's slots to the replica that holds the expert; the experts run
  their FFN (relu) on the slots of every sender; a second all-to-all
  sends the results back; the combine weights them by the gate. The JAX
  function runs inside ``shard_map`` on one shard; the port's takes the
  tokens and local experts of every replica of one subgroup at once
  (``group``: its ``ReplicaGroup``);
- ``moe_reference``: the single-device oracle, the tokens in ``axis_size``
  chunks so that the dense route and the mesh route drop the same tokens.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F


def _capacity(t_local: int, capacity_factor: float, e_total: int) -> int:
    return max(1, int(-(-t_local * capacity_factor // e_total)))


def _top1_dispatch(x, gate_w, num_experts: int, capacity: int):
    """(dispatch [E, C, T], combine [T, E, C], gate [T])."""
    probs = torch.softmax(x @ gate_w, dim=-1)
    expert = torch.argmax(probs, dim=-1)
    gate = torch.gather(probs, 1, expert[:, None])[:, 0]
    onehot = F.one_hot(expert, num_experts).to(torch.int32)
    # each token's place in its expert's queue
    pos = torch.cumsum(onehot, dim=0) * onehot - 1
    pos_in_expert = pos.amax(dim=1)
    keep = pos_in_expert < capacity
    disp = (F.one_hot(expert, num_experts).to(x.dtype)[:, :, None]
            * F.one_hot(pos_in_expert.clamp(0, capacity - 1),
                        capacity).to(x.dtype)[:, None, :])
    disp = disp * keep[:, None, None].to(x.dtype)
    return disp.permute(1, 2, 0), disp, gate


def _ffn(slots, w_in, w_out):
    h = torch.relu(torch.einsum("secd,edh->sech", slots, w_in))
    return torch.einsum("sech,ehd->secd", h, w_out)


def expert_parallel_moe(xs, gate_ws, w_ins, w_outs, group,
                        capacity_factor: float = 1.0) -> List[torch.Tensor]:
    """The switch-MoE layer of every replica of one ``ep`` subgroup:
    ``xs[i]`` replica i's ``[T_local, D]`` tokens, ``gate_ws[i]`` the
    replicated ``[D, E_total]`` gate, ``w_ins[i]`` / ``w_outs[i]`` its
    local experts ``[E_local, D, H]`` / ``[E_local, H, D]`` (experts
    ``i * E_local ...``). Capacity a sending replica and expert:
    ``ceil(T_local * capacity_factor / E_total)``."""
    n = len(xs)
    T, D = xs[0].shape
    e_local = w_ins[0].shape[0]
    e_total = e_local * n
    capacity = _capacity(T, capacity_factor, e_total)
    routed = [_top1_dispatch(x, g, e_total, capacity)
              for x, g in zip(xs, gate_ws)]
    slots = [torch.einsum("ect,td->ecd", r[0], x).reshape(
        n, e_local, capacity, D) for r, x in zip(routed, xs)]
    slots = group.all_to_all(slots)  # [n senders, E_local, C, D] each
    outs = [_ffn(s, wi, wo) for s, wi, wo in zip(slots, w_ins, w_outs)]
    outs = group.all_to_all(outs)
    ys = []
    for (_, disp_tec, gate), out in zip(routed, outs):
        y = torch.einsum("tec,ecd->td", disp_tec,
                         out.reshape(e_total, capacity, D))
        ys.append(y * gate[:, None])
    return ys


def moe_reference(x, gate_w, w_in_full, w_out_full,
                  capacity_factor: float = 1.0, axis_size: int = 1):
    """The single-device oracle: the full ``[T, D]`` tokens in
    ``axis_size`` chunks of ``T / axis_size``, each routed as one sending
    replica routes its own, over every expert ``[E_total, D, H]`` /
    ``[E_total, H, D]``."""
    T, D = x.shape
    e_total = w_in_full.shape[0]
    if T % axis_size:
        raise ValueError(
            "moe_reference: token count %d must divide by axis_size %d "
            "(the sharded run it mirrors requires equal shards)"
            % (T, axis_size))
    t_local = T // axis_size
    capacity = _capacity(t_local, capacity_factor, e_total)
    outs = []
    for s in range(axis_size):
        xs = x[s * t_local:(s + 1) * t_local]
        disp_ect, disp_tec, gate = _top1_dispatch(xs, gate_w, e_total,
                                                  capacity)
        slots = torch.einsum("ect,td->ecd", disp_ect, xs)
        out = _ffn(slots[None], w_in_full, w_out_full)[0]
        y = torch.einsum("tec,ecd->td", disp_tec, out)
        outs.append(y * gate[:, None])
    return torch.cat(outs, dim=0)
