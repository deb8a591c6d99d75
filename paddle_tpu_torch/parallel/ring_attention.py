"""Ring attention and Ulysses sequence parallelism.

Counterpart of ``paddle_tpu/parallel/ring_attention.py``. The sequence of
``[B, H, S, D]`` attention is split into ``n`` blocks over the replicas of
an ``sp`` axis. The JAX functions run inside ``shard_map`` on one local
shard; the port's take the shards of every replica of one ring at once
(lists in ring order, replica i holding sequence block i), as the engine's
replica walk holds them, and return one output a replica:

- ``ring_attention``: replica i streams every K/V block past its Q block
  with a float32 log-sum-exp accumulator (exact attention, not an
  approximation), in the JAX order: its own block first, then the block of
  replica i-1, i-2, ... (the block the ring rotation ``r -> r + 1``,
  ``ReplicaGroup.ppermute``, has brought after t steps). The causal mask
  is in global positions; a block wholly in the masked future
  (``src > i``) is skipped, decided from the replica indices, so the
  work of replica i is i + 1 blocks. ``lengths``
  ([B] global key lengths) masks padded keys inside each block with no
  read on the host, so a step stays capturable; a block that lies wholly
  past an example's length is computed and adds exact zeros (or, met
  before any visible block, is cleared exactly by the next one's
  rescale), where the JAX function skips it with ``lax.cond`` on
  ``src * S < max(lengths)``. Zero-length examples output zeros.
- ``ulysses_attention``: the all-to-all form (DeepSpeed-Ulysses): every
  replica gets ``H / n`` heads of the whole sequence, runs dense attention
  and sends the heads back. Needs ``H % n == 0``.
- ``sequence_parallel_attention``: full arrays in, the sequence split over
  ``n`` (a mesh's ``sp`` axis, or a count), one of the two modes.
- ``reference_attention``: dense single-device attention, the oracle.

The blocks are ``torch.matmul`` in float32 as the JAX package's are
``einsum`` outside any Pallas kernel (ROADMAP.md lists running them on
K1 with an LSE merge as a speed item). Results come back in q's dtype.
"""
from __future__ import annotations

from typing import List, Optional

import torch

NEG_INF = -1e30


def _scale(scale, d):
    return float(d) ** -0.5 if not scale else float(scale)


def _key_mask(lengths, k_off: int, s_k: int, device):
    """[B, 1, 1, S_k] True where key ``k_off + j`` is inside the
    example's length."""
    pos = torch.arange(k_off, k_off + s_k, device=device)
    lens = lengths.reshape(-1).to(device=device, dtype=torch.int64)
    return (pos[None, :] < lens[:, None])[:, None, None, :]


def _attend(o, m, l, qf, kb, vb, diag_causal, k_vis):
    """One block into the running (o, m, l) of the streaming softmax."""
    s = torch.matmul(qf, kb.to(torch.float32).transpose(-1, -2))
    if diag_causal:
        n = s.shape[-1]
        tri = torch.ones(n, n, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~tri, NEG_INF)
    if k_vis is not None:
        s = s.masked_fill(~k_vis, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha[..., None] + torch.matmul(p, vb.to(torch.float32))
    return o_new, m_new, l_new


def ring_blocks(n: int, i: int, causal: bool) -> List[int]:
    """The K/V blocks replica i of a ring of n attends, in order."""
    srcs = [(i - t) % n for t in range(n)]
    return [s for s in srcs if not (causal and s > i)]


def ring_rotations(ks, vs, group=None):
    """The K/V blocks every replica holds after 0, 1, ..., n - 1 ring
    rotations ``r -> r + 1`` over ``group`` (``ReplicaGroup.ppermute``;
    by default the group of the blocks' devices): entry t is ``(ks_t,
    vs_t)``, replica i holding block ``(i - t) mod n``."""
    if group is None:
        from ..ops.collective_ops import ReplicaGroup

        group = ReplicaGroup([k.device for k in ks])
    held = [(list(ks), list(vs))]
    for _ in range(len(ks) - 1):
        k_t, v_t = held[-1]
        held.append((group.ppermute(k_t), group.ppermute(v_t)))
    return held


def ring_attend(i: int, q, held, causal: bool = False,
                scale: Optional[float] = None, lengths=None) -> torch.Tensor:
    """Replica i's share of ``ring_attention``: its output from the K/V
    blocks it holds after each rotation (``held[t] = (k, v)``, sequence
    block ``(i - t) mod n``), in the order ``ring_blocks`` names.
    ``lengths``: [B] global key lengths or None."""
    n = len(held)
    B, H, S, D = q.shape
    dev = q.device
    qf = q.to(torch.float32) * _scale(scale, D)
    o = torch.zeros(B, H, S, D, dtype=torch.float32, device=dev)
    m = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(B, H, S, dtype=torch.float32, device=dev)
    for src in ring_blocks(n, i, causal):
        kb, vb = held[(i - src) % n]
        k_vis = (None if lengths is None
                 else _key_mask(lengths, src * kb.shape[2], kb.shape[2],
                                dev))
        o, m, l = _attend(o, m, l, qf, kb, vb, causal and src == i, k_vis)
    out = o / torch.clamp(l, min=1e-30)[..., None]
    if lengths is not None:
        alive = (lengths.reshape(-1).to(dev) > 0)[:, None, None, None]
        out = torch.where(alive, out, torch.zeros((), device=dev))
    return out.to(q.dtype)


def ring_attention(qs, ks, vs, causal: bool = False,
                   scale: Optional[float] = None, lengths=None,
                   group=None) -> List[torch.Tensor]:
    """Exact attention of every replica's ``[B, H, S_local, D]`` Q block
    over the K/V blocks of the ring (``qs[i]``, ``ks[i]``, ``vs[i]``:
    replica i's shards, sequence block i). ``lengths``: [B] global key
    lengths (one tensor, or one a replica). The K/V blocks move by the
    ring rotation (``ring_rotations``) over ``group``."""
    held = ring_rotations(ks, vs, group)
    outs = []
    for i, q in enumerate(qs):
        lens = lengths[i] if isinstance(lengths, (list, tuple)) else lengths
        outs.append(ring_attend(i, q, [(k[i], v[i]) for k, v in held],
                                causal, scale, lens))
    return outs


def _dense(q, k, v, causal, scale, lengths, out_dtype):
    D = q.shape[-1]
    s = torch.matmul(q.to(torch.float32),
                     k.to(torch.float32).transpose(-1, -2)) * _scale(scale,
                                                                     D)
    if causal:
        S = q.shape[2]
        tri = torch.ones(S, k.shape[2], dtype=torch.bool,
                         device=q.device).tril()
        s = s.masked_fill(~tri, NEG_INF)
    if lengths is not None:
        s = s.masked_fill(~_key_mask(lengths, 0, k.shape[2], q.device),
                          NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, v.to(torch.float32))
    if lengths is not None:
        alive = (lengths.reshape(-1).to(q.device) > 0)[:, None, None, None]
        out = torch.where(alive, out, torch.zeros((), device=q.device))
    return out.to(out_dtype)


def reference_attention(q, k, v, causal: bool = False,
                        scale: Optional[float] = None, lengths=None):
    """Dense single-device attention, the oracle of the tests."""
    return _dense(q, k, v, causal, scale, lengths, q.dtype)


def ulysses_attention(qs, ks, vs, causal: bool = False,
                      scale: Optional[float] = None,
                      lengths=None) -> List[torch.Tensor]:
    """All-to-all sequence parallelism over the replicas' ``[B, H,
    S_local, D]`` shards (``H % n == 0``): to ``[B, H / n, S, D]`` a
    replica (heads split, the sequence whole), dense attention, back."""
    n = len(qs)
    H = qs[0].shape[1]
    if H % n:
        raise ValueError("ulysses needs heads (%d) %% axis size (%d) == 0"
                         % (H, n))
    hg = H // n

    def to_heads(xs):
        return [torch.cat([x[:, r * hg:(r + 1) * hg].to(xs[r].device)
                           for x in xs], dim=2) for r in range(n)]

    qh, kh, vh = to_heads(qs), to_heads(ks), to_heads(vs)
    oh = []
    for r in range(n):
        lens = (lengths[r] if isinstance(lengths, (list, tuple))
                else lengths)
        oh.append(_dense(qh[r], kh[r], vh[r], causal, scale, lens,
                         qs[r].dtype))
    s_loc = qs[0].shape[2]
    return [torch.cat([o[:, :, i * s_loc:(i + 1) * s_loc].to(qs[i].device)
                       for o in oh], dim=1) for i in range(n)]


def sequence_parallel_attention(q, k, v, mesh, sp_axis: str = "sp",
                                mode: str = "ring", causal: bool = False,
                                scale: Optional[float] = None,
                                lengths=None):
    """Full ``[B, H, S, D]`` arrays in; attention computed with the
    sequence split over ``mesh``'s ``sp_axis`` (or over ``mesh`` replicas
    when it is a count). ``mode``: ``"ring"`` or ``"ulysses"``."""
    n = int(mesh if isinstance(mesh, int) else mesh.shape[sp_axis])
    fn = {"ring": ring_attention, "ulysses": ulysses_attention}[mode]
    outs = fn(list(q.chunk(n, dim=2)), list(k.chunk(n, dim=2)),
              list(v.chunk(n, dim=2)), causal=causal, scale=scale,
              lengths=lengths)
    return torch.cat(outs, dim=2)
