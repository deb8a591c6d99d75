"""Row-sharded embedding over a mesh axis.

Counterpart of ``paddle_tpu/parallel/sharded_embedding.py``: the table
lives row-sharded over the replicas of an ``mp`` axis, one contiguous
block a replica (the last padded, so that every block has one shape). Each
replica resolves the ids that land in its rows and contributes zeros
elsewhere; one psum over the axis assembles the lookup. The JAX function
runs inside ``shard_map`` on one shard; the port's takes every replica's
block of one subgroup at once (``group``: the subgroup's
``ReplicaGroup``, in axis order), as the engine's replica walk holds
them.

The pullback of that psum for a cotangent the replicas share (every
``mp`` replica sees the same batch) is the identity: each block takes its
own hit rows of this replica's cotangent (``sharded_lookup_grad``), not
the sum of the replicas' (the psum-transpose pitfall; the JAX package's
custom VJP, ``paddle_tpu/ops/hybrid_parallel_ops.py:61-103``).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch


def shard_rows(vocab_size: int, n_shards: int):
    """Row ranges a shard: contiguous blocks, the last padded."""
    per = -(-vocab_size // n_shards)
    return [(s * per, min((s + 1) * per, vocab_size))
            for s in range(n_shards)]


def _local_hits(local_table, ids, index: int):
    rows_per = local_table.shape[0]
    local_ids = ids.to(torch.int64) - index * rows_per
    hit = (local_ids >= 0) & (local_ids < rows_per)
    return hit, local_ids.clamp(0, rows_per - 1)


def sharded_embedding_lookup(local_tables, ids_list, group
                             ) -> List[torch.Tensor]:
    """The lookup of every replica of one subgroup: ``local_tables[i]`` is
    replica i's ``[rows_per, D]`` block (rows ``i * rows_per ...``),
    ``ids_list[i]`` its global ids. Returns each replica's embeddings, the
    psum over the subgroup (``group.psum``, rank order) of the local
    hits."""
    contribs = []
    for i, (w, ids) in enumerate(zip(local_tables, ids_list)):
        hit, safe = _local_hits(w, ids, i)
        local = w[safe]
        contribs.append(torch.where(hit[..., None], local,
                                    torch.zeros((), dtype=w.dtype,
                                                device=w.device)))
    return group.psum(contribs)


def sharded_lookup_grad(local_table, ids, ct, index: int) -> torch.Tensor:
    """The grad of block ``index`` for this replica's cotangent ``ct``
    (shaped as the lookup's output): its hit rows of ``ct`` added into a
    zero block, in a deterministic order."""
    rows_per, d = local_table.shape
    hit, safe = _local_hits(local_table, ids.reshape(-1), index)
    ct2 = torch.where(hit[:, None], ct.reshape(-1, d).to(local_table.dtype),
                      torch.zeros((), dtype=local_table.dtype,
                                  device=local_table.device))
    gw = torch.zeros(rows_per, d, dtype=local_table.dtype,
                     device=local_table.device)
    return gw.index_put_((safe,), ct2, accumulate=True)


def build_sharded_table(weight: np.ndarray, n_shards: int):
    """A dense ``[V, D]`` table split into n row blocks, the last padded
    with zeros."""
    v, d = weight.shape
    per = -(-v // n_shards)
    padded = np.zeros((per * n_shards, d), dtype=weight.dtype)
    padded[:v] = weight
    return padded.reshape(n_shards, per, d)
