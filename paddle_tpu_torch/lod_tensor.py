"""``create_lod_tensor`` and ``create_random_int_lodtensor`` (:27, :55 of
``paddle_tpu/lod_tensor.py``): a LoDTensor from data and per-level
sequence lengths, which become offsets. The data stays on the host, as in
the JAX package; an executor moves a feed to its device."""
from __future__ import annotations

import numpy as np

from .core.tensor import LoDTensor

__all__ = ["create_lod_tensor", "create_random_int_lodtensor"]


def _lengths_to_offsets(recursive_seq_lens):
    return [np.concatenate([[0], np.cumsum(level, dtype=np.int64)]).tolist()
            for level in recursive_seq_lens]


def create_lod_tensor(data, recursive_seq_lens, place=None):
    """A LoDTensor from a numpy array, a list of sequences (rows of one
    id each) or a LoDTensor, with the given lengths."""
    if isinstance(data, LoDTensor):
        return create_lod_tensor(data.numpy(), recursive_seq_lens, place)
    if isinstance(data, list):
        lens = [len(np.asarray(d).reshape(-1)) for d in data]
        if recursive_seq_lens and list(recursive_seq_lens[-1]) != lens:
            raise ValueError(
                "recursive_seq_lens %s does not match data lengths %s"
                % (recursive_seq_lens, lens))
        data = np.concatenate([np.asarray(d).reshape(-1, 1) for d in data],
                              axis=0)
    arr = np.asarray(data)
    lods = _lengths_to_offsets(recursive_seq_lens)
    if lods and lods[-1][-1] != arr.shape[0]:
        raise ValueError("last-level offsets end at %d but data has %d rows"
                         % (lods[-1][-1], arr.shape[0]))
    return LoDTensor().set(arr).set_lod(lods)


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place=None,
                                low=0, high=1):
    """An int64 LoDTensor of ids drawn from numpy's global state, uniform
    in [low, high], with the given last-level lengths."""
    total = int(sum(recursive_seq_lens[-1]))
    data = np.random.randint(low, high + 1,
                             size=[total] + list(base_shape)).astype("int64")
    return create_lod_tensor(data, recursive_seq_lens, place)
