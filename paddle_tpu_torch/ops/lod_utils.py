"""Helpers for ops that read host-side LoD, the port's own copy of
``paddle_tpu/ops/lod_utils.py``.

The interpreter passes each LoD input's table as ``attrs['_lod_<slot>']``
(nested tuples, one per name of the slot); these helpers parse it. An
index an op builds from a LoD (``seg_ids``, ``host_index``) is made on the
host once and copied to the op's device once: it is kept, keyed by its
host contents and the device, so the ops of one step (and of the next step
over the same LoD) share one copy.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..core.registry import LOD_ATTR_PREFIX

_INDEX_CAP = 256
_indices: "OrderedDict" = OrderedDict()


def lod_offsets(attrs, slot, level=-1):
    """The offset table [0, ...] of ``slot``'s first name at ``level`` (the
    last by default), or None where it carries no LoD."""
    lods = attrs.get(LOD_ATTR_PREFIX + slot)
    if not lods or not lods[0]:
        return None
    return list(lods[0][level])


def seq_lens(offsets) -> np.ndarray:
    return np.diff(np.asarray(offsets, dtype=np.int64))


def host_index(values, device) -> torch.Tensor:
    """``values`` (ints) as an int64 tensor on ``device``, copied there
    once for each distinct contents."""
    arr = np.ascontiguousarray(values, dtype=np.int64)
    key = (arr.shape, arr.tobytes(), str(device))
    t = _indices.get(key)
    if t is None:
        t = torch.from_numpy(arr).to(device)
        _indices[key] = t
        while len(_indices) > _INDEX_CAP:
            _indices.popitem(last=False)
    else:
        _indices.move_to_end(key)
    return t


def seg_ids(offsets, device) -> torch.Tensor:
    """Row -> sequence index, on ``device``."""
    return host_index(np.repeat(np.arange(len(offsets) - 1),
                                seq_lens(offsets)), device)


def batch_ids_for(attrs, slot, n_rows, device) -> torch.Tensor:
    """Each row's sequence from the slot's LoD (zeros without one)."""
    offsets = lod_offsets(attrs, slot)
    if offsets is None:
        return host_index(np.zeros(n_rows, dtype=np.int64), device)
    return seg_ids(offsets, device)
