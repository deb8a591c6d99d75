"""Runtime tensor type.

Counterpart of ``LoDTensor`` in ``paddle_tpu/core/tensor.py``: a thin
host-side holder of a ``torch.Tensor`` plus the LoD (nested sequence
offsets) as host metadata, and ``LoDTensorArray``, the list the tensor
arrays (``create_array`` / ``array_write`` / ``array_read``) hold.
LoD-consuming ops and ``SelectedRows`` come with later slices.

``stage_feed`` is the one rule by which every route (the interpreter, the
whole-program route and ``AsyncDeviceFeeder``) turns a feed value into a
tensor.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from . import dtypes

LoD = List[List[int]]


class LoDTensor:
    """A dense tensor plus optional host-side LoD metadata."""

    __slots__ = ("_array", "_lod")

    def __init__(self, array: Optional[torch.Tensor] = None,
                 lod: Optional[LoD] = None):
        self._array = array
        self._lod = [list(level) for level in lod] if lod else []

    @property
    def array(self) -> Optional[torch.Tensor]:
        return self._array

    def numpy(self) -> np.ndarray:
        return self._array.detach().cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        return arr if dtype is None else arr.astype(dtype)

    def shape(self):
        return tuple(self._array.shape) if self._array is not None else ()

    def dtype(self) -> str:
        return (dtypes.convert_dtype(self._array.dtype)
                if self._array is not None else "float32")

    def lod(self) -> LoD:
        return self._lod

    def __repr__(self):
        return "LoDTensor(shape=%s, dtype=%s, lod=%s)" % (
            self.shape(), self.dtype(), self._lod)


class LoDTensorArray(list):
    """A growable list of LoDTensors: the value of a tensor array."""


def stage_feed(value) -> torch.Tensor:
    """A feed value as a tensor where it lies: a tensor as given, anything
    else through ``np.asarray`` onto the host (without a copy where numpy
    allows). float64, and so a list of Python floats, becomes float32, as
    the JAX package stages feeds with x64 off; every other type stays as
    fed, int64 included (torch keeps it, where the JAX package makes it
    int32: the int64 hazard of ROADMAP.md's North star)."""
    if isinstance(value, torch.Tensor):
        return value.float() if value.dtype == torch.float64 else value
    arr = np.asarray(value)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr))
