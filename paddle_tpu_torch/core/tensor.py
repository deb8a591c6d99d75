"""Runtime tensor type.

Counterpart of ``LoDTensor`` in ``paddle_tpu/core/tensor.py``: a thin
host-side holder of a ``torch.Tensor`` plus the LoD (nested sequence
offsets) as host metadata. The serving slice feeds dense tensors only;
LoD-consuming ops and ``SelectedRows`` come with later slices.
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
