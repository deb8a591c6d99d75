"""Runtime tensor type.

Counterpart of ``LoDTensor`` in ``paddle_tpu/core/tensor.py``: a thin
host-side holder of a ``torch.Tensor`` plus the LoD (nested sequence
offsets) as host metadata, with the JAX class's LoD helpers (``set_lod``,
``recursive_sequence_lengths``, ...); ``SelectedRows`` (:134), a sparse
row set (host row ids, a value tensor, a height: the embedding's
``is_sparse`` grad); and ``LoDTensorArray``, the list the tensor arrays
(``create_array`` / ``array_write`` / ``array_read``) hold.

``stage_feed`` is the one rule by which every route (the interpreter, the
whole-program route and ``AsyncDeviceFeeder``) turns a feed value into a
tensor. ``to_host_array`` / ``from_host_array`` are the one rule by which
saved files hold tensors: numpy cannot name bfloat16, so a bfloat16 tensor
goes to the host as its raw 16-bit words under numpy's ``|V2``, the layout
a JAX-saved bfloat16 array has in an ``.npz``, and comes back as
``torch.bfloat16``.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from . import dtypes

LoD = List[List[int]]


def _check_lod(lod: LoD, first_dim: int) -> None:
    for level in lod:
        if len(level) < 1 or level[0] != 0:
            raise ValueError("each LoD level must start with 0: %r" % (lod,))
        if any(b > a for a, b in zip(level[1:], level[:-1])):
            raise ValueError("LoD offsets must be non-decreasing: %r"
                             % (lod,))
    if lod and lod[-1][-1] != first_dim:
        raise ValueError("last LoD level must end at dim0=%d, got %r"
                         % (first_dim, lod))


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

    def set(self, value, place=None):
        """Hold ``value`` (a tensor as given, anything else as a host
        tensor, staged as a feed is); ``place`` is accepted and unused, as
        in the JAX package: an executor moves its feeds to its device."""
        self._array = stage_feed(value)
        return self

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

    def set_lod(self, lod: LoD):
        if self._array is not None:
            _check_lod(lod, int(self._array.shape[0]))
        self._lod = [list(level) for level in lod]
        return self

    def recursive_sequence_lengths(self) -> List[List[int]]:
        return [[b - a for a, b in zip(level[:-1], level[1:])]
                for level in self._lod]

    def set_recursive_sequence_lengths(self, lengths: List[List[int]]):
        lod = []
        for level in lengths:
            offsets = [0]
            for n in level:
                offsets.append(offsets[-1] + int(n))
            lod.append(offsets)
        self._lod = lod
        return self

    def has_valid_recursive_sequence_lengths(self) -> bool:
        try:
            _check_lod(self._lod, int(self._array.shape[0]))
            return True
        except (ValueError, AttributeError):
            return False

    def __repr__(self):
        return "LoDTensor(shape=%s, dtype=%s, lod=%s)" % (
            self.shape(), self.dtype(), self._lod)


class SelectedRows:
    """A sparse row set: ``value[i]`` is the update for row ``rows[i]`` of
    a dense tensor of ``height`` rows. The row ids are host metadata (a
    list), as in the JAX package; ``rows_on(device)`` keeps one copy of
    them on a device for the ops that scatter them."""

    __slots__ = ("_rows", "_value", "_height", "_rows_t")

    def __init__(self, rows=None, height: int = 0, value=None):
        self._rows_t = None
        if isinstance(rows, torch.Tensor):  # ids already on a device
            self._rows_t = rows.reshape(-1).to(torch.int64)
            rows = self._rows_t.tolist()
        self._rows = [int(r) for r in rows] if rows is not None else []
        self._height = int(height)
        self._value = value if value is not None else LoDTensor()

    def rows(self) -> List[int]:
        return self._rows

    def set_rows(self, rows):
        self._rows = [int(r) for r in rows]
        self._rows_t = None

    def height(self) -> int:
        return self._height

    def set_height(self, h):
        self._height = int(h)

    def get_tensor(self) -> LoDTensor:
        return self._value

    def rows_on(self, device) -> torch.Tensor:
        """The row ids as an int64 tensor on ``device``."""
        t = self._rows_t
        if t is None or t.device != torch.device(device):
            t = torch.tensor(self._rows, dtype=torch.int64).to(device)
            self._rows_t = t
        return t

    def to_dense(self) -> torch.Tensor:
        """The dense [height, ...] tensor, duplicate rows summed
        (``index_add_``: on the card in no fixed order)."""
        val = self._value.array
        out = torch.zeros((self._height,) + tuple(val.shape[1:]),
                          dtype=val.dtype, device=val.device)
        return out.index_add_(0, self.rows_on(val.device), val)

    def __repr__(self):
        return "SelectedRows(height=%d, rows=%s, value=%r)" % (
            self._height, self._rows[:8], self._value)


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


def to_host_array(t) -> np.ndarray:
    """A tensor (or array) as a host numpy array; bfloat16 as ``|V2``."""
    if isinstance(t, LoDTensor):
        t = t.array
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def from_host_array(arr, device=None) -> torch.Tensor:
    """A host array as a tensor on ``device`` (the host when None): a
    ``|V2`` or ``bfloat16`` array is read as bfloat16 bits, everything
    else keeps its numpy dtype."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2 or \
            arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                             .copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t if device is None else t.to(device)
