"""Device places.

Counterpart of ``paddle_tpu/core/place.py``. A place names the
``torch.device`` an executor or predictor runs on. The card is the default:
``CUDAPlace(i)`` resolves to ``cuda:i``, and ``TPUPlace`` is kept as an
alias of ``CUDAPlace`` so scripts written for the JAX package run
unchanged. ``CPUPlace()`` asks for the CPU. Asking for the card on a host
without one raises; nothing carries on on the CPU in its stead.
"""
from __future__ import annotations

import torch


class Place:
    """Base place. Equality is (kind, device_id)."""

    kind = "undefined"

    def __init__(self, device_id: int = 0):
        self._device_id = int(device_id)

    def device(self) -> torch.device:
        raise NotImplementedError

    def __eq__(self, other):
        return (isinstance(other, Place) and self.kind == other.kind
                and self._device_id == other._device_id)

    def __hash__(self):
        return hash((self.kind, self._device_id))

    def __repr__(self):
        return "%s(%d)" % (type(self).__name__, self._device_id)


class CPUPlace(Place):
    kind = "cpu"

    def __init__(self):
        super().__init__(0)

    def device(self) -> torch.device:
        return torch.device("cpu")


class CUDAPinnedPlace(CPUPlace):
    """Page-locked host memory; the tensors it names live on the CPU."""

    kind = "cpu_pinned"


class CUDAPlace(Place):
    """The accelerator place: ``cuda:<device_id>``."""

    kind = "cuda"

    def device(self) -> torch.device:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "%r: this host has no CUDA device. The port runs on the "
                "card unless asked for the CPU: pass CPUPlace() (or "
                "AnalysisConfig.disable_gpu()) to run on the CPU." % self)
        count = torch.cuda.device_count()
        if self._device_id >= count:
            raise RuntimeError("%r: only %d CUDA device(s) visible"
                               % (self, count))
        return torch.device("cuda", self._device_id)


# Scripts written for the JAX package name the accelerator TPUPlace.
TPUPlace = CUDAPlace

