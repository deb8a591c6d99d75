"""UCI housing reader (reference python/paddle/dataset/uci_housing.py).

Offline deterministic synthetic regression with the reference's sample
contract: (features float32[13], target float32[1])."""
from __future__ import annotations

import numpy as np

__all__ = ["train", "test"]

_W = None


def _weights():
    global _W
    if _W is None:
        _W = np.random.RandomState(42).randn(13, 1).astype("float32")
    return _W


def _reader(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        w = _weights()
        for _ in range(n):
            x = rng.rand(13).astype("float32")
            y = float((x @ w).ravel()[0] + 0.05 * rng.randn())
            yield x, np.array([y], dtype="float32")

    return reader


def train():
    return _reader(404, seed=0)


def test():
    return _reader(102, seed=1)
