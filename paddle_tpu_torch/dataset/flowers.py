"""Oxford-102 flowers reader creators (reference
python/paddle/dataset/flowers.py).

Sample contract: (image float32[3*H*W] CHW normalized to [0,1] after
simple_transform, label int 0..101). Synthetic fallback: class-tinted
noise images, deterministic.
"""
from __future__ import annotations

import os

import numpy as np

from .common import DATA_HOME
from .image import simple_transform

__all__ = ["train", "test", "valid"]

_CLASSES = 102


def _data_dir():
    return os.path.join(DATA_HOME, "flowers")


def _synthetic_reader(n, seed, mapper=None):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            label = int(rng.randint(0, _CLASSES))
            img = (rng.rand(64, 64, 3) * 60).astype("uint8")
            img[:, :, label % 3] += np.uint8(120 + (label % 17) * 4)
            sample = simple_transform(img, 32, 32, is_train=False)
            yield sample, label

    return reader


def _file_reader(list_name, mapper):
    import tarfile

    import scipy.io  # noqa: F401  (labels are a .mat in the real set)

    raise NotImplementedError(
        "real flowers archives present but the offline parser only "
        "supports the synthetic path in this build; remove %s to use "
        "synthetic data" % _data_dir())


def train(mapper=None, buffered_size=1024, use_xmap=False, cycle=False):
    from .common import cycled

    if os.path.exists(os.path.join(_data_dir(), "102flowers.tgz")):
        r = _file_reader("trnid", mapper)
    else:
        r = _synthetic_reader(2048, seed=50)
    return cycled(r) if cycle else r


def test(mapper=None, buffered_size=1024, use_xmap=False, cycle=False):
    from .common import cycled

    if os.path.exists(os.path.join(_data_dir(), "102flowers.tgz")):
        r = _file_reader("tstid", mapper)
    else:
        r = _synthetic_reader(256, seed=51)
    return cycled(r) if cycle else r


def valid(mapper=None, buffered_size=1024, use_xmap=False):
    if os.path.exists(os.path.join(_data_dir(), "102flowers.tgz")):
        return _file_reader("valid", mapper)
    return _synthetic_reader(256, seed=52)
