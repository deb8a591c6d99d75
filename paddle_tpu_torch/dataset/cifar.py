"""CIFAR reader creators (reference python/paddle/dataset/cifar.py).

Sample contract: (image float32[3072] in [0, 1] laid out CHW, label
int). Real pickled batches under DATA_HOME are parsed; otherwise a
deterministic synthetic stand-in (each class tints one channel band) is
served.
"""
from __future__ import annotations

import os
import pickle
import tarfile

import numpy as np

from .common import DATA_HOME

__all__ = ["train10", "test10", "train100", "test100"]


def _tar_reader(tar_path, sub_name):
    def reader():
        with tarfile.open(tar_path, mode="r") as f:
            names = [n for n in f.getnames() if sub_name in n]
            for name in sorted(names):
                batch = pickle.load(f.extractfile(name), encoding="latin1")
                data = batch["data"]
                labels = batch.get("labels") or batch.get("fine_labels")
                for s, l in zip(data, labels):
                    yield s.astype("float32") / 255.0, int(l)

    return reader


def _synthetic_reader(n, num_classes, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            label = int(rng.randint(0, num_classes))
            img = rng.rand(3, 32, 32).astype("float32") * 0.2
            band = label % 32
            img[label % 3, band // 2:band // 2 + 4, :] += 0.8
            yield img.reshape(3072), label

    return reader


def _pick(archive, sub_name, n, num_classes, seed, cycle=False):
    from .common import cycled

    path = os.path.join(DATA_HOME, "cifar", archive)
    reader = (_tar_reader(path, sub_name) if os.path.exists(path)
              else _synthetic_reader(n, num_classes, seed))
    return cycled(reader) if cycle else reader


def train10(cycle=False):
    return _pick("cifar-10-python.tar.gz", "data_batch", 8192, 10, 10,
                 cycle)


def test10(cycle=False):
    return _pick("cifar-10-python.tar.gz", "test_batch", 1024, 10, 11,
                 cycle)


def train100():
    return _pick("cifar-100-python.tar.gz", "train", 8192, 100, 12)


def test100():
    return _pick("cifar-100-python.tar.gz", "test", 1024, 100, 13)
