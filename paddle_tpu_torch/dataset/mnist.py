"""MNIST reader creators (reference python/paddle/dataset/mnist.py).

The reference downloads the IDX files; this environment has no network
egress, so by default the readers serve a DETERMINISTIC SYNTHETIC
stand-in with the same sample contract — (image float32[784] scaled to
[-1, 1], label int64 in [0, 10)) — which is what the book tests
consume. If real IDX files exist under ``data_dir`` they are parsed
instead.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

__all__ = ["train", "test"]


def _idx_reader(image_path, label_path, buffered_size=100):
    def reader():
        opener = gzip.open if image_path.endswith(".gz") else open
        with opener(image_path, "rb") as fi, \
                opener(label_path, "rb") as fl:
            magic, n, rows, cols = struct.unpack(">IIII", fi.read(16))
            struct.unpack(">II", fl.read(8))
            for _ in range(n):
                img = np.frombuffer(fi.read(rows * cols), dtype=np.uint8)
                lbl = struct.unpack("B", fl.read(1))[0]
                img = img.astype("float32") / 255.0 * 2.0 - 1.0
                yield img, int(lbl)

    return reader


def _synthetic_reader(n, seed):
    """Separable synthetic digits (class k lights a distinct patch) —
    learnable by the book models, fully offline."""
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            label = int(rng.randint(0, 10))
            img = rng.rand(28, 28).astype("float32") * 0.1
            img[2 * label:2 * label + 3, 2 * label:2 * label + 3] += 0.9
            yield (img.reshape(784) * 2.0 - 1.0, label)

    return reader


def _data_dir():
    return os.environ.get("PADDLE_TPU_DATA_HOME",
                          os.path.expanduser("~/.cache/paddle_tpu/mnist"))


def train(data_dir=None):
    d = data_dir or _data_dir()
    imgs = os.path.join(d, "train-images-idx3-ubyte.gz")
    lbls = os.path.join(d, "train-labels-idx1-ubyte.gz")
    if os.path.exists(imgs) and os.path.exists(lbls):
        return _idx_reader(imgs, lbls)
    return _synthetic_reader(8192, seed=0)


def test(data_dir=None):
    d = data_dir or _data_dir()
    imgs = os.path.join(d, "t10k-images-idx3-ubyte.gz")
    lbls = os.path.join(d, "t10k-labels-idx1-ubyte.gz")
    if os.path.exists(imgs) and os.path.exists(lbls):
        return _idx_reader(imgs, lbls)
    return _synthetic_reader(1024, seed=1)
