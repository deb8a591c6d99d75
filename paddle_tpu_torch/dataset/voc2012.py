"""VOC2012 segmentation reader creators (reference
python/paddle/dataset/voc2012.py).

Sample contract: (image float32[3,H,W], label uint8[H,W] class mask).
Synthetic fallback: images with one colored rectangle whose class id
matches the mask region, deterministic.
"""
from __future__ import annotations

import os
import tarfile

import numpy as np

from .common import DATA_HOME
from .image import load_image_bytes, to_chw

__all__ = ["train", "test", "val"]

_CLASSES = 21


def _archive():
    p = os.path.join(DATA_HOME, "voc2012", "VOCtrainval_11-May-2012.tar")
    return p if os.path.exists(p) else None


def _synthetic_reader(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            cls = int(rng.randint(1, _CLASSES))
            img = (rng.rand(48, 48, 3) * 40).astype("uint8")
            mask = np.zeros((48, 48), "uint8")
            y, x = int(rng.randint(4, 24)), int(rng.randint(4, 24))
            img[y:y + 16, x:x + 16, cls % 3] += np.uint8(150)
            mask[y:y + 16, x:x + 16] = cls
            yield to_chw(img).astype("float32") / 255.0, mask

    return reader


def _tar_reader(split):
    def reader():
        with tarfile.open(_archive(), mode="r") as f:
            seg = "VOCdevkit/VOC2012/ImageSets/Segmentation/%s.txt" % split
            names = f.extractfile(seg).read().decode().split()
            for name in names:
                jpg = f.extractfile(
                    "VOCdevkit/VOC2012/JPEGImages/%s.jpg" % name).read()
                png = f.extractfile(
                    "VOCdevkit/VOC2012/SegmentationClass/%s.png"
                    % name).read()
                img = load_image_bytes(jpg)
                # P-mode palette PNG: the raw indices ARE the class ids
                # (convert("L") would turn them into luminance garbage)
                import io as _io

                from PIL import Image

                mask = np.asarray(Image.open(_io.BytesIO(png)))
                yield to_chw(img).astype("float32") / 255.0, \
                    mask.astype("uint8")

    return reader


def train():
    return _tar_reader("train") if _archive() else \
        _synthetic_reader(512, seed=90)


def val():
    return _tar_reader("val") if _archive() else \
        _synthetic_reader(64, seed=91)


def test():
    return _tar_reader("val") if _archive() else \
        _synthetic_reader(64, seed=92)
