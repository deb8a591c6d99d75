"""LeNet-5 (counterpart of ``paddle_tpu/models/lenet.py``): two conv +
max-pool stages and three ``fc`` layers over NCHW [N, 1, 28, 28] images."""
from __future__ import annotations

from .. import layers


def lenet(img, class_dim=10):
    """Softmax predictions [N, class_dim]."""
    c1 = layers.conv2d(img, num_filters=6, filter_size=5, act="relu")
    p1 = layers.pool2d(c1, pool_size=2, pool_type="max", pool_stride=2)
    c2 = layers.conv2d(p1, num_filters=16, filter_size=5, act="relu")
    p2 = layers.pool2d(c2, pool_size=2, pool_type="max", pool_stride=2)
    f1 = layers.fc(p2, size=120, act="relu")
    f2 = layers.fc(f1, size=84, act="relu")
    return layers.fc(f2, size=class_dim, act="softmax")
