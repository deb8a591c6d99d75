"""The MNIST multilayer perceptron (counterpart of
``paddle_tpu/models/mlp.py``): ``fc`` layers and a softmax classifier."""
from __future__ import annotations

from .. import layers


def mlp(x, hidden_sizes=(512, 512), class_dim=10, act="relu"):
    for h in hidden_sizes:
        x = layers.fc(x, size=h, act=act)
    return layers.fc(x, size=class_dim, act="softmax")
