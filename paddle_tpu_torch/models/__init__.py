"""Models of the port, built from its layers."""
from . import gpt  # noqa: F401
from .resnet import resnet, resnet50, resnet_cifar  # noqa: F401
from . import transformer  # noqa: F401
