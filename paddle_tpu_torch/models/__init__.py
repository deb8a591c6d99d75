"""Models of the port, built from its layers."""
from . import gpt  # noqa: F401
from .lenet import lenet  # noqa: F401
from .mlp import mlp  # noqa: F401
from .resnet import resnet, resnet50, resnet_cifar  # noqa: F401
from . import transformer  # noqa: F401
from .transformer import (bert_base_pretrain, transformer_encoder,  # noqa: F401
                          transformer_wmt)
