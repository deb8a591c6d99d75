"""Models of the port, built from its layers."""
from . import gpt  # noqa: F401
from .lenet import lenet  # noqa: F401
from .mlp import mlp  # noqa: F401
from .resnet import resnet, resnet50, resnet_cifar  # noqa: F401
from . import transformer  # noqa: F401
from .transformer import (bert_base_pretrain, transformer_encoder,  # noqa: F401
                          transformer_wmt)
# ``models.wide_deep`` is the model function, as in the JAX package; the
# module is ``paddle_tpu_torch.models.wide_deep`` in ``sys.modules``
from .wide_deep import build_wide_deep, random_batch, wide_deep  # noqa: F401
from . import book  # noqa: F401
from . import rnn_search  # noqa: F401
