"""Mixed-precision training (counterpart of
``paddle_tpu/contrib/mixed_precision``): ``decorate`` wraps an optimizer
so that ``minimize`` rewrites the forward program to bfloat16 (or
float16) where the op lists allow, keeps float32 master parameters, and
optionally scales the loss."""
from . import fp16_lists  # noqa: F401
from . import fp16_utils  # noqa: F401
from .decorator import OptimizerWithMixedPrecision, decorate  # noqa: F401
from .fp16_lists import AutoMixedPrecisionLists  # noqa: F401
from .fp16_utils import rewrite_program  # noqa: F401
