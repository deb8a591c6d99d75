"""paddle_tpu_torch — the PyTorch + CUDA port of paddle_tpu.

The same Fluid-style surface as ``paddle_tpu`` (``import paddle_tpu_torch
as fluid``): Program / Block / Op / Variable IR, layers, ``append_backward``
and optimizers, Executor, inference predictor and serving engine, with op
functions in ``torch`` and
the Pallas TPU kernels rewritten by hand in CUDA C++ for Hopper
(``csrc/``). Entry points run on the card (``cuda:0``) unless the caller
asks for the CPU (``CPUPlace()``, ``AnalysisConfig.disable_gpu()``).

This package imports neither ``jax`` nor anything of ``paddle_tpu``.
ROADMAP.md lists what is ported and what is still to come.
"""
from . import framework  # noqa: F401
from .core import (CPUPlace, CUDAPlace, LoDTensor, Scope,  # noqa: F401
                   TPUPlace, global_scope, scope_guard)
from .core.flags import get_flags, set_flags  # noqa: F401
from .executor import Executor  # noqa: F401
from .framework import (Parameter, Program, Variable,  # noqa: F401
                        default_main_program, default_startup_program,
                        program_guard)
from . import initializer  # noqa: F401
from .param_attr import ParamAttr  # noqa: F401
from . import layers  # noqa: F401
from . import optimizer  # noqa: F401
from . import backward  # noqa: F401
from .layers.io import fluid_data as data  # noqa: F401
from . import models  # noqa: F401
from . import contrib  # noqa: F401
from . import io  # noqa: F401
from . import inference  # noqa: F401
from . import serving  # noqa: F401
from .utils import unique_name  # noqa: F401
