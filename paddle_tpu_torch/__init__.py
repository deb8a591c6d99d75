"""paddle_tpu_torch — the PyTorch + CUDA port of paddle_tpu.

The same Fluid-style surface as ``paddle_tpu`` (``import paddle_tpu_torch
as fluid``): Program / Block / Op / Variable IR, layers, ``append_backward``
and optimizers, Executor, inference predictor and serving engine, the
imperative mode (``dygraph``: ``fluid.dygraph.guard()``), with op
functions in ``torch`` and
the Pallas TPU kernels rewritten by hand in CUDA C++ for Hopper
(``csrc/``). Entry points run on the card (``cuda:0``) unless the caller
asks for the CPU (``CPUPlace()``, ``AnalysisConfig.disable_gpu()``).

This package imports neither ``jax`` nor anything of ``paddle_tpu``.
ROADMAP.md lists what is ported and what is still to come.
"""
from . import framework  # noqa: F401
from .core import (CPUPlace, CUDAPinnedPlace, CUDAPlace,  # noqa: F401
                   LoDTensor, LoDTensorArray, Scope, TPUPlace,
                   global_scope, scope_guard)
from .core import enforce  # noqa: F401
from .core.flags import get_flags, set_flags  # noqa: F401
from .executor import Executor  # noqa: F401
from .compiler import (BuildStrategy, CompiledProgram,  # noqa: F401
                       ExecutionStrategy)
from .framework import (Parameter, Program, Variable,  # noqa: F401
                        default_main_program, default_startup_program,
                        in_dygraph_mode, program_guard)
from . import initializer  # noqa: F401
from .param_attr import ParamAttr, WeightNormParamAttr  # noqa: F401
from . import layers  # noqa: F401
from . import optimizer  # noqa: F401
from . import regularizer  # noqa: F401
from . import clip  # noqa: F401
from . import backward  # noqa: F401
from .backward import gradients  # noqa: F401
from .layers.io import fluid_data as data  # noqa: F401
from . import models  # noqa: F401
from . import contrib  # noqa: F401
from . import io  # noqa: F401
from .io import load, save  # noqa: F401
from . import checkpoint  # noqa: F401
from . import dataset  # noqa: F401
from . import inference  # noqa: F401
from . import serving  # noqa: F401
from . import dygraph  # noqa: F401
from . import nets  # noqa: F401
from . import profiler  # noqa: F401
from . import lod_tensor  # noqa: F401
from .lod_tensor import (create_lod_tensor,  # noqa: F401
                         create_random_int_lodtensor)
from .data_feeder import DataFeeder  # noqa: F401
from .utils import unique_name  # noqa: F401
from . import parallel  # noqa: F401
from . import incubate  # noqa: F401
from . import ir  # noqa: F401
from .ir import IrGraph  # noqa: F401
from .async_executor import AsyncExecutor, DataFeedDesc  # noqa: F401
from . import trainer_factory  # noqa: F401
from . import communicator  # noqa: F401
from .communicator import Communicator  # noqa: F401
from . import dataset_module  # noqa: F401
from .dataset_module import DatasetFactory  # noqa: F401
from . import transpiler  # noqa: F401
from .transpiler import (DistributeTranspiler,  # noqa: F401
                         DistributeTranspilerConfig)


def set_global_seed(seed: int):
    """Seed the default main and startup programs (their RNG ops draw from
    ``random_seed``), as ``paddle_tpu.set_global_seed`` does."""
    default_main_program().random_seed = seed
    default_startup_program().random_seed = seed
