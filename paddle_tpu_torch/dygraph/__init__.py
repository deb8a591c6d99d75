"""Imperative (dygraph) mode.

Counterpart of ``paddle_tpu/dygraph/``: ``guard``, ``to_variable``,
``Layer`` and the ``nn`` layers, the tracer and its tape autograd
(``backward``, ``grad``), the lazy queue (one flush a step; on the card a
CUDA graph a step), learning-rate decays, ``save_dygraph`` /
``load_dygraph``, ``TracedLayer`` (``jit``) and dygraph-to-static
(``ast_transform``, ``dygraph_to_static``: ``ProgramTranslator``,
``declarative``, ``to_static``). ``DataParallel`` waits for the
collectives (ROADMAP.md).
"""
from .base import (  # noqa: F401
    disable_dygraph,
    enable_dygraph,
    enabled,
    guard,
    no_grad,
    to_variable,
)
from .layers import Layer  # noqa: F401
from .varbase import ParamBase, VarBase  # noqa: F401
from .tracer import Tracer, grad  # noqa: F401
from . import nn  # noqa: F401
from .nn import *  # noqa: F401,F403
from .checkpoint import load_dygraph, save_dygraph  # noqa: F401
from . import math_patch  # noqa: F401
from .learning_rate_scheduler import (  # noqa: F401
    CosineDecay,
    ExponentialDecay,
    InverseTimeDecay,
    NaturalExpDecay,
    NoamDecay,
    PiecewiseDecay,
    PolynomialDecay,
)
from .jit import TracedLayer  # noqa: F401
from . import dygraph_to_static  # noqa: F401
from .dygraph_to_static import (  # noqa: F401
    ProgramTranslator,
    declarative,
    to_static,
)
