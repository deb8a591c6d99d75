"""``layers`` — the graph-building API of the ported slices."""
from .control_flow import *  # noqa: F401,F403
from .control_flow import __all__ as _cf_all
from .extras import *  # noqa: F401,F403
from .extras import __all__ as _extras_all
from .io import data, fluid_data  # noqa: F401
from .learning_rate_scheduler import *  # noqa: F401,F403
from .learning_rate_scheduler import __all__ as _lrs_all
from .loss import *  # noqa: F401,F403
from .loss import __all__ as _loss_all
from .math_op_patch import monkey_patch_variable
from .metric_op import *  # noqa: F401,F403
from .metric_op import __all__ as _metric_all
from .nn import *  # noqa: F401,F403
from .nn import __all__ as _nn_all
from .ops import *  # noqa: F401,F403
from .ops import __all__ as _ops_all
from .rnn import *  # noqa: F401,F403
from .rnn import __all__ as _rnn_all
from .sequence_lod import *  # noqa: F401,F403
from .sequence_lod import __all__ as _seq_all
from .tensor import *  # noqa: F401,F403
from .tensor import __all__ as _tensor_all

monkey_patch_variable()

__all__ = (["data", "fluid_data"] + _loss_all + _extras_all + _nn_all + _ops_all
           + _seq_all + _tensor_all + _cf_all + _lrs_all + _rnn_all)
