"""Op functions of the port. Importing this package registers every op
(``core.registry`` imports it at the first registry lookup)."""
from . import activation_ops  # noqa: F401
from . import amp_ops  # noqa: F401
from . import beam_search_ops  # noqa: F401
from . import collective_ops  # noqa: F401
from . import compare_ops  # noqa: F401
from . import control_flow_ops  # noqa: F401
from . import conv_ops  # noqa: F401
from . import crf_ops  # noqa: F401
from . import elementwise_ops  # noqa: F401
from . import eval_ops  # noqa: F401
from . import fused_ops  # noqa: F401
from . import hybrid_parallel_ops  # noqa: F401
from . import io_ops  # noqa: F401
from . import loss_ops  # noqa: F401
from . import math_ops  # noqa: F401
from . import matmul_ops  # noqa: F401
from . import metrics_ops  # noqa: F401
from . import misc_ops  # noqa: F401
from . import nn_tail_ops  # noqa: F401
from . import norm_ops  # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import rank_table_ops  # noqa: F401
from . import reduce_ops  # noqa: F401
from . import rnn_ops  # noqa: F401
from . import sequence_ops  # noqa: F401
from . import tensor_ops  # noqa: F401
