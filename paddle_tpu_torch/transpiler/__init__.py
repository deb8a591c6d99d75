"""Transpilers (the port of ``paddle_tpu/transpiler/``): the
parameter-server rewrite (``DistributeTranspiler``), geo-SGD, federated
learning, the pserver dispatchers and the deprecated memory shims."""
from ..parallel.transpiler import (  # noqa: F401
    insert_allreduce_ops,
    insert_local_sgd_ops,
)
from .distribute_transpiler import (  # noqa: F401
    DistributeTranspiler,
    DistributeTranspilerConfig,
    slice_variable,
)


class HashName:
    """Hash pserver dispatcher (the reference's ``ps_dispatcher.py``)."""

    def __init__(self, pserver_endpoints):
        self._eps = list(pserver_endpoints)

    def dispatch(self, varlist):
        return [self._eps[hash(v.name) % len(self._eps)] for v in varlist]


class RoundRobin:
    """Round-robin pserver dispatcher (the reference's
    ``ps_dispatcher.py``)."""

    def __init__(self, pserver_endpoints):
        self._eps = list(pserver_endpoints)
        self._i = 0

    def dispatch(self, varlist):
        out = []
        for v in varlist:
            out.append(self._eps[self._i % len(self._eps)])
            self._i += 1
        return out

    def reset(self):
        self._i = 0


from .geo_sgd_transpiler import GeoSgdTranspiler  # noqa: F401,E402
from .fl_transpiler import FlDistributeTranspiler  # noqa: F401,E402


def memory_optimize(input_program, skip_opt_set=None, print_log=False,
                    level=0, skip_grads=True):
    """Deprecated no-op, as in the JAX package: the caching allocator and
    the executor's eager-deletion plan handle memory reuse."""
    import logging

    logging.warning(
        "paddle_tpu_torch.transpiler.memory_optimize is a deprecated "
        "no-op: the allocator and eager deletion handle memory reuse")


def release_memory(input_program, skip_opt_set=None):
    """Deprecated no-op, as in the JAX package."""
