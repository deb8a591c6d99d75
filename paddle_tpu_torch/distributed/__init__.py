"""Distributed runtime of the port: the collective launcher (``launch``:
``python -m paddle_tpu_torch.distributed.launch --nproc_per_node=N
script.py``) and the fault injector the serving fleet's transport calls
(``fault``). The JAX package's parameter server and its RPC layer are not
ported.
"""
from . import fault  # noqa: F401

__all__ = ["fault", "launch"]
