"""Distributed runtime of the port: for now only the fault injector that
the serving fleet's transport calls (``fault``). The JAX package's
parameter server, its RPC layer and the collective fleet are not ported.
"""
from . import fault  # noqa: F401

__all__ = ["fault"]
