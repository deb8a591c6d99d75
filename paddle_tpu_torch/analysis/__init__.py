"""Static analysis of the Program IR.

Counterpart of ``paddle_tpu/analysis/__init__.py``: the well-formedness
verifier (``verifier``), the collective-schedule check (``collective``)
and the rewrite contracts (``contracts``).

Armed by ``PADDLE_TPU_VERIFY_IR`` (off by default; ``tests/conftest.py``
sets it for the test suite). ``verify_enabled()`` is one dict probe and a
branch, so every hook costs that while disarmed. The hooks, at the JAX
package's sites:

- ``checked_rewrite`` around the data-parallel passes
  (``insert_allreduce_ops``, the bucket, sharded-update and bucket-quant
  passes) and both fusion passes (``core/fusion.py``);
- ``io.load_inference_model`` verifies the program it loads;
- the data-parallel and hybrid engine verify the program and its
  collective schedule before its first step (``analysis.verify_runs
  {where=parallel.engine}``);
- the pipeline checks its stage split (``check_pipeline_split``);
- the lazy dygraph queue checks each flush graph (``verify_lazy_graph``).
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import Optional, Sequence

from .verifier import (Finding, IRVerificationError,  # noqa: F401
                       verify_lazy_graph, verify_program)
from .collective import (CollectiveMismatchError,  # noqa: F401
                         CollectiveSig, check_collective_schedule,
                         check_cross_rank, extract_collective_schedule,
                         schedule_record)
from .contracts import (ContractViolation, RewriteContract,  # noqa: F401
                        check_pipeline_split, checked_rewrite,
                        register_contract)

__all__ = [
    "verify_enabled", "maybe_verify_program", "verify_program",
    "verify_lazy_graph", "Finding", "IRVerificationError",
    "CollectiveMismatchError", "CollectiveSig",
    "check_collective_schedule", "check_cross_rank",
    "extract_collective_schedule", "schedule_record",
    "ContractViolation", "RewriteContract", "checked_rewrite",
    "register_contract", "check_pipeline_split", "suspended",
]

_TRUTHY = ("1", "true", "yes", "on")

# Probe os.environ's backing dict directly: os.environ.get goes through
# the _Environ mapping (encodekey and a method dispatch); the dict probe
# stays correct under monkeypatch.setenv / putenv (both write through
# __setitem__ into _data). Falls back to the mapping elsewhere.
try:
    _ENV_DATA = os.environ._data
    _ENV_KEY = os.environ.encodekey("PADDLE_TPU_VERIFY_IR")
except Exception:  # non-CPython / exotic platform
    _ENV_DATA = None
    _ENV_KEY = None


# set on a thread while it runs programs that are cuts of a verified one
# (the step profiler's prefixes and collective-free runs), which break
# the rewrite contracts by design
_local = threading.local()


@contextlib.contextmanager
def suspended():
    """No verification on this thread inside the block."""
    prev = getattr(_local, "off", False)
    _local.off = True
    try:
        yield
    finally:
        _local.off = prev


def verify_enabled() -> bool:
    """One dict probe and a membership test: the whole disarmed cost of
    every verify hook."""
    if _ENV_DATA is not None:
        raw = _ENV_DATA.get(_ENV_KEY)
    else:
        raw = os.environ.get("PADDLE_TPU_VERIFY_IR")
    if raw is None:
        return False
    if isinstance(raw, bytes):
        raw = raw.decode("utf-8", "ignore")
    return raw.strip().lower() in _TRUTHY and not getattr(_local, "off",
                                                          False)


def maybe_verify_program(program, where: str,
                         fetch_names: Optional[Sequence[str]] = None,
                         nranks: Optional[int] = None,
                         scope=None, recheck_shapes: bool = False):
    """The hook rewrite passes / engines / loaders call: no-op unless
    ``PADDLE_TPU_VERIFY_IR`` is set, else full well-formedness
    verification (raising ``IRVerificationError`` on error-severity
    findings) plus the single-program collective-schedule check.
    Returns the finding list (errors raise before returning)."""
    # the enabled check first: disarmed, one probe and a branch
    if not verify_enabled() or program is None:
        return None
    findings = verify_program(program, fetch_names=fetch_names,
                              pass_name=where,
                              recheck_shapes=recheck_shapes)
    check_collective_schedule(program, nranks=nranks, where=where,
                              scope=scope)
    from .. import observability as _obs

    _obs.inc("analysis.verify_runs", where=where)
    for f in findings:
        _obs.inc("analysis.findings", severity=f.severity)
    return findings
