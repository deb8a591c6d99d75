"""Typed errors and the enforce helpers.

Counterpart of ``paddle_tpu/core/enforce.py``, whole: ``EnforceNotMet``
(the reference's ``PADDLE_ENFORCE`` error, ``platform/enforce.h``) and its
typed subclasses (``errors.h``), ``enforce`` / ``enforce_not_none``, the
``enforce_eq`` family, and ``annotate_op_error``, which the interpreter
and the whole-program route call on every failure inside an op so that
the error names the op, its phase and its inputs and outputs.
"""
from __future__ import annotations

__all__ = [
    "EnforceNotMet",
    "InvalidArgumentError",
    "NotFoundError",
    "OutOfRangeError",
    "AlreadyExistsError",
    "PermissionDeniedError",
    "UnimplementedError",
    "PreconditionNotMetError",
    "ExecutionTimeoutError",
    "enforce",
    "enforce_not_none",
]


class EnforceNotMet(RuntimeError):
    """Base framework error (the reference's EnforceNotMet)."""


class InvalidArgumentError(EnforceNotMet, ValueError):
    pass


class NotFoundError(EnforceNotMet, KeyError):
    def __str__(self):  # KeyError quotes its arg; keep it readable
        return RuntimeError.__str__(self)


class OutOfRangeError(EnforceNotMet, IndexError):
    pass


class AlreadyExistsError(EnforceNotMet):
    pass


class PermissionDeniedError(EnforceNotMet):
    pass


class UnimplementedError(EnforceNotMet, NotImplementedError):
    pass


class PreconditionNotMetError(EnforceNotMet):
    pass


class ExecutionTimeoutError(EnforceNotMet, TimeoutError):
    pass


def enforce(cond, message, error_cls=EnforceNotMet):
    if not cond:
        raise error_cls(message)


def enforce_not_none(value, message, error_cls=NotFoundError):
    if value is None:
        raise error_cls(message)
    return value


def _cmp_enforce(name, ok):
    def check(a, b, message="", error_cls=InvalidArgumentError):
        if not ok(a, b):
            raise error_cls(
                "%sExpected %r %s %r." % (message + " " if message
                                          else "", a, name, b))
    return check


# the PADDLE_ENFORCE_EQ family: a failure shows both sides
enforce_eq = _cmp_enforce("==", lambda a, b: a == b)
enforce_ne = _cmp_enforce("!=", lambda a, b: a != b)
enforce_gt = _cmp_enforce(">", lambda a, b: a > b)
enforce_ge = _cmp_enforce(">=", lambda a, b: a >= b)
enforce_lt = _cmp_enforce("<", lambda a, b: a < b)
enforce_le = _cmp_enforce("<=", lambda a, b: a <= b)


def annotate_op_error(exc: BaseException, op, phase: str) -> None:
    """Append the operator's context to an exception in flight, keeping
    its type and traceback, as the reference wraps every kernel failure
    with the op's signature. Changing ``args`` keeps ``pytest.raises`` and
    callers' ``except`` clauses working on the original type."""
    ctx = "\n  [operator %r error during %s; inputs: %s; outputs: %s]" % (
        getattr(op, "type", "?"), phase,
        {k: v for k, v in getattr(op, "inputs", {}).items()},
        {k: v for k, v in getattr(op, "outputs", {}).items()})
    if exc.args and isinstance(exc.args[0], str):
        if ctx in exc.args[0]:
            return  # nested run_op frames annotate once
        exc.args = (exc.args[0] + ctx,) + exc.args[1:]
    else:
        exc.args = exc.args + (ctx,)
