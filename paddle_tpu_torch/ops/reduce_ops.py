"""Reduce ops with Fluid ``dim`` / ``keep_dim`` / ``reduce_all`` semantics
(counterpart of the ``_reduce`` table of ``paddle_tpu/ops/reduce_ops.py:12-49``):
reduce_sum, mean, max, min, prod, all and any. ``reduce_all`` (the attr),
or an empty ``dim``, reduces every axis. ``reduce_all`` and ``reduce_any``
(the ops) have no grad; the rest take the auto-VJP, whose autograd splits a
max's or min's grad evenly among ties, as ``jax.vjp`` does."""
from __future__ import annotations

import torch

from ..core.registry import In, Out, register_op

_ATTRS = {"dim": [0], "keep_dim": False, "reduce_all": False,
          "in_dtype": -1, "out_dtype": -1}


def _axes(x, attrs):
    if attrs.get("reduce_all", False):
        return tuple(range(x.dim()))
    dims = attrs.get("dim", [0])
    if not isinstance(dims, (list, tuple)):
        dims = [dims]
    if not dims:
        return tuple(range(x.dim()))
    return tuple(sorted(d % x.dim() for d in dims))


def _prod(x, dim, keepdim):
    # torch.prod takes one dim at a time; from the last, so that the
    # remaining dims keep their positions
    for d in reversed(dim):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _reduce(name, f, grad="auto"):
    @register_op(
        name,
        inputs=[In("X")],
        outputs=[Out("Out")],
        attrs=dict(_ATTRS),
        grad=grad,
    )
    def _op(ins, attrs, _f=f):
        x = ins["X"]
        dim = _axes(x, attrs)
        keep = bool(attrs.get("keep_dim", False))
        if not dim:  # a 0-d input
            return {"Out": _f(x.reshape(1), (0,), keep).reshape(())}
        return {"Out": _f(x, dim, keep)}

    return _op


_reduce("reduce_sum", lambda x, d, k: torch.sum(x, dim=d, keepdim=k))
_reduce("reduce_mean", lambda x, d, k: torch.mean(x, dim=d, keepdim=k))
_reduce("reduce_max", lambda x, d, k: torch.amax(x, dim=d, keepdim=k))
_reduce("reduce_min", lambda x, d, k: torch.amin(x, dim=d, keepdim=k))
_reduce("reduce_prod", _prod)
_reduce("reduce_all", lambda x, d, k: torch.all(x, dim=d, keepdim=k),
        grad=None)
_reduce("reduce_any", lambda x, d, k: torch.any(x, dim=d, keepdim=k),
        grad=None)
