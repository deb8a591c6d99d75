"""Comparison ops ``equal``, ``not_equal``, ``less_than``, ``less_equal``,
``greater_than`` and ``greater_equal`` and the logical ops
``logical_and``, ``logical_or``, ``logical_xor`` and ``logical_not``
(counterparts of ``paddle_tpu/ops/compare_ops.py:13-50``): the same slots
and attrs, a bool ``Out``, never differentiated. ``Variable`` and ``VarBase`` comparisons
(``layers/math_op_patch.py``, ``dygraph/math_patch.py``) append them."""
from __future__ import annotations

import torch

from ..core.registry import In, Out, register_op


def _cmp(name, f):
    @register_op(
        name,
        inputs=[In("X", no_grad=True), In("Y", no_grad=True)],
        outputs=[Out("Out")],
        attrs={"axis": -1, "force_cpu": False},
        grad=None,
    )
    def _op(ins, attrs, _f=f):
        return {"Out": _f(ins["X"], ins["Y"])}

    return _op


_cmp("equal", torch.eq)
_cmp("not_equal", torch.ne)
_cmp("less_than", torch.lt)
_cmp("less_equal", torch.le)
_cmp("greater_than", torch.gt)
_cmp("greater_equal", torch.ge)


def _logical(name, f, binary=True):
    ins_spec = [In("X", no_grad=True)] + (
        [In("Y", no_grad=True)] if binary else [])

    @register_op(name, inputs=ins_spec, outputs=[Out("Out")], grad=None)
    def _op(ins, attrs, _f=f, _binary=binary):
        if _binary:
            return {"Out": _f(ins["X"], ins["Y"])}
        return {"Out": _f(ins["X"])}

    return _op


_logical("logical_and", torch.logical_and)
_logical("logical_or", torch.logical_or)
_logical("logical_xor", torch.logical_xor)
_logical("logical_not", torch.logical_not, binary=False)
