"""The control-flow layers of ``paddle_tpu/layers/control_flow.py``: the
compare layers (``_cmp_layer`` and ``less_than`` … ``not_equal``,
:31-62), the logical layers (:65-89), the tensor arrays
(``create_array``, ``array_write``, ``array_read``, ``array_length``,
:93-130), ``While`` (:133), ``cond`` (:165) and ``IfElse`` (:193), each
emitting the same ops, slots and attrs. ``While`` builds its body in a
sub-block run by the ``while`` host op (``ops/control_flow_ops.py``);
``cond`` builds both branches and merges them with ``where``, as the JAX
package does; ``IfElse`` partitions rows by a ``[N, 1]`` bool mask
(``split_lod_tensor`` / ``merge_lod_tensor``). ``DynamicRNN`` waits for
the LoD slice (ROADMAP.md).
"""
from __future__ import annotations

import contextlib

from .. import framework
from ..layer_helper import LayerHelper

__all__ = ["While", "less_than", "less_equal", "greater_than",
           "greater_equal", "equal", "not_equal", "array_write", "array_read",
           "array_length", "create_array", "logical_and", "logical_or",
           "logical_xor", "logical_not", "cond", "IfElse"]


def _cmp_layer(op_type, x, y, cond=None):
    helper = LayerHelper(op_type, input=x)
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool",
                                                         stop_gradient=True)
    helper.append_op(op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [cond]})
    return cond


def less_than(x, y, force_cpu=None, cond=None):
    return _cmp_layer("less_than", x, y, cond)


def less_equal(x, y, cond=None):
    return _cmp_layer("less_equal", x, y, cond)


def greater_than(x, y, cond=None):
    return _cmp_layer("greater_than", x, y, cond)


def greater_equal(x, y, cond=None):
    return _cmp_layer("greater_equal", x, y, cond)


def equal(x, y, cond=None):
    return _cmp_layer("equal", x, y, cond)


def not_equal(x, y, cond=None):
    return _cmp_layer("not_equal", x, y, cond)


def _logical_layer(op_type, x, y=None, out=None):
    helper = LayerHelper(op_type, input=x)
    if out is None:
        out = helper.create_variable_for_type_inference("bool",
                                                        stop_gradient=True)
    inputs = {"X": [x]}
    if y is not None:
        inputs["Y"] = [y]
    helper.append_op(op_type, inputs=inputs, outputs={"Out": [out]})
    return out


def logical_and(x, y, out=None, name=None):
    return _logical_layer("logical_and", x, y, out)


def logical_or(x, y, out=None, name=None):
    return _logical_layer("logical_or", x, y, out)


def logical_xor(x, y, out=None, name=None):
    return _logical_layer("logical_xor", x, y, out)


def logical_not(x, out=None, name=None):
    return _logical_layer("logical_not", x, None, out)


def create_array(dtype):
    """An array var, made empty at run time in the scope of the block
    that creates it, so a while body's writes grow one array."""
    helper = LayerHelper("create_array")
    v = helper.block.create_var(
        name=framework.unique_name.generate("array"),
        type="lod_tensor_array", dtype=dtype)
    helper.append_op("create_lod_tensor_array", inputs={},
                     outputs={"Out": [v]}, infer_shape=False)
    return v


def array_write(x, i, array=None):
    helper = LayerHelper("array_write", input=x)
    if array is None:
        array = create_array(x.dtype)
    helper.append_op("write_to_array", inputs={"X": [x], "I": [i]},
                     outputs={"Out": [array]})
    return array


def array_read(array, i):
    helper = LayerHelper("array_read", input=array)
    out = helper.create_variable_for_type_inference(array.dtype)
    helper.append_op("read_from_array", inputs={"X": [array], "I": [i]},
                     outputs={"Out": [out]})
    return out


def array_length(array):
    helper = LayerHelper("array_length", input=array)
    out = helper.create_variable_for_type_inference("int64",
                                                    stop_gradient=True)
    helper.append_op("lod_array_length", inputs={"X": [array]},
                     outputs={"Out": [out]})
    return out


class While:
    """``with While(cond).block():`` builds the body in a sub-block; on
    exit the parent gets one ``while`` op over it. The body writes the
    parent's vars by name, the condition among them."""

    def __init__(self, cond, is_test=False, name=None):
        self.cond_var = cond
        self.is_test = is_test
        self.helper = LayerHelper("while", name=name)

    @contextlib.contextmanager
    def block(self):
        main = self.helper.main_program
        parent_block = main.current_block()
        sub = main._create_block()
        try:
            yield
        finally:
            main._rollback()
            parent_block.append_op(
                "while", inputs={"Condition": [self.cond_var]}, outputs={},
                attrs={"sub_block": sub, "is_test": self.is_test})


def cond(pred, true_fn=None, false_fn=None, name=None):
    """Both branches are built and run; ``where`` picks by ``pred``."""
    true_out = true_fn() if true_fn is not None else None
    false_out = false_fn() if false_fn is not None else None
    if true_out is None and false_out is None:
        return None
    helper = LayerHelper("cond", name=name)

    def merge(t, f):
        out = helper.create_variable_for_type_inference(t.dtype)
        helper.append_op("where", inputs={"Condition": [pred], "X": [t],
                                          "Y": [f]},
                         outputs={"Out": [out]})
        return out

    if isinstance(true_out, (list, tuple)):
        return [merge(t, f) for t, f in zip(true_out, false_out)]
    return merge(true_out, false_out)


class IfElse:
    """Branching by rows: ``input(x)`` splits x's rows by the ``[N, 1]``
    bool cond, each branch computes on its rows, ``output()`` collects,
    and calling the object merges the rows back in order. When only one
    branch gave outputs, that branch's (unmerged) vars are returned. Both
    branches' ops run, each on its (possibly empty) rows."""

    OUT_IF_ELSE_BLOCKS = 0
    IN_IF_ELSE_TRUE_BLOCKS = 1
    IN_IF_ELSE_FALSE_BLOCKS = 2

    def __init__(self, cond, name=None):
        self.helper = LayerHelper("ifelse", name=name)
        self.cond = cond
        self.input_table = {}
        self.status = IfElse.OUT_IF_ELSE_BLOCKS
        self.output_table = ([], [])  # (false outputs, true outputs)

    @contextlib.contextmanager
    def _branch(self, status):
        self.status = status
        try:
            yield
        finally:
            self.status = IfElse.OUT_IF_ELSE_BLOCKS

    def true_block(self):
        return self._branch(IfElse.IN_IF_ELSE_TRUE_BLOCKS)

    def false_block(self):
        return self._branch(IfElse.IN_IF_ELSE_FALSE_BLOCKS)

    def input(self, x):
        if self.status == IfElse.OUT_IF_ELSE_BLOCKS:
            raise ValueError("input() must be called inside "
                             "true_block()/false_block()")
        block = self.helper.main_program.current_block()
        if id(x) not in self.input_table:
            out_true = block.create_var(
                name=framework.unique_name.generate("ifelse_in_t"),
                dtype=x.dtype)
            out_false = block.create_var(
                name=framework.unique_name.generate("ifelse_in_f"),
                dtype=x.dtype)
            # the row counts are the data's: the full [N, ...] stands in
            out_true.shape = tuple(x.shape) if x.shape else None
            out_false.shape = tuple(x.shape) if x.shape else None
            block.append_op(
                "split_lod_tensor", inputs={"X": [x], "Mask": [self.cond]},
                outputs={"OutTrue": [out_true], "OutFalse": [out_false]},
                attrs={"level": 0}, infer_shape=False)
            self.input_table[id(x)] = (out_true, out_false)
        out_true, out_false = self.input_table[id(x)]
        return (out_true if self.status == IfElse.IN_IF_ELSE_TRUE_BLOCKS
                else out_false)

    def output(self, *outs):
        if self.status == IfElse.OUT_IF_ELSE_BLOCKS:
            raise ValueError("output() must be called inside a block")
        self.output_table[
            1 if self.status == IfElse.IN_IF_ELSE_TRUE_BLOCKS else 0
        ].extend(outs)

    def __call__(self):
        if self.status != IfElse.OUT_IF_ELSE_BLOCKS:
            raise ValueError("call IfElse() outside the blocks")
        false_outs, true_outs = self.output_table
        if not false_outs and not true_outs:
            raise ValueError("invoke true_block/false_block first")
        if not false_outs or not true_outs:
            return list(true_outs or false_outs)
        if len(false_outs) != len(true_outs):
            raise ValueError("both branches must output the same number "
                             "of variables")
        block = self.helper.main_program.current_block()
        merged = []
        for t, f in zip(true_outs, false_outs):
            out = block.create_var(
                name=framework.unique_name.generate("ifelse_out"),
                dtype=t.dtype)
            out.shape = tuple(t.shape) if t.shape else None
            block.append_op(
                "merge_lod_tensor",
                inputs={"InTrue": [t], "InFalse": [f], "Mask": [self.cond]},
                outputs={"Out": [out]}, attrs={"level": 0},
                infer_shape=False)
            merged.append(out)
        return merged
