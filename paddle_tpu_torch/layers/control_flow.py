"""The control-flow layers of ``paddle_tpu/layers/control_flow.py``: the
compare layers (``_cmp_layer`` and ``less_than`` … ``not_equal``,
:31-62), the logical layers (:65-89), the tensor arrays
(``create_array``, ``array_write``, ``array_read``, ``array_length``,
:93-130), ``While`` (:133), ``cond`` (:165) and ``IfElse`` (:193), each
emitting the same ops, slots and attrs. ``While`` builds its body in a
sub-block run by the ``while`` host op (``ops/control_flow_ops.py``);
``cond`` builds both branches and merges them with ``where``, as the JAX
package does; ``IfElse`` partitions rows by a ``[N, 1]`` bool mask
(``split_lod_tensor`` / ``merge_lod_tensor``). ``DynamicRNN`` (:305) runs
a block once a step over ragged sequences, longest first, through the
rank-table host ops (``ops/rank_table_ops.py``) and a ``while``; its
``static_input`` is the reordered input shrunk to the sequences still
active, as the reference's is (the JAX package's is not shrunk).
"""
from __future__ import annotations

import contextlib

from .. import framework
from ..layer_helper import LayerHelper

__all__ = ["While", "less_than", "less_equal", "greater_than",
           "greater_equal", "equal", "not_equal", "array_write", "array_read",
           "array_length", "create_array", "logical_and", "logical_or",
           "logical_xor", "logical_not", "cond", "IfElse", "DynamicRNN"]


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


class DynamicRNN:
    """A recurrence over LoD sequences of different lengths: the block
    runs once a step, on the rows of the sequences still active at that
    step, longest sequence first (``lod_rank_table``). ``step_input``
    splits a LoD input into a time-major array (``lod_tensor_to_array``)
    and reads step t of it; ``memory`` keeps a state that shrinks with the
    active set (``shrink_rnn_memory``), booted from ``init`` in rank order
    (``reorder_lod_tensor_by_rank``) or filled with ``value``;
    ``static_input`` gives every step the input's whole sequences, in rank
    order, those of the active sequences only; ``output`` collects a
    var each step, and calling the object returns it as one LoD tensor
    in the input's sequence order (``array_to_lod_tensor``). The parent
    block gets the rank table, the counter, the condition and one
    ``while`` op::

        drnn = fluid.layers.DynamicRNN()
        with drnn.block():
            word = drnn.step_input(sentence)
            prev = drnn.memory(shape=[H])
            hidden = fluid.layers.fc([word, prev], H, act="tanh")
            drnn.update_memory(prev, hidden)
            drnn.output(hidden)
        out = drnn()
    """

    BEFORE_RNN = 0
    IN_RNN = 1
    AFTER_RNN = 2

    def __init__(self, name=None):
        self.helper = LayerHelper("dynamic_rnn", name=name)
        self.status = DynamicRNN.BEFORE_RNN
        self._main = self.helper.main_program
        self._parent_block = None
        self._rnn_block = None
        self._rank_table = None
        self._max_len = None
        self._step_idx = None
        self._cond = None
        self._mem_updates = []   # (boot name, new var)
        self._outputs = []       # (array var, step var)

    @contextlib.contextmanager
    def block(self):
        self._parent_block = self._main.current_block()
        self._rnn_block = self._main._create_block()
        self.status = DynamicRNN.IN_RNN
        try:
            yield
        finally:
            self._close_block()

    def _parent_op(self, type, inputs, outputs, attrs=None):
        return self._parent_block.append_op(type, inputs, outputs,
                                            dict(attrs or {}),
                                            infer_shape=False)

    def _parent_var(self, hint, **kw):
        return self._parent_block.create_var(
            name=framework.unique_name.generate(hint), **kw)

    def _ensure_loop_state(self, x):
        """The first ``step_input`` puts the rank table, the counter and
        the condition in the parent block."""
        if self._rank_table is not None:
            return
        self._rank_table = self._parent_var("drnn_rank_table")
        self._parent_op("lod_rank_table", {"X": [x]},
                        {"Out": [self._rank_table]}, {"level": 0})
        self._max_len = self._parent_var("drnn_max_len", dtype="int64",
                                         shape=(1,))
        self._parent_op("max_sequence_len",
                        {"RankTable": [self._rank_table]},
                        {"Out": [self._max_len]})
        self._step_idx = self._parent_var("drnn_i", dtype="int64",
                                          shape=(1,))
        self._parent_op("fill_constant", {}, {"Out": [self._step_idx]},
                        {"shape": [1], "value": 0.0, "dtype": 3})
        self._cond = self._parent_var("drnn_cond", dtype="bool", shape=(1,))
        self._parent_op("less_than",
                        {"X": [self._step_idx], "Y": [self._max_len]},
                        {"Out": [self._cond]})

    def _shrink(self, boot, dtype, shape):
        mem = self.helper.create_variable_for_type_inference(dtype)
        self.helper.append_op(
            "shrink_rnn_memory",
            inputs={"X": [boot], "RankTable": [self._rank_table],
                    "I": [self._step_idx]},
            outputs={"Out": [mem]}, infer_shape=False)
        mem.shape = (-1,) + tuple(shape)
        mem.dtype = dtype
        return mem

    def step_input(self, x, level=0):
        if self.status != DynamicRNN.IN_RNN:
            raise ValueError("step_input must be called inside block()")
        self._ensure_loop_state(x)
        arr = self._parent_var("drnn_in_arr", type="lod_tensor_array",
                               dtype=x.dtype)
        self._parent_op("lod_tensor_to_array",
                        {"X": [x], "RankTable": [self._rank_table]},
                        {"Out": [arr]})
        step = self.helper.create_variable_for_type_inference(x.dtype)
        self.helper.append_op("read_from_array",
                              inputs={"X": [arr], "I": [self._step_idx]},
                              outputs={"Out": [step]}, infer_shape=False)
        step.shape = (-1,) + tuple(x.shape[1:]) if x.shape else None
        step.dtype = x.dtype
        return step

    def static_input(self, x):
        """X's sequences in rank order, those still active at this step
        (the reference's ``shrink_memory`` of the reordered input)."""
        if self._rank_table is None:
            raise ValueError("call step_input before static_input "
                             "(the rank table comes from it)")
        reordered = self._parent_var("drnn_static", dtype=x.dtype,
                                     shape=x.shape)
        self._parent_op("reorder_lod_tensor_by_rank",
                        {"X": [x], "RankTable": [self._rank_table]},
                        {"Out": [reordered]})
        return self._shrink(reordered, x.dtype, tuple(x.shape[1:]))

    def memory(self, init=None, shape=None, value=0.0, dtype="float32"):
        if self.status != DynamicRNN.IN_RNN:
            raise ValueError("memory must be called inside block()")
        if self._rank_table is None:
            raise ValueError("call step_input before memory")
        if init is not None:
            boot = self._parent_var("drnn_boot", dtype=init.dtype,
                                    shape=init.shape)
            self._parent_op("reorder_lod_tensor_by_rank",
                            {"X": [init], "RankTable": [self._rank_table]},
                            {"Out": [boot]})
            dtype = init.dtype
        else:
            from ..core import dtypes as _dt

            boot = self._parent_var("drnn_boot", dtype=dtype,
                                    shape=(-1,) + tuple(shape or ()))
            self._parent_op("rank_table_boot_memory",
                            {"RankTable": [self._rank_table]},
                            {"Out": [boot]},
                            {"shape": list(shape or []),
                             "value": float(value),
                             "dtype": _dt.dtype_to_enum(dtype)})
        mem = self._shrink(boot, dtype, tuple(shape or boot.shape[1:] or ()))
        mem._drnn_boot = boot.name
        return mem

    def update_memory(self, ex_mem, new_mem):
        boot = getattr(ex_mem, "_drnn_boot", None)
        if boot is None:
            raise ValueError("update_memory takes the var memory() "
                             "returned")
        self._mem_updates.append((boot, new_mem))

    def output(self, *outputs):
        if self.status != DynamicRNN.IN_RNN:
            raise ValueError("output must be called inside block()")
        for o in outputs:
            arr = self._parent_var("drnn_out_arr", type="lod_tensor_array",
                                   dtype=o.dtype)
            self._parent_op("create_lod_tensor_array", {}, {"Out": [arr]})
            self._outputs.append((arr, o))

    def _close_block(self):
        blk = self._main.current_block()
        for arr, o in self._outputs:
            blk.append_op("write_to_array",
                          inputs={"X": [o], "I": [self._step_idx]},
                          outputs={"Out": [arr]}, infer_shape=False)
        for boot_name, new_mem in self._mem_updates:
            blk.append_op("assign", inputs={"X": [new_mem]},
                          outputs={"Out": [boot_name]}, infer_shape=False)
        blk.append_op("increment", inputs={"X": [self._step_idx]},
                      outputs={"Out": [self._step_idx]},
                      attrs={"step": 1.0}, infer_shape=False)
        blk.append_op("less_than",
                      inputs={"X": [self._step_idx], "Y": [self._max_len]},
                      outputs={"Out": [self._cond]}, infer_shape=False)
        self._main._rollback()
        self._parent_block.append_op(
            "while", inputs={"Condition": [self._cond]}, outputs={},
            attrs={"sub_block": self._rnn_block, "is_test": False},
            infer_shape=False)
        self.status = DynamicRNN.AFTER_RNN

    def __call__(self):
        if self.status != DynamicRNN.AFTER_RNN:
            raise ValueError("call the DynamicRNN after its block ends")
        if not self._outputs:
            raise ValueError("DynamicRNN has no output()")
        results = []
        for arr, o in self._outputs:
            out = self._parent_block.create_var(
                name=framework.unique_name.generate("drnn_out"),
                dtype=o.dtype, lod_level=1,
                shape=(-1,) + tuple(o.shape[1:] if o.shape else ()))
            self._parent_block.append_op(
                "array_to_lod_tensor",
                inputs={"X": [arr], "RankTable": [self._rank_table]},
                outputs={"Out": [out]}, infer_shape=False)
            results.append(out)
        return results[0] if len(results) == 1 else results
