"""Program rewriting for mixed precision.

Counterpart of ``paddle_tpu/contrib/mixed_precision/fp16_utils.py``
(``insert_cast_op`` :26, ``rewrite_program`` :48), with the same cast
names and rules, so that both packages emit the same program: white-list
op inputs are cast to the low type, black-list and unknown ops' inputs
back to float32, and a gray-list op runs low when ANY of its float inputs
already is. Parameters stay float32 master copies, cast down at their
first low-precision use, so every parameter's grad is float32 and the
optimizer updates the masters. On the card each cast is a kernel of its
own.
"""
from __future__ import annotations

from ... import framework
from ...core import dtypes as _dt

_FLOATS = ("float32", "bfloat16", "float16")


def _is_float(dtype_name: str) -> bool:
    return dtype_name in _FLOATS


def _cast_name(name: str, dest: str) -> str:
    return name + ".cast_" + dest


def insert_cast_op(block, new_ops, var, dest, cast_cache):
    """Emit (once per var) a cast of `var` to `dest`; return new name."""
    key = (var.name, dest)
    hit = cast_cache.get(key)
    if hit is not None:
        return hit
    out_name = _cast_name(var.name, dest)
    out = block.create_var(
        name=out_name, shape=var.shape, dtype=dest,
        stop_gradient=var.stop_gradient)
    op = framework.Operator(
        block, "cast",
        inputs={"X": [var.name]},
        outputs={"Out": [out_name]},
        attrs={"in_dtype": _dt.dtype_to_enum(var.dtype),
               "out_dtype": _dt.dtype_to_enum(dest)})
    op._id = block.program._next_op_id()
    new_ops.append(op)
    cast_cache[key] = out_name
    return out_name


def rewrite_program(main_prog, amp_lists, dest_dtype: str = "bfloat16"):
    """Walk the forward block, casting white-list op inputs to
    ``dest_dtype`` and black-list op inputs back to float32; gray ops
    follow their producers. Output var dtypes are updated in place."""
    block = main_prog.global_block()
    ops = list(block.ops)
    new_ops = []
    cast_cache = {}
    for op in ops:
        t = op.type
        if t in ("feed", "fetch", "cast"):
            new_ops.append(op)
            continue
        if t in amp_lists.black_list:
            target = "float32"
        elif t in amp_lists.white_list:
            target = dest_dtype
        elif t in amp_lists.gray_list:
            # low precision if ANY float input already is: the low chain
            # stays unbroken, and parameters riding along (an fc bias) are
            # cast down at their use
            any_low = False
            for name in op.input_arg_names:
                v = block._find_var_recursive(name)
                if v is not None and v.dtype == dest_dtype:
                    any_low = True
                    break
            target = dest_dtype if any_low else "float32"
        else:
            # an op on no list is forced to float32, as a black-list op
            target = "float32"

        for slot, names in op.inputs.items():
            for i, name in enumerate(names):
                v = block._find_var_recursive(name)
                if v is None or not _is_float(v.dtype):
                    continue
                if v.dtype != target:
                    names[i] = insert_cast_op(block, new_ops, v, target,
                                              cast_cache)
        for name in op.output_arg_names:
            v = block._find_var_recursive(name)
            if v is not None and _is_float(v.dtype):
                v.dtype = _dt.convert_dtype(target)
        new_ops.append(op)
    block.ops = new_ops
    return main_prog
