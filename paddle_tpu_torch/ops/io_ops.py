"""The program-level save and load ops: ``save``, ``load``,
``save_combine``, ``load_combine`` (counterparts of
``paddle_tpu/ops/tail_ops.py:298-381``), host ops with the same slots,
attrs and files: ``save`` writes one var as ``<file_path>.npy``,
``save_combine`` several as ``<file_path>.npz`` keyed by name. They exist
so that a program built with in-graph save ops runs; ``io.py`` is the save
and load surface. A loaded value lands on the executor's device; a
bfloat16 value goes to disk as ``core/tensor.to_host_array`` writes it.
"""
from __future__ import annotations

import os

import numpy as np

from ..core.registry import In, Out, register_host_op
from ..core.tensor import from_host_array, to_host_array


def _suffixed(path: str, suffix: str) -> str:
    return path if path.endswith(suffix) else path + suffix


def _guard_overwrite(op, path: str) -> None:
    if os.path.exists(path) and not op.attrs.get("overwrite", True):
        raise RuntimeError("%s: %r exists and overwrite=False"
                           % (op.type, path))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)


def _host(executor, scope, name, fp16: bool) -> np.ndarray:
    val = to_host_array(executor._read_var(scope, name))
    return val.astype(np.float16) if fp16 else val


def _put(executor, scope, name, val, fp16: bool) -> None:
    if fp16:
        val = np.asarray(val).astype(np.float16)
    executor._write_var(scope, name, from_host_array(val, executor.device))


@register_host_op(
    "save",
    inputs=[In("X", no_grad=True)],
    outputs=[],
    attrs={"file_path": "", "overwrite": True, "save_as_fp16": False},
)
def _save(executor, op, scope):
    """save_op.cc: one variable to ``file_path`` (as ``.npy``)."""
    path = _suffixed(op.attrs["file_path"], ".npy")
    _guard_overwrite(op, path)
    np.save(path, _host(executor, scope, op.input("X")[0],
                        op.attrs.get("save_as_fp16", False)))


@register_host_op(
    "load",
    inputs=[],
    outputs=[Out("Out")],
    attrs={"file_path": "", "load_as_fp16": False},
)
def _load(executor, op, scope):
    path = _suffixed(op.attrs["file_path"], ".npy")
    _put(executor, scope, op.output("Out")[0], np.load(path),
         op.attrs.get("load_as_fp16", False))


@register_host_op(
    "save_combine",
    inputs=[In("X", duplicable=True, no_grad=True)],
    outputs=[],
    attrs={"file_path": "", "overwrite": True, "save_as_fp16": False},
)
def _save_combine(executor, op, scope):
    path = _suffixed(op.attrs["file_path"], ".npz")
    _guard_overwrite(op, path)
    fp16 = op.attrs.get("save_as_fp16", False)
    np.savez(path, **{n: _host(executor, scope, n, fp16)
                      for n in op.input("X")})


@register_host_op(
    "load_combine",
    inputs=[],
    outputs=[Out("Out", duplicable=True)],
    attrs={"file_path": "", "load_as_fp16": False},
)
def _load_combine(executor, op, scope):
    names = op.output("Out")
    with np.load(_suffixed(op.attrs["file_path"], ".npz")) as data:
        keys = list(data.keys())
        # all by name or all by position: mixing the two could assign an
        # array to the wrong var where only some names match
        if all(n in data for n in names):
            picks = names
        elif len(names) == len(keys):
            picks = keys  # by position (the reference reads in order)
        else:
            raise RuntimeError(
                "load_combine: outputs %r do not match saved keys %r"
                % (list(names), keys))
        for out_name, key in zip(names, picks):
            _put(executor, scope, out_name, data[key],
                 op.attrs.get("load_as_fp16", False))
