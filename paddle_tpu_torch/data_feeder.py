"""``DataFeeder`` and the ``check_*`` helpers of
``paddle_tpu/data_feeder.py``: python samples to a feed dict. A
``lod_level`` feed concatenates its samples' rows into one LoDTensor whose
offsets are the samples' lengths (:48-70); any other feed stacks them
into an array of the var's declared shape."""
from __future__ import annotations

from typing import List

import numpy as np

from . import framework
from .core import dtypes as _dt
from .core.tensor import LoDTensor

__all__ = ["DataFeeder", "convert_dtype", "check_variable_and_dtype",
           "check_type", "check_dtype"]

convert_dtype = _dt.convert_dtype


def check_variable_and_dtype(input, input_name, expected_dtype, op_name):
    if not isinstance(input, framework.Variable):
        raise TypeError("The input %s of %s must be Variable, got %s"
                        % (input_name, op_name, type(input)))
    if _dt.convert_dtype(input.dtype) not in expected_dtype:
        raise TypeError("The dtype of %s of %s must be one of %s, got %s"
                        % (input_name, op_name, expected_dtype, input.dtype))


def check_type(input, input_name, expected_type, op_name):
    if not isinstance(input, expected_type):
        raise TypeError("The type of %s of %s must be %s, got %s"
                        % (input_name, op_name, expected_type, type(input)))


def check_dtype(dtype, input_name, expected_dtype, op_name):
    if _dt.convert_dtype(dtype) not in expected_dtype:
        raise TypeError("dtype of %s of %s must be one of %s, got %s"
                        % (input_name, op_name, expected_dtype, dtype))


class DataFeeder:
    def __init__(self, feed_list, place=None, program=None):
        self.feed_names: List[str] = []
        self.feed_dtypes = []
        self.feed_shapes = []
        self.feed_lod_level = []
        program = program or framework.default_main_program()
        for v in feed_list:
            if isinstance(v, str):
                v = program.global_block().var(v)
            self.feed_names.append(v.name)
            self.feed_dtypes.append(np.dtype(_dt.convert_dtype(v.dtype)))
            self.feed_shapes.append(v.shape)
            self.feed_lod_level.append(v.lod_level)
        self.place = place

    def feed(self, iterable):
        rows = list(iterable)
        feed = {}
        for i, name in enumerate(self.feed_names):
            col = [row[i] for row in rows]
            dtype = self.feed_dtypes[i]
            if self.feed_lod_level[i]:
                seqs = [np.asarray(c, dtype=dtype) for c in col]
                flat = np.concatenate(
                    [s.reshape(len(s) if s.ndim == 1 else -1, *s.shape[1:])
                     for s in seqs], axis=0)
                lengths = [s.shape[0] for s in seqs]
                feed[name] = LoDTensor().set(flat).set_lod(
                    [np.concatenate([[0], np.cumsum(lengths)]).tolist()])
                continue
            arr = np.asarray(col, dtype=dtype)
            shape = self.feed_shapes[i]
            if shape is not None and not (
                    len(shape) == arr.ndim + 1 or (
                        arr.ndim == len(shape) and all(
                            s == -1 or s == d
                            for s, d in zip(shape[1:], arr.shape[1:])))):
                arr = arr.reshape([len(rows)] + list(shape[1:])) \
                    if -1 in shape else arr.reshape(shape)
            feed[name] = arr
        return feed
