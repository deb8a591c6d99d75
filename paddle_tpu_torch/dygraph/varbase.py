"""VarBase / ParamBase: eager tensors.

Counterpart of ``paddle_tpu/dygraph/varbase.py``. A VarBase wraps a
``torch`` tensor, always detached: the autograd graph of the op that made
it lives in that op's tape record (``tracer.TapeRecord``), never in the
tensor, so dropping the tape frees it. A value may be a ``PendingValue``
under lazy dygraph (``lazy.py``): shape and dtype read without a flush,
any value read flushes the queue.

A tensor made from host data lands on the active tracer's device (the
guard's place), or on the CPU outside a guard, always as a copy; float64
data becomes float32, as the JAX package's arrays do.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtypes as _dt
from ..utils import unique_name

__all__ = ["VarBase", "ParamBase"]


def _device():
    from .tracer import current_tracer

    t = current_tracer()
    return t.device if t is not None else torch.device("cpu")


def to_tensor(value, dtype=None, device=None) -> torch.Tensor:
    """Host data (numpy, lists, numbers) or a tensor as a tensor on
    ``device`` (the active tracer's by default)."""
    device = device if device is not None else _device()
    if isinstance(value, torch.Tensor):
        t = value.detach()
    else:
        arr = np.asarray(value)
        if dtype is not None:
            arr = arr.astype(_dt.convert_dtype(dtype))
        elif arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        t = torch.from_numpy(np.array(arr, copy=True, order="C"))
        if torch.device(device).type == "cuda":
            # from page-locked memory without a wait: a copy from pageable
            # memory would wait for the card's queue, and a lazy step's
            # inputs could then not be staged while the last step runs
            return t.pin_memory().to(device, non_blocking=True)
        return t
    if dtype is not None:
        t = t.to(_dt.to_torch_dtype(dtype))
    elif t.dtype == torch.float64:
        t = t.float()
    return t.to(device)


def _is_pending(v) -> bool:
    return type(v).__name__ == "PendingValue"


class VarBase:
    def __init__(self, value=None, name=None, stop_gradient=True,
                 persistable=False, zero_copy=False, dtype=None):
        self._arr_raw = None
        self._grad_raw = None
        if value is not None:
            self._array = to_tensor(value, dtype)
        self.name = name or unique_name.generate("generated_var")
        self.stop_gradient = stop_gradient
        self.persistable = persistable

    # -- lazy-aware storage ------------------------------------------------
    # ``_array`` / ``_grad`` may hold a PendingValue under lazy dygraph:
    # the setters register this VarBase as an owner (so a flush knows the
    # value must materialize) and the getters swap a resolved pending for
    # its tensor. A pending that replaces a tensor remembers it
    # (``PendingValue.replaces``): a captured flush may then write the new
    # value into that tensor's input buffer (a parameter's update).
    @property
    def _array(self):
        a = self._arr_raw
        if a is not None and _is_pending(a) and a._resolved:
            a = a.value
            self._arr_raw = a
        return a

    @_array.setter
    def _array(self, v):
        old = self._arr_raw
        self._arr_raw = v
        if v is not None and _is_pending(v) and not v._resolved:
            v.add_owner(self, "_arr_raw")
            if isinstance(old, torch.Tensor) and v.replaces is None:
                v.replaces = old

    @property
    def _grad(self):
        g = self._grad_raw
        if g is not None and _is_pending(g) and g._resolved:
            g = g.value
            self._grad_raw = g
        return g

    @_grad.setter
    def _grad(self, v):
        self._grad_raw = v
        if v is not None and _is_pending(v) and not v._resolved:
            v.add_owner(self, "_grad_raw")

    # -- data -------------------------------------------------------------
    @property
    def array(self) -> torch.Tensor:
        return self._force()

    def _force(self):
        """The tensor (flushes the lazy queue if pending)."""
        a = self._array
        if a is not None and _is_pending(a):
            a = a.force()
            self._arr_raw = a
        return a

    def numpy(self) -> np.ndarray:
        return _to_numpy(self._force())

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    @property
    def shape(self):
        return tuple(self._array.shape) if self._array is not None else None

    @property
    def dtype(self):
        return _dt.convert_dtype(self._array.dtype)

    @property
    def ndim(self):
        return len(self._array.shape)

    def detach(self):
        v = VarBase(None, name=self.name + ".detached", stop_gradient=True)
        v._array = _unshared(self._array)
        return v

    def clone(self):
        v = VarBase(None, stop_gradient=self.stop_gradient)
        v._array = _unshared(self._array)
        return v

    def astype(self, dtype):
        from .tracer import current_tracer

        return current_tracer().trace_op(
            "cast", {"X": [self]}, {},
            {"in_dtype": _dt.dtype_to_enum(self.dtype),
             "out_dtype": _dt.dtype_to_enum(dtype)})["Out"][0]

    # -- autograd ---------------------------------------------------------
    def backward(self, backward_strategy=None, retain_graph=False):
        from .tracer import current_tracer

        current_tracer().engine.backward(self, retain_graph=retain_graph)

    def gradient(self):
        g = self._grad
        if g is None:
            return None
        if _is_pending(g):
            g = g.force()
            self._grad_raw = g
        return _to_numpy(g)

    @property
    def grad(self):
        return self._grad

    def clear_gradient(self):
        self._grad = None

    def set_value(self, value):
        if isinstance(value, VarBase):
            self._array = value._array
            return
        old = self._array
        self._array = to_tensor(value, device=(
            old.device if isinstance(old, torch.Tensor) else None))

    # -- python niceties --------------------------------------------------
    def __len__(self):
        return int(self._array.shape[0])

    def __float__(self):
        return float(self.numpy().reshape(()))

    def __repr__(self):
        return "VarBase(name=%s, shape=%s, dtype=%s, stop_gradient=%s)\n%s" % (
            self.name, self.shape, self.dtype, self.stop_gradient,
            self.numpy() if self._array is not None else None)

    def __getitem__(self, idx):
        from .tracer import Tracer, current_tracer

        if isinstance(idx, VarBase):
            idx = idx._force()
        tracer = current_tracer()
        if tracer is not None and tracer.lazy_engine is not None \
                and Tracer._static_index(idx):
            # queue the subscript: a flush here would defeat lazy mode
            return tracer._trace_getitem_lazy(self, idx)
        if not self.stop_gradient and tracer is not None:
            return tracer.trace_getitem(self, idx)
        return VarBase(self._force()[idx], stop_gradient=self.stop_gradient)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    host = t.cpu()
    # a copy: the caller may write into it
    return host.numpy().copy() if host is t else host.numpy()


def _unshared(a):
    """``a``, or a copy of it when it is a captured lazy graph's input
    buffer, which the next replay overwrites in place."""
    from .lazy import is_state_buffer

    if isinstance(a, torch.Tensor) and is_state_buffer(a):
        return a.clone()
    return a


class ParamBase(VarBase):
    def __init__(self, value=None, name=None, trainable=True, **kw):
        super().__init__(value, name=name, stop_gradient=not trainable,
                         persistable=True)
        self.trainable = trainable
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.is_distributed = False

    @classmethod
    def create(cls, name, shape, dtype, initializer, trainable=True):
        """Make a parameter at once by running its initializer's op through
        a throwaway one-op program on the tracer's device."""
        from .. import framework
        from ..core import CoreExecutor, Scope

        prog = framework.Program()
        block = prog.global_block()
        v = block.create_var(name="p", shape=list(shape),
                             dtype=_dt.convert_dtype(dtype), persistable=True)
        initializer(v, block)
        core = CoreExecutor(_device())
        (val,) = core.run_program(prog, Scope(), fetch_list=["p"],
                                  return_numpy=False)
        return cls(val.array, name=name, trainable=trainable)
