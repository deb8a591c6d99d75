"""Variable + Scope.

Counterpart of ``paddle_tpu/core/scope.py``: a type-erased variable holder
and the scope, with the same ``global_scope`` / ``scope_guard`` pair. A
scope may have a parent (``new_scope``): ``find_var`` looks through the
parents, ``var`` and ``find_local_var`` only here. The control-flow ops
run a sub-block in a child scope and drop it (``drop_kids``) afterwards.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

from .tensor import LoDTensor, LoDTensorArray, SelectedRows


class Variable:
    """Type-erased holder; ``get_tensor`` default-constructs a LoDTensor."""

    __slots__ = ("_holder",)

    def __init__(self):
        self._holder = None

    def is_initialized(self) -> bool:
        return self._holder is not None

    def get_tensor(self) -> LoDTensor:
        if self._holder is None:
            self._holder = LoDTensor()
        if not isinstance(self._holder, LoDTensor):
            raise TypeError("variable holds %s, not LoDTensor"
                            % type(self._holder))
        return self._holder

    def get_selected_rows(self) -> SelectedRows:
        if self._holder is None:
            self._holder = SelectedRows()
        if not isinstance(self._holder, SelectedRows):
            raise TypeError("variable holds %s, not SelectedRows"
                            % type(self._holder))
        return self._holder

    def get_lod_tensor_array(self) -> LoDTensorArray:
        if self._holder is None:
            self._holder = LoDTensorArray()
        if not isinstance(self._holder, LoDTensorArray):
            raise TypeError("variable holds %s, not LoDTensorArray"
                            % type(self._holder))
        return self._holder

    def set(self, holder):
        self._holder = holder

    def raw(self):
        return self._holder


class Scope:
    def __init__(self, parent: Optional["Scope"] = None):
        self._vars: Dict[str, Variable] = {}
        self._parent = parent
        self._kids: List["Scope"] = []

    def var(self, name: str) -> Variable:
        """Find in this scope only, create if absent."""
        v = self._vars.get(name)
        if v is None:
            v = Variable()
            self._vars[name] = v
        return v

    def find_var(self, name: str) -> Optional[Variable]:
        """Here, else in the parents."""
        v = self._vars.get(name)
        if v is None and self._parent is not None:
            return self._parent.find_var(name)
        return v

    def find_local_var(self, name: str) -> Optional[Variable]:
        return self._vars.get(name)

    def erase(self, name: str) -> None:
        self._vars.pop(name, None)

    def local_var_names(self) -> List[str]:
        return list(self._vars)

    def new_scope(self) -> "Scope":
        kid = Scope(self)
        self._kids.append(kid)
        return kid

    def drop_kids(self) -> None:
        self._kids = []

    def drop_kid(self, kid: "Scope") -> None:
        self._kids.remove(kid)

    def parent(self) -> Optional["Scope"]:
        return self._parent


_global_scope = Scope()
_guard_stack: List[Scope] = []


def global_scope() -> Scope:
    """The scope ``Executor.run`` defaults to; ``scope_guard`` swaps it."""
    return _guard_stack[-1] if _guard_stack else _global_scope


@contextlib.contextmanager
def scope_guard(scope: Scope):
    _guard_stack.append(scope)
    try:
        yield
    finally:
        _guard_stack.pop()
