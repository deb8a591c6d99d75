"""Core runtime of the port: dtypes, places, tensors, scopes, the op
registry and the op-by-op interpreter."""
from .executor_core import CoreExecutor  # noqa: F401
from .place import (CPUPlace, CUDAPinnedPlace, CUDAPlace,  # noqa: F401
                    Place, TPUPlace)
from .scope import Scope, global_scope, scope_guard  # noqa: F401
from .tensor import LoDTensor, LoDTensorArray, SelectedRows  # noqa: F401
