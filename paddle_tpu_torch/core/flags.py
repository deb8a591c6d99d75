"""Runtime flags: ``FLAGS_*``, ``get_flags`` / ``set_flags``.

Counterpart of ``paddle_tpu/core/flags.py``, with its own copy of the
table: each flag is initialised from the environment variable of the same
name (or its alias) at import, and ``fluid.set_flags`` changes it later.
``FLAGS_use_pallas_conv`` routes NHWC convs to the hand-written
implicit-GEMM kernel (K5, ``ops/cuda/conv.py``). ``FLAGS_check_nan_inf``
sends a run to the op-by-op interpreter, which checks every op's floating
outputs (``core/executor_core.py``). ``FLAGS_cudnn_deterministic``
sets ``torch.backends.cudnn.deterministic`` for the convs that stay on
cuDNN. The others are accepted so that scripts written for the JAX package
run unchanged, and do nothing here, as most already did there.
"""
from __future__ import annotations

import os
from typing import Dict, List, Union

# name -> (default, doc). "(no-op)" = accepted, does nothing in the port.
_DEFS = {
    "FLAGS_check_nan_inf": (False, "scan op outputs for nan/inf: the run "
                            "takes the interpreter, which raises "
                            "EnforceNotMet at the first op whose float "
                            "output holds one"),
    "FLAGS_benchmark": (False, "sync + time every op (no-op)"),
    "FLAGS_eager_delete_tensor_gb": (-1.0, "eager var deletion (no-op: the "
                                     "executor frees every intermediate "
                                     "after its last reader)"),
    "FLAGS_fraction_of_gpu_memory_to_use": (0.92, "allocator fraction "
                                            "(no-op)"),
    "FLAGS_allocator_strategy": ("auto_growth", "allocator choice "
                                 "(no-op)"),
    "FLAGS_cudnn_deterministic": (False, "deterministic cuDNN convs: sets "
                                  "torch.backends.cudnn.deterministic"),
    "FLAGS_paddle_num_threads": (1, "CPU math threads (no-op)"),
    "FLAGS_use_mkldnn": (False, "MKLDNN kernels (no-op)"),
    "FLAGS_selected_gpus": ("", "visible devices (no-op: use "
                            "CUDA_VISIBLE_DEVICES)"),
    "FLAGS_enable_parallel_graph": (False, "executor choice (no-op)"),
    "FLAGS_max_inplace_grad_add": (0, "grad-add inplace (no-op)"),
    "FLAGS_use_pallas_conv": ("off", "route NHWC convs to the hand-written "
                              "implicit-GEMM kernel (K5): off | auto (only "
                              "the expansion 1x1 class) | all (every "
                              "viable shape)"),
    "FLAGS_dygraph_lazy": (False, "dygraph.guard() default: queue eager "
                           "ops and flush once a step (dygraph/lazy.py)"),
    "FLAGS_tpu_metrics": (False, "arm the runtime observability layer "
                          "(paddle_tpu_torch/observability: the guarded "
                          "metrics helpers and the span buffer). Env "
                          "alias: PADDLE_TPU_METRICS"),
}

# secondary env names honored at init (the primary is FLAGS_<name>)
_ENV_ALIASES = {
    "FLAGS_tpu_metrics": "PADDLE_TPU_METRICS",
}

_values: Dict[str, object] = {}


def _coerce(default, raw: str):
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


def _apply(key: str) -> None:
    """Hand a flag that steers torch to torch, and the metrics flag to the
    observability layer."""
    if key == "FLAGS_cudnn_deterministic":
        import torch

        torch.backends.cudnn.deterministic = bool(_values[key])
    elif key == "FLAGS_tpu_metrics":
        from .. import observability

        (observability.enable if _values[key] else observability.disable)()


def _init_from_env():
    for name, (default, _doc) in _DEFS.items():
        raw = os.environ.get(name)
        if raw is None and name in _ENV_ALIASES:
            raw = os.environ.get(_ENV_ALIASES[name])
        _values[name] = _coerce(default, raw) if raw is not None else default
        if raw is not None:
            _apply(name)


_init_from_env()


def _norm(name: str) -> str:
    return name if name.startswith("FLAGS_") else "FLAGS_" + name


def get_flags(flags: Union[str, List[str]]):
    """fluid.get_flags: {name: value} for one name or a list."""
    names = [flags] if isinstance(flags, str) else list(flags)
    out = {}
    for n in names:
        key = _norm(n)
        if key not in _values:
            raise ValueError("unknown flag %r" % n)
        out[key] = _values[key]
    return out


# bumped whenever set_flags changes a value: a flag may route an op (the
# conv route), so the whole-program route keys its step functions on it
_version = [0]


def version() -> int:
    return _version[0]


def set_flags(flags: Dict[str, object]):
    """fluid.set_flags."""
    for n, v in flags.items():
        key = _norm(n)
        if key not in _values:
            raise ValueError("unknown flag %r" % n)
        default = _DEFS[key][0]
        old = _values[key]
        _values[key] = _coerce(default, v) if isinstance(v, str) else \
            type(default)(v) if not isinstance(default, str) else str(v)
        if _values[key] != old:
            _version[0] += 1
        _apply(key)


def flag(name: str):
    """Internal fast read."""
    return _values[_norm(name)]
