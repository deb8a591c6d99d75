"""``save_dygraph`` / ``load_dygraph``.

Counterpart of ``paddle_tpu/dygraph/checkpoint.py``, in its format: a
state dict is one ``.npz`` of numpy arrays by key, named
``<path>.pdparams.npz`` when every value is a VarBase and
``<path>.pdopt.npz`` otherwise, so a file either package writes loads in
the other. Writes are atomic (tmp + fsync + rename): a crash mid-save
leaves the previous file, never a torn one.
"""
from __future__ import annotations

import io
import os

import numpy as np

from ..checkpoint import atomic_write_bytes
from .varbase import VarBase

__all__ = ["save_dygraph", "load_dygraph"]


def save_dygraph(state_dict, model_path):
    suffix = ".pdparams"
    if any(not isinstance(v, VarBase) for v in state_dict.values()):
        suffix = ".pdopt"
    arrays = {k: v.numpy() if isinstance(v, VarBase) else np.asarray(v)
              for k, v in state_dict.items()}
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    atomic_write_bytes(model_path + suffix + ".npz", buf.getvalue())


def load_dygraph(model_path):
    """(params, optimizer state): dicts of numpy arrays, None where the
    file is absent."""
    out = []
    for suffix in (".pdparams.npz", ".pdopt.npz"):
        p = model_path + suffix
        if not os.path.exists(p):
            out.append(None)
            continue
        with np.load(p) as data:
            out.append({k: data[k] for k in data.files})
    return tuple(out)
